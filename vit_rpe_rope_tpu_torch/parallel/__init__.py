"""Data parallelism over torch.distributed — the data axis of the JAX
package's parallel/ layer (mesh.py, distributed.py).

The JAX package drives every local device from one process and splits the
batch over its mesh's 'data' axis with shard_map. The port runs one process
per device: the ranks of a torch.distributed process group, started with
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK), are its data axis. Without that environment a run is the
one-device run and makes no collective call. Tensor, context and pipeline
parallelism are not ported (make_mesh refuses them by name).
"""
