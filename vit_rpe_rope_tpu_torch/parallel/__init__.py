"""Data and tensor parallelism over torch.distributed — the data and model
axes of the JAX package's parallel/ layer (mesh.py, distributed.py,
tensor_parallel.py).

The JAX package drives every local device from one process and splits the
batch over its mesh's 'data' axis, and the heads and MLP rows over its
'model' axis, with shard_map. The port runs one process per device: the
ranks of a torch.distributed process group, started with torchrun's
environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), are
its mesh. Without that environment a run is the one-device run and makes
no collective call. Context and pipeline parallelism are not ported
(make_mesh refuses them by name).
"""
