"""Data, tensor, context and pipeline parallelism over torch.distributed —
the data, model, sequence and pipe axes of the JAX package's parallel/
layer (mesh.py, distributed.py, tensor_parallel.py, context_parallel.py,
pipeline_parallel.py, pp_tp.py).

The JAX package drives every local device from one process and splits the
batch over its mesh's 'data' axis, the heads and MLP rows over its 'model'
axis, the tokens over its 'seq' axis and the blocks over its stages with
shard_map. The port runs one process per device: the ranks of a
torch.distributed process group, started with torchrun's environment
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), are its mesh.
Without that environment a run is the one-device run and makes no
collective call. The compositions with the sequence axis (tp_cp.py,
pp_tp_cp.py) are not ported (make_mesh refuses them by name).
"""
