"""The data, model and sequence axes as a mesh — the counterpart of the
JAX package's parallel/mesh.py for data, tensor and context parallelism.

A `Mesh` is one of two things:

* under a process group (parallel.distributed.initialize), the group's
  ranks on a grid of D data positions by T model positions (tensor
  parallelism) or by R sequence positions (context parallelism): rank r
  sits at data position r // T and model position r % T, or at data
  position r // R and sequence position r % R (the second axis varies
  fastest, as in the JAX make_mesh, whose lone context-parallel run folds
  its token shards onto that axis), and serves on its own device
  (`devices` holds that one device). With T > 1 each data row (the T
  ranks of one data position) and each model column (the D ranks of one
  model position) is a subgroup of its own (parallel.distributed.
  new_group): the tensor-parallel collectives run over the row, the
  gradient sum over the column. With R > 1 each data row is a subgroup
  whose ranks form the KV ring (`seq_ring`, a parallel.distributed.Ring);
  the gradient and ZeRO-1 sums run over the whole group;
* without one, some local devices of this process: data-parallel serving
  (serving.Predictor.from_params(mesh=), export_model(mesh=)) splits a
  batch into equal shards, one per device. A mesh of N "cpu" entries runs
  the same padding and splitting on the CPU.

make_mesh keeps the JAX rule that the data width divides the batch. Over
local devices it takes the largest width that does (math.gcd, as the JAX
make_mesh); over a process group it raises instead, since a rank cannot be
left idle. model_parallel T and seq_parallel R must divide the world size
(the JAX make_mesh's words). Their composition (a data x seq x model mesh)
and pipeline parallelism are not ported yet: make_mesh refuses both.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from vit_rpe_rope_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

# The ROADMAP Queue A items that port what make_mesh refuses, by name.
UNPORTED_AXES = {
    "pipe_parallel": "GPipe pipeline parallelism",
    "seq_parallel with model_parallel": "the compositions",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: where this process serves (its own device under a process
    group; the local devices of the data axis otherwise). ranks: the
    process group's ranks, or None for a mesh of local devices.
    model_parallel: T, the width of the model axis. data_group /
    model_group: this rank's model column and data row as subgroups (T >
    1 only; None: the whole group, and no model axis). seq_parallel: R,
    the width of the sequence axis; seq_ring: this rank's data row as the
    KV ring (R > 1 only)."""
    devices: tuple
    ranks: tuple | None = None
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None
    seq_parallel: int = 1
    seq_ring: object = None

    @property
    def shape(self) -> dict:
        n = len(self.ranks if self.ranks is not None else self.devices)
        if self.seq_parallel > 1:
            return {DATA_AXIS: n // self.seq_parallel,
                    SEQ_AXIS: self.seq_parallel}
        if self.model_parallel == 1:
            return {DATA_AXIS: n}
        return {DATA_AXIS: n // self.model_parallel,
                MODEL_AXIS: self.model_parallel}

    @property
    def size(self) -> int:
        """The width of the data axis."""
        return self.shape[DATA_AXIS]

    @property
    def distributed(self) -> bool:
        """True for a process group's mesh: steps reduce over its ranks."""
        return self.ranks is not None

    @property
    def rank(self) -> int:
        """This process's position on the data axis (0 for local devices)."""
        return self.data_rank

    @property
    def data_rank(self) -> int:
        return (distributed.rank() // (self.model_parallel
                                       * self.seq_parallel)
                if self.distributed else 0)

    @property
    def seq_rank(self) -> int:
        """This process's position on the sequence axis (its token shard)."""
        return (distributed.rank() % self.seq_parallel
                if self.distributed else 0)

    @property
    def model_rank(self) -> int:
        """This process's position on the model axis (its head shard)."""
        return (distributed.rank() % self.model_parallel
                if self.distributed else 0)

    def sum_over_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over this rank's model column (the JAX psum over
        'data'; the whole group when there is no model axis: under context
        parallelism the JAX psum over ('data', 'model'))."""
        if self.data_group is None:
            return distributed.all_reduce_sum(tensor)
        return distributed.all_reduce_sum(tensor, self.data_group)


def _model_axis_groups(world: int, t: int) -> tuple:
    """(data_group, model_group) of this rank on the D x T grid. Every rank
    creates every column, then every row, in order (new_group is
    collective)."""
    d = world // t
    me = distributed.rank()
    columns = [distributed.new_group(range(m, world, t)) for m in range(t)]
    rows = [distributed.new_group(range(i * t, (i + 1) * t))
            for i in range(d)]
    return columns[me % t], rows[me // t]


def _seq_ring(world: int, r: int):
    """This rank's data row of the D x R grid as a Ring. Every rank creates
    every row, in order (new_group is collective)."""
    me = distributed.rank()
    rows = [range(i * r, (i + 1) * r) for i in range(world // r)]
    groups = [distributed.new_group(row) for row in rows]
    return distributed.ring_of(rows[me // r], groups[me // r])


def local_devices(device_type: str = "cuda") -> list:
    """The devices of one type that this process sees: every CUDA device,
    or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(batch_size: int | None = None, num_devices: int | None = None,
              devices=None, model_parallel: int = 1, seq_parallel: int = 1,
              pipe_parallel: int = 1) -> Mesh:
    """The mesh. Under a process group (and no `devices`): its ranks on a
    D x T grid (T = model_parallel) or a D x R grid (R = seq_parallel),
    the second width dividing the world size, with this rank's device;
    batch_size, when given, must be a multiple of the data width D.
    Without a group the one process is the whole world (a T or R above 1
    does not divide it): the first num_devices of `devices` (default:
    every CUDA device), as many as divide batch_size evenly when it is
    given (the JAX make_mesh's rule, with its warning)."""
    for name, on in (("pipe_parallel", pipe_parallel > 1),
                     ("seq_parallel with model_parallel",
                      seq_parallel > 1 and model_parallel > 1)):
        if on:
            raise NotImplementedError(
                f"make_mesh({name}: pipe_parallel={pipe_parallel}, "
                f"seq_parallel={seq_parallel}, model_parallel="
                f"{model_parallel}): not ported to the PyTorch package yet; "
                f"see ROADMAP Queue A, {UNPORTED_AXES[name]}")
    group = devices is None and distributed.is_initialized()
    world = distributed.world_size() if group else 1
    second = model_parallel * seq_parallel  # one of the two is 1
    if second > 1 and world % second:
        raise ValueError(
            f"device count {world} not divisible by model_parallel="
            f"{model_parallel} × seq_parallel={seq_parallel} × "
            f"pipe_parallel={pipe_parallel}")
    if group:
        if num_devices is not None and num_devices != world:
            raise ValueError(f"num_devices={num_devices} differs from the "
                             f"process group's world size {world}")
        width = world // second
        if batch_size is not None and batch_size % width:
            raise ValueError(
                f"batch_size {batch_size} is not a multiple of the "
                f"{'world size' if second == 1 else 'data width'} "
                f"{width}: every data rank takes an equal share of each "
                f"batch (pick a batch size divisible by {width})")
        groups = (_model_axis_groups(world, model_parallel)
                  if model_parallel > 1 else (None, None))
        ring = (_seq_ring(world, seq_parallel) if seq_parallel > 1
                else None)
        return Mesh(devices=(distributed.device(),),
                    ranks=tuple(range(world)), model_parallel=model_parallel,
                    data_group=groups[0], model_group=groups[1],
                    seq_parallel=seq_parallel, seq_ring=ring)
    devices = list(devices if devices is not None else local_devices())
    if not devices:
        raise ValueError("make_mesh: no devices")
    n = min(num_devices or len(devices), len(devices))
    if batch_size is not None:
        n_use = math.gcd(n, batch_size)
        if n_use < n:
            warnings.warn(
                f"make_mesh: using {n_use} of {n} devices — batch_size="
                f"{batch_size} is not divisible by the {n}-way data axis "
                f"(shards need identical shapes). Pick a batch size "
                f"divisible by the device count to use all devices.",
                stacklevel=2)
        n = n_use
    return Mesh(devices=tuple(torch.device(d) for d in devices[:n]))
