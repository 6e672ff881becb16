"""The data and model axes as a mesh — the counterpart of the JAX
package's parallel/mesh.py for data and tensor parallelism.

A `Mesh` is one of two things:

* under a process group (parallel.distributed.initialize), the group's
  ranks on a (DATA_AXIS, MODEL_AXIS) grid of D x T: rank r sits at data
  position r // T and model position r % T (the model axis varies
  fastest, as in the JAX make_mesh), and serves on its own device
  (`devices` holds that one device). With T > 1 each data row (the T
  ranks of one data position) and each model column (the D ranks of one
  model position) is a subgroup of its own (parallel.distributed.
  new_group): the tensor-parallel collectives run over the row, the
  gradient sum over the column;
* without one, some local devices of this process: data-parallel serving
  (serving.Predictor.from_params(mesh=), export_model(mesh=)) splits a
  batch into equal shards, one per device. A mesh of N "cpu" entries runs
  the same padding and splitting on the CPU.

make_mesh keeps the JAX rule that the data width divides the batch. Over
local devices it takes the largest width that does (math.gcd, as the JAX
make_mesh); over a process group it raises instead, since a rank cannot be
left idle. model_parallel T must divide the world size (the JAX make_mesh's
words). Context and pipeline parallelism are not ported yet: make_mesh
refuses seq_parallel and pipe_parallel above 1.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from vit_rpe_rope_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The ROADMAP Queue A items that port the other axes, by name.
UNPORTED_AXES = {
    "seq_parallel": "the context-parallel ring",
    "pipe_parallel": "GPipe pipeline parallelism",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: where this process serves (its own device under a process
    group; the local devices of the data axis otherwise). ranks: the
    process group's ranks, or None for a mesh of local devices.
    model_parallel: T, the width of the model axis. data_group /
    model_group: this rank's model column and data row as subgroups (T >
    1 only; None: the whole group, and no model axis)."""
    devices: tuple
    ranks: tuple | None = None
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None

    @property
    def shape(self) -> dict:
        n = len(self.ranks if self.ranks is not None else self.devices)
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
        return (distributed.rank() // self.model_parallel
                if self.distributed else 0)

    @property
    def model_rank(self) -> int:
        """This process's position on the model axis (its head shard)."""
        return (distributed.rank() % self.model_parallel
                if self.distributed else 0)

    def sum_over_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over this rank's model column (the JAX psum over
        'data'; the whole group when there is no model axis)."""
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
    D x T grid (T = model_parallel, which must divide the world size), with
    this rank's device; batch_size, when given, must be a multiple of the
    data width D. Without a group the one process is the whole world (a T
    above 1 does not divide it): the first num_devices of `devices`
    (default: every CUDA device), as many as divide batch_size evenly when
    it is given (the JAX make_mesh's rule, with its warning)."""
    for name, value in (("seq_parallel", seq_parallel),
                        ("pipe_parallel", pipe_parallel)):
        if value > 1:
            raise NotImplementedError(
                f"make_mesh({name}={value}): not ported to the PyTorch "
                f"package yet; see ROADMAP Queue A, {UNPORTED_AXES[name]}")
    group = devices is None and distributed.is_initialized()
    world = distributed.world_size() if group else 1
    if model_parallel > 1 and world % model_parallel:
        raise ValueError(
            f"device count {world} not divisible by model_parallel="
            f"{model_parallel} × seq_parallel={seq_parallel} × "
            f"pipe_parallel={pipe_parallel}")
    if group:
        if num_devices is not None and num_devices != world:
            raise ValueError(f"num_devices={num_devices} differs from the "
                             f"process group's world size {world}")
        width = world // model_parallel
        if batch_size is not None and batch_size % width:
            raise ValueError(
                f"batch_size {batch_size} is not a multiple of the "
                f"{'world size' if model_parallel == 1 else 'data width'} "
                f"{width}: every data rank takes an equal share of each "
                f"batch (pick a batch size divisible by {width})")
        groups = (_model_axis_groups(world, model_parallel)
                  if model_parallel > 1 else (None, None))
        return Mesh(devices=(distributed.device(),),
                    ranks=tuple(range(world)), model_parallel=model_parallel,
                    data_group=groups[0], model_group=groups[1])
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
