"""The data axis as a mesh — the counterpart of the JAX package's
parallel/mesh.py, data axis only.

A `Mesh` is one of two things:

* under a process group (parallel.distributed.initialize), the group's
  ranks: each rank is one position on DATA_AXIS and serves on its own
  device (`devices` holds that one device);
* without one, some local devices of this process: data-parallel serving
  (serving.Predictor.from_params(mesh=), export_model(mesh=)) splits a
  batch into equal shards, one per device. A mesh of N "cpu" entries runs
  the same padding and splitting on the CPU.

make_mesh keeps the JAX rule that the data width divides the batch. Over
local devices it takes the largest width that does (math.gcd, as the JAX
make_mesh); over a process group it raises instead, since a rank cannot be
left idle. Tensor, context and pipeline parallelism are not ported yet:
make_mesh refuses model_parallel, seq_parallel and pipe_parallel above 1.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from vit_rpe_rope_tpu_torch.parallel import distributed

DATA_AXIS = "data"

# The ROADMAP Queue A items that port the other axes, by name.
UNPORTED_AXES = {
    "model_parallel": "tensor parallelism",
    "seq_parallel": "the context-parallel ring",
    "pipe_parallel": "GPipe pipeline parallelism",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: where this process serves (its own device under a process
    group; the local devices of the data axis otherwise). ranks: the
    process group's ranks on DATA_AXIS, or None for a mesh of local
    devices."""
    devices: tuple
    ranks: tuple | None = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.ranks if self.ranks is not None
                               else self.devices)}

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
        return distributed.rank() if self.distributed else 0


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
    """The data-axis mesh. Under a process group (and no `devices`): its
    ranks, with this rank's device; batch_size, when given, must be a
    multiple of the world size. Otherwise the first num_devices of
    `devices` (default: every CUDA device), as many as divide batch_size
    evenly when it is given (the JAX make_mesh's rule, with its warning)."""
    for name, value in (("model_parallel", model_parallel),
                        ("seq_parallel", seq_parallel),
                        ("pipe_parallel", pipe_parallel)):
        if value > 1:
            raise NotImplementedError(
                f"make_mesh({name}={value}): not ported to the PyTorch "
                f"package yet; see ROADMAP Queue A, {UNPORTED_AXES[name]}")
    if devices is None and distributed.is_initialized():
        world = distributed.world_size()
        if num_devices is not None and num_devices != world:
            raise ValueError(f"num_devices={num_devices} differs from the "
                             f"process group's world size {world}")
        if batch_size is not None and batch_size % world:
            raise ValueError(
                f"batch_size {batch_size} is not a multiple of the world "
                f"size {world}: every rank takes an equal share of each "
                f"batch (pick a batch size divisible by {world})")
        return Mesh(devices=(distributed.device(),),
                    ranks=tuple(range(world)))
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
