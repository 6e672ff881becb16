"""Process-group bootstrap, data staging and the collectives of the data
axis — the counterpart of the JAX package's parallel/distributed.py.

* `initialize(backend=None, device=None)` joins the process group that
  torchrun's environment describes (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
  RANK, LOCAL_RANK; `python -m torch.distributed.run` sets them). It
  returns False in a single process, where nothing is joined, as the JAX
  `initialize` does. The backend is NCCL on CUDA and gloo on the CPU; the
  caller may ask for gloo on CUDA, which lets several ranks share one card
  (NCCL refuses two ranks on one device). The rank's device is
  cuda:LOCAL_RANK (modulo the visible cards under gloo) unless the caller
  asks for the CPU.
* `stage_per_host(local_data, device)`: every rank stages the whole uint8
  dataset on its device, as the JAX fit replicates it; each step then
  gathers its own columns of the index matrix.
* The collectives are the two that gloo offers on CUDA tensors, broadcast
  and all_reduce, so the same code runs under NCCL, under gloo on the CPU
  and under gloo on the card (gloo has no all_gather or reduce_scatter on
  CUDA tensors): `broadcast_params`, `all_reduce_sum` and
  `all_gather_slices`, a gather written as an exact all_reduce.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")
BACKENDS = ("nccl", "gloo")

_device = None  # the rank's device, set by initialize


def initialize(backend: str | None = None, device=None) -> bool:
    """Join the process group of torchrun's environment. Returns True when a
    group was joined (or already is), False in a single process (no
    WORLD_SIZE in the environment): the one-device run, no collective.

    backend: None (NCCL on CUDA, gloo on the CPU), "nccl" or "gloo".
    device: None (cuda:LOCAL_RANK) or the device to run on ("cpu" selects
    gloo)."""
    global _device
    if "WORLD_SIZE" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    missing = [name for name in ENV if name not in os.environ]
    if missing:
        raise ValueError(f"WORLD_SIZE is set but {', '.join(missing)} is "
                         f"not: launch the ranks with python -m "
                         f"torch.distributed.run")
    if backend is not None and backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    local_rank = int(os.environ["LOCAL_RANK"])
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cpu":
        if backend == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; the CPU "
                             "runs gloo")
        backend = "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' (--device cpu "
                "on the CLIs) to run the ranks on the CPU over gloo")
        backend = backend or "nccl"
        n_cards = torch.cuda.device_count()
        if device is None or device.index is None:
            if backend == "nccl" and local_rank >= n_cards:
                raise ValueError(
                    f"LOCAL_RANK {local_rank} with {n_cards} CUDA device(s): "
                    f"NCCL runs one rank per device; ranks that share a "
                    f"device need the gloo backend (--dist_backend gloo)")
            device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    _device = device
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank in the group (0 without one)."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The group's size (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def device():
    """The device initialize chose for this rank (None without a group)."""
    return _device if is_initialized() else None


def finalize() -> None:
    """Leave the group (a no-op without one)."""
    global _device
    if is_initialized():
        dist.destroy_process_group()
    _device = None


def stage_per_host(local_data, device) -> torch.Tensor:
    """The whole array on this rank's device. Every rank holds the whole
    dataset (the JAX fit replicates it over the mesh); the train and eval
    steps gather each rank's columns of the index matrix from it."""
    return torch.from_numpy(np.ascontiguousarray(local_data)).to(device)


def all_reduce_sum(tensor: torch.Tensor) -> torch.Tensor:
    """In-place sum over the group's ranks (the JAX psum); returned."""
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM)
    return tensor


def broadcast_params(params: dict, src: int = 0) -> None:
    """Overwrite every rank's float32 params with rank `src`'s, in place, in
    one broadcast of their concatenation."""
    values = [v.detach() for v in params.values()]
    flat = torch.cat([v.reshape(-1) for v in values])
    dist.broadcast(flat, src=src)
    offset = 0
    with torch.no_grad():
        for v in values:
            v.copy_(flat[offset:offset + v.numel()].view_as(v))
            offset += v.numel()


def all_gather_slices(local: torch.Tensor, rank_: int,
                      world: int) -> torch.Tensor:
    """The [world · n] vector whose r-th slice of n is rank r's `local`
    [n]: the tiled all_gather of the JAX package, written as an all_reduce
    (SUM) of a vector that holds `local` at its own slice and -0.0
    everywhere else. x + (-0.0) == x for every float32 x (+0.0 and -0.0
    included), so each element of the sum is its owner's value, bit for
    bit, in any order of summation. gloo offers only broadcast and
    all_reduce on CUDA tensors, so the one code path runs under NCCL, under
    gloo on the CPU and under gloo on the card."""
    n = local.numel()
    full = torch.full((world * n,), -0.0, dtype=local.dtype,
                      device=local.device)
    full[rank_ * n:(rank_ + 1) * n] = local
    return all_reduce_sum(full)
