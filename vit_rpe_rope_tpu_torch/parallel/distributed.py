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
  `all_gather_slices`, a gather written as an exact all_reduce
  (`gather_shards` joins a dict's shards with one). The last
  two take a subgroup (`new_group`: a data row or a model column of a
  tensor-parallel mesh); over a subgroup of one rank they make no call.
* Megatron's f and g over a subgroup, as autograd Functions
  (`identity_fwd_psum_bwd`, `psum_identity_bwd`; the JAX parallel/mesh.py
  names): the identity without one.
* The hop of a ring (`Ring`, `ring_shift`): the JAX `ppermute` by +1 over
  the ranks of a subgroup (a data row of a context-parallel mesh), as
  paired isend / irecv in one batch_isend_irecv, every request waited on
  (a blocking send before its recv deadlocks two ranks that send to each
  other). Each tensor of a hop has a tag of its own. NCCL sends device
  tensors; gloo's send and recv take host memory only, so under gloo the
  hop of CUDA tensors stages them through host tensors, explicitly (the
  copy to the host waits for the current stream, the copy back is queued
  on it). A hop that fails raises. `RingShift` is the hop as an autograd
  Function (its backward shifts the cotangents by -1), for the plain ring.
  Over a ring of one rank a hop makes no call and returns its tensors.
* The hop of a pipeline (`Chain`, `stage_hop`): the JAX non-cyclic
  `ppermute` over the stages of a subgroup (the stage chain of a pipeline-
  parallel mesh): stage s sends to s + 1 and receives from s - 1 (reverse:
  to s - 1, from s + 1, the hop's transpose, which carries the cotangents
  back). The first stage receives nothing and the last sends nothing, so
  each side says whether it sends and what it expects; a rank whose
  partner is idle makes no call for it. CUDA tensors go through host
  copies under gloo, as in ring_shift.
"""

from __future__ import annotations

import dataclasses
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


def new_group(ranks) -> object:
    """A subgroup of the process group over `ranks`. Every rank of the
    group must call it for every subgroup, in the same order (the call is
    collective), members or not."""
    return dist.new_group(ranks=list(ranks))


def all_reduce_sum(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the ranks of `group` (None: the whole process
    group; the JAX psum over an axis); returned. A subgroup of one rank
    leaves tensor as it is, with no call."""
    if group is not None and dist.get_world_size(group) == 1:
        return tensor
    dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
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


def all_gather_slices(local: torch.Tensor, rank_: int, world: int,
                      group=None) -> torch.Tensor:
    """The [world · n] vector whose r-th slice of n is the `local` [n] of
    the rank at position r of `group` (rank_: this rank's position, world:
    the group's size; None: the whole process group): the tiled all_gather
    of the JAX package, written as an all_reduce
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
    return all_reduce_sum(full, group)


def gather_shards(local: dict, dims: dict, rank_: int, world: int,
                  group=None) -> dict:
    """`local` with each tensor of `dims` ({key: dim}) joined along its dim
    over `group` (this rank at position rank_ of world; every rank holds
    an equal shard of each), exact: one all_gather_slices of their
    concatenation. With nothing to join, local as it is."""
    if world == 1 or not dims:
        return dict(local)
    keys = list(dims)
    flat = torch.cat([local[k].detach().reshape(-1) for k in keys])
    full = all_gather_slices(flat, rank_, world, group)
    pieces = full.view(world, flat.numel())
    out = dict(local)
    offset = 0
    for key in keys:
        v = local[key]
        n = v.numel()
        out[key] = torch.cat([pieces[r, offset:offset + n].view_as(v)
                              for r in range(world)], dim=dims[key])
        offset += n
    return out


class _IdentityFwdSumBwd(torch.autograd.Function):
    """f: identity forward, all-reduce of the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


class _SumFwdIdentityBwd(torch.autograd.Function):
    """g: all-reduce forward, identity backward (the summed output is used
    replicated, so its cotangent is every partial's)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def identity_fwd_psum_bwd(x, group):
    """Megatron's f over `group` (the JAX identity_fwd_psum_bwd); the
    identity without one."""
    return x if group is None else _IdentityFwdSumBwd.apply(x, group)


def psum_identity_bwd(x, group):
    """Megatron's g over `group` (the JAX psum_identity_bwd); the identity
    without one."""
    return x if group is None else _SumFwdIdentityBwd.apply(x, group)


@dataclasses.dataclass(frozen=True)
class Ring:
    """The ranks of a subgroup in ring order: `group` (its process group),
    this rank's position `rank` of `size`, and the global ranks of the
    next (`next`, where a hop sends) and previous (`prev`, where it
    receives from) positions."""
    group: object
    rank: int
    size: int
    next: int
    prev: int


def ring_of(ranks, group) -> Ring:
    """The Ring of this rank over `ranks` (global ranks in ring order,
    this rank among them), whose process group is `group`."""
    ranks = list(ranks)
    me = ranks.index(rank())
    return Ring(group=group, rank=me, size=len(ranks),
                next=ranks[(me + 1) % len(ranks)],
                prev=ranks[(me - 1) % len(ranks)])


def ring_position(ring) -> tuple:
    """(position, size) on `ring`; (0, 1) for None, the ring of one rank."""
    return (0, 1) if ring is None else (ring.rank, ring.size)


def ring_shift(ring, tensors, reverse: bool = False) -> list:
    """One hop: each rank sends `tensors` to the next rank of the ring and
    returns the previous rank's (reverse: to the previous, from the next).
    The received tensors are new, contiguous, on the senders' device and of
    their dtypes. Over None or a ring of one rank, `tensors` as they are,
    with no call."""
    tensors = list(tensors)
    if ring is None or ring.size == 1:
        return tensors
    dst, src = (ring.prev, ring.next) if reverse else (ring.next, ring.prev)
    device = tensors[0].device
    staged = (device.type != "cpu"
              and dist.get_backend(ring.group) == "gloo")
    send = [t.detach().contiguous() for t in tensors]
    if staged:  # gloo moves host memory only
        send = [t.cpu() for t in send]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for tag, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, dst, ring.group, tag))
        ops.append(dist.P2POp(dist.irecv, r, src, ring.group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        recv = [t.to(device) for t in recv]
    return recv


class RingShift(torch.autograd.Function):
    """ring_shift as an autograd Function: forward a hop by +1, backward a
    hop of the cotangents by -1 (the JAX ppermute's transpose)."""

    @staticmethod
    def forward(ctx, ring, *tensors):
        ctx.ring = ring
        return tuple(ring_shift(ring, tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ring_shift(ctx.ring, grads, reverse=True))


def ring_shift_grad(ring, *tensors) -> tuple:
    """The differentiable hop of `tensors` (RingShift); as they are over a
    ring of one rank."""
    if ring is None or ring.size == 1:
        return tensors
    return RingShift.apply(ring, *tensors)


@dataclasses.dataclass(frozen=True)
class Chain:
    """The stages of a pipeline in order: `group` (their process group),
    this rank's stage `rank` of `size`, and the global ranks of the stages
    before (`prev`) and after (`next`) it (None at either end)."""
    group: object
    rank: int
    size: int
    prev: int | None
    next: int | None


def chain_of(ranks, group) -> Chain:
    """The Chain of this rank over `ranks` (global ranks in stage order,
    this rank among them), whose process group is `group`."""
    ranks = list(ranks)
    me = ranks.index(rank())
    return Chain(group=group, rank=me, size=len(ranks),
                 prev=ranks[me - 1] if me > 0 else None,
                 next=ranks[me + 1] if me + 1 < len(ranks) else None)


def chain_position(chain) -> tuple:
    """(stage, stages) on `chain`; (0, 1) for None, one stage."""
    return (0, 1) if chain is None else (chain.rank, chain.size)


def stage_hop(chain, send=None, recv_like=None, reverse: bool = False):
    """One hop along the stage chain: `send` (or None) goes to the next
    stage, and a tensor shaped and typed as `recv_like` (or nothing, for
    None) comes from the previous one (reverse: to the previous stage,
    from the next). Returns the received tensor (new, contiguous, on
    recv_like's device) or None. The two sides of a hop must agree: a
    rank sends exactly when its partner expects. No call when there is
    nothing to move."""
    if chain is None or (send is None and recv_like is None):
        return None
    dst, src = (chain.prev, chain.next) if reverse else (chain.next,
                                                         chain.prev)
    like = send if send is not None else recv_like
    device = like.device
    staged = (device.type != "cpu"
              and dist.get_backend(chain.group) == "gloo")
    ops = []
    if send is not None:
        out = send.detach().contiguous()
        if staged:  # gloo moves host memory only
            out = out.cpu()
        ops.append(dist.P2POp(dist.isend, out, dst, chain.group))
    recv = None
    if recv_like is not None:
        recv = torch.empty(recv_like.shape, dtype=recv_like.dtype,
                           device="cpu" if staged else device)
        ops.append(dist.P2POp(dist.irecv, recv, src, chain.group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if recv is not None and staged:
        recv = recv.to(device)
    return recv
