"""The data, model, sequence and pipe axes as a mesh — the counterpart of
the JAX package's parallel/mesh.py for data, tensor, context and pipeline
parallelism.

A `Mesh` is one of two things:

* under a process group (parallel.distributed.initialize), the group's
  ranks on a grid of D data positions by T model positions (tensor
  parallelism), by R sequence positions (context parallelism), by P
  stages (pipeline parallelism), or by P stages by T model positions
  (the two together). Rank r sits at data position r // T and model
  position r % T, or at data position r // R and sequence position r % R,
  or at data position r // P and stage r % P (the second axis varies
  fastest, as in the JAX make_mesh, whose lone context- or pipeline-
  parallel run folds its shards onto that axis), or, on the JAX ('data',
  'pipe', 'model') grid, at data position r // (P·T), stage (r // T) % P
  and model position r % T; and serves on its own device (`devices`
  holds that one device). With T > 1 each data row (the T ranks of one
  data and stage position) is a subgroup of its own
  (parallel.distributed.new_group), over which the tensor-parallel
  collectives run; `data_group` holds the D ranks that share every other
  position (the gradient sum over the data axis). With R > 1 each data
  row is a subgroup whose ranks form the KV ring (`seq_ring`, a
  parallel.distributed.Ring); the gradient and ZeRO-1 sums run over the
  whole group. With P > 1 the P ranks that share a data and a model
  position form the stage chain (`pipe_chain`, a parallel.distributed.
  Chain) along which the activations hop, and `replica_group` holds the
  ranks of one model position (the whole group without a model axis),
  over which the replicated params' partial gradients are summed;
* without one, some local devices of this process: data-parallel serving
  (serving.Predictor.from_params(mesh=), export_model(mesh=)) splits a
  batch into equal shards, one per device. A mesh of N "cpu" entries runs
  the same padding and splitting on the CPU.

make_mesh keeps the JAX rule that the data width divides the batch. Over
local devices it takes the largest width that does (math.gcd, as the JAX
make_mesh); over a process group it raises instead, since a rank cannot be
left idle. model_parallel T, seq_parallel R and pipe_parallel P must
divide the world size together (the JAX make_mesh's words). The
compositions with the sequence axis (data x seq x model, and a pipe axis
with a seq axis) are not ported yet: make_mesh refuses them by name.
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
PIPE_AXIS = "pipe"

# The ROADMAP Queue A items that port what make_mesh refuses, by name.
UNPORTED_AXES = {
    "seq_parallel with model_parallel": "the compositions",
    "seq_parallel with pipe_parallel": "the compositions",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: where this process serves (its own device under a process
    group; the local devices of the data axis otherwise). ranks: the
    process group's ranks, or None for a mesh of local devices.
    model_parallel: T, the width of the model axis. data_group /
    model_group: this rank's model column and data row as subgroups (T >
    1 or P > 1; None: the whole group, and no model axis; under P > 1
    data_group is the D ranks of this rank's stage and model position).
    seq_parallel: R, the width of the sequence axis; seq_ring: this rank's
    data row as the KV ring (R > 1 only). pipe_parallel: P, the stages;
    pipe_chain: this rank's stage chain; replica_group: the ranks of its
    model position (None: the whole group) (P > 1 only)."""
    devices: tuple
    ranks: tuple | None = None
    model_parallel: int = 1
    data_group: object = None
    model_group: object = None
    seq_parallel: int = 1
    seq_ring: object = None
    pipe_parallel: int = 1
    pipe_chain: object = None
    replica_group: object = None

    @property
    def shape(self) -> dict:
        n = len(self.ranks if self.ranks is not None else self.devices)
        if self.seq_parallel > 1:
            return {DATA_AXIS: n // self.seq_parallel,
                    SEQ_AXIS: self.seq_parallel}
        shape = {DATA_AXIS: n // (self.model_parallel * self.pipe_parallel)}
        if self.pipe_parallel > 1:
            shape[PIPE_AXIS] = self.pipe_parallel
        if self.model_parallel > 1:
            shape[MODEL_AXIS] = self.model_parallel
        return shape

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
                                       * self.seq_parallel
                                       * self.pipe_parallel)
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

    @property
    def pipe_rank(self) -> int:
        """This process's stage (its blocks' shard)."""
        return (distributed.rank() // self.model_parallel
                % self.pipe_parallel if self.distributed else 0)

    def sum_over_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over this rank's model column (the JAX psum over
        'data'; the whole group when there is no model axis: under context
        parallelism the JAX psum over ('data', 'model'))."""
        if self.data_group is None:
            return distributed.all_reduce_sum(tensor)
        return distributed.all_reduce_sum(tensor, self.data_group)


def _grid_groups(world: int, p: int, t: int) -> dict:
    """The subgroups of this rank on the D x P x T grid (rank r at data
    r // (P·T), stage (r // T) % P, model r % T; P = 1 is tensor
    parallelism's D x T grid): data_group (the D ranks of its stage and
    model position), pipe_chain (the P ranks of its data and model
    position, in stage order; P > 1 only), model_group (the T ranks of
    its data and stage position; T > 1 only) and replica_group (the D·P
    ranks of its model position; P > 1 and T > 1 only, else the whole
    group). Every rank creates every group of each kind, in this order
    (new_group is collective)."""
    me, d = distributed.rank(), world // (p * t)
    i, s, m = me // (p * t), me // t % p, me % t

    def at(i_, s_, m_):
        return (i_ * p + s_) * t + m_

    columns = {(s_, m_): distributed.new_group([at(i_, s_, m_)
                                                for i_ in range(d)])
               for s_ in range(p) for m_ in range(t)}
    out = dict(data_group=columns[s, m])
    if p > 1:
        chains = {(i_, m_): [at(i_, s_, m_) for s_ in range(p)]
                  for i_ in range(d) for m_ in range(t)}
        groups = {key: distributed.new_group(ranks)
                  for key, ranks in chains.items()}
        out["pipe_chain"] = distributed.chain_of(chains[i, m], groups[i, m])
    if t > 1:
        rows = {(i_, s_): distributed.new_group([at(i_, s_, m_)
                                                 for m_ in range(t)])
                for i_ in range(d) for s_ in range(p)}
        out["model_group"] = rows[i, s]
        if p > 1:
            replicas = [distributed.new_group(range(m_, world, t))
                        for m_ in range(t)]
            out["replica_group"] = replicas[m]
    return out


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
    D x T grid (T = model_parallel), a D x R grid (R = seq_parallel), a
    D x P grid (P = pipe_parallel) or a D x P x T grid, the product of
    the widths after D dividing the world size, with this rank's device;
    batch_size, when given, must be a multiple of the data width D.
    Without a group the one process is the whole world (a T or R above 1
    does not divide it): the first num_devices of `devices` (default:
    every CUDA device), as many as divide batch_size evenly when it is
    given (the JAX make_mesh's rule, with its warning)."""
    for name, on in (("seq_parallel with model_parallel",
                      seq_parallel > 1 and model_parallel > 1),
                     ("seq_parallel with pipe_parallel",
                      seq_parallel > 1 and pipe_parallel > 1)):
        if on:
            raise NotImplementedError(
                f"make_mesh({name}: pipe_parallel={pipe_parallel}, "
                f"seq_parallel={seq_parallel}, model_parallel="
                f"{model_parallel}): not ported to the PyTorch package yet; "
                f"see ROADMAP Queue A, {UNPORTED_AXES[name]}")
    group = devices is None and distributed.is_initialized()
    world = distributed.world_size() if group else 1
    second = model_parallel * seq_parallel * pipe_parallel
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
        groups = (_grid_groups(world, pipe_parallel, model_parallel)
                  if pipe_parallel * model_parallel > 1 else {})
        ring = (_seq_ring(world, seq_parallel) if seq_parallel > 1
                else None)
        return Mesh(devices=(distributed.device(),),
                    ranks=tuple(range(world)), model_parallel=model_parallel,
                    seq_parallel=seq_parallel, seq_ring=ring,
                    pipe_parallel=pipe_parallel, **groups)
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
