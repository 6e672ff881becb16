"""The data, model, sequence and pipe axes as a mesh — the counterpart of
the JAX package's parallel/mesh.py for data, tensor, context and pipeline
parallelism and their compositions.

A `Mesh` is one of two things:

* under a process group (parallel.distributed.initialize), the group's
  ranks on the JAX ('data', 'pipe', 'seq', 'model') grid of D data
  positions, P stages, R sequence positions and T model positions, the
  model axis varying fastest and the data axis slowest: rank r sits at
  data position r // (P·R·T), stage (r // (R·T)) % P, sequence position
  (r // T) % R and model position r % T, i.e. r = ((i·P + s)·R + q)·T +
  m. A width of 1 drops its axis, so the grids of the single axes and of
  their compositions are its cases: D x T (tensor parallelism), D x R
  (context parallelism; the JAX make_mesh folds a lone sequence axis onto
  its second axis, which is where it sits here too), D x P (pipeline
  parallelism), D x P x T (the JAX ('data', 'pipe', 'model') grid), D x R
  x T (the JAX ('data', 'seq', 'model') grid of TP x CP) and D x P x R x
  T (PP x CP, with T = 1, and PP x TP x CP). The rank serves on its own
  device (`devices` holds that one device). Its subgroups
  (parallel.distributed.new_group): with T > 1 the model row (the T ranks
  of one data, stage and sequence position), over which the tensor-
  parallel collectives (Megatron's f and g) run; with R > 1 the KV ring
  (`seq_ring`, a parallel.distributed.Ring: the R ranks of one data,
  stage and model position, T apart); with P > 1 the stage chain
  (`pipe_chain`, a parallel.distributed.Chain: the P ranks of one data,
  sequence and model position) along which the activations hop. The
  gradient sums run over `data_group`, the D·R ranks of one stage and
  model position (the JAX psum over ('data', 'seq'); None, the whole
  group, without a model or pipe axis), and under a pipe axis the
  replicated params' also over `replica_group`, the D·P·R ranks of one
  model position (None: the whole group, when T = 1);
* without one, some local devices of this process: data-parallel serving
  (serving.Predictor.from_params(mesh=), export_model(mesh=)) splits a
  batch into equal shards, one per device. A mesh of N "cpu" entries runs
  the same padding and splitting on the CPU.

make_mesh keeps the JAX rule that the data width divides the batch. Over
local devices it takes the largest width that does (math.gcd, as the JAX
make_mesh); over a process group it raises instead, since a rank cannot be
left idle. model_parallel T, seq_parallel R and pipe_parallel P must
divide the world size together (the JAX make_mesh's words).
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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """devices: where this process serves (its own device under a process
    group; the local devices of the data axis otherwise). ranks: the
    process group's ranks, or None for a mesh of local devices. The
    widths: model_parallel T, seq_parallel R, pipe_parallel P (the data
    width D is the rest). The subgroups of this rank (module docstring):
    data_group, the D·R ranks of its stage and model position (T > 1 or P
    > 1; None: the whole group); model_group, its model row (T > 1);
    seq_ring, its KV ring (R > 1); pipe_chain, its stage chain, and
    replica_group, the ranks of its model position (None: the whole
    group) (P > 1)."""
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
        """{axis: width} of the data axis and of every axis wider than one,
        slowest first."""
        n = len(self.ranks if self.ranks is not None else self.devices)
        widths = ((PIPE_AXIS, self.pipe_parallel),
                  (SEQ_AXIS, self.seq_parallel),
                  (MODEL_AXIS, self.model_parallel))
        shape = {DATA_AXIS: n // math.prod(w for _, w in widths)}
        shape.update((axis, w) for axis, w in widths if w > 1)
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
        return (distributed.rank() // self.model_parallel
                % self.seq_parallel if self.distributed else 0)

    @property
    def model_rank(self) -> int:
        """This process's position on the model axis (its head shard)."""
        return (distributed.rank() % self.model_parallel
                if self.distributed else 0)

    @property
    def pipe_rank(self) -> int:
        """This process's stage (its blocks' shard)."""
        return (distributed.rank() // (self.model_parallel
                                       * self.seq_parallel)
                % self.pipe_parallel if self.distributed else 0)

    def sum_over_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """In-place sum over data_group (the JAX psum over ('data',
        'seq'); the whole group when there is no model or pipe axis: under
        context parallelism alone the JAX psum over ('data', 'model'))."""
        if self.data_group is None:
            return distributed.all_reduce_sum(tensor)
        return distributed.all_reduce_sum(tensor, self.data_group)


def _grid_groups(world: int, p: int, r: int, t: int) -> dict:
    """The subgroups of this rank on the D x P x R x T grid (module
    docstring): data_group (the D·R ranks of its stage and model position;
    P > 1 or T > 1 only), pipe_chain (the P ranks of its data, sequence
    and model position, in stage order; P > 1 only), model_group (the T
    ranks of its data, stage and sequence position; T > 1 only),
    replica_group (the D·P·R ranks of its model position; P > 1 and T > 1
    only, else the whole group) and seq_ring (the R ranks of its data,
    stage and model position, in ring order; R > 1 only). Every rank
    creates every group of each kind, in this order (new_group is
    collective); with R = 1 the groups, and their order, are those of the
    D x P x T grid."""
    me, d = distributed.rank(), world // (p * r * t)
    i, s, q, m = me // (p * r * t), me // (r * t) % p, me // t % r, me % t

    def at(i_, s_, q_, m_):
        return ((i_ * p + s_) * r + q_) * t + m_

    out = {}
    if p * t > 1:
        columns = {(s_, m_): distributed.new_group(
            [at(i_, s_, q_, m_) for i_ in range(d) for q_ in range(r)])
            for s_ in range(p) for m_ in range(t)}
        out["data_group"] = columns[s, m]
    if p > 1:
        chains = {(i_, q_, m_): [at(i_, s_, q_, m_) for s_ in range(p)]
                  for i_ in range(d) for q_ in range(r) for m_ in range(t)}
        groups = {key: distributed.new_group(ranks)
                  for key, ranks in chains.items()}
        out["pipe_chain"] = distributed.chain_of(chains[i, q, m],
                                                 groups[i, q, m])
    if t > 1:
        rows = {(i_, s_, q_): distributed.new_group(
            [at(i_, s_, q_, m_) for m_ in range(t)])
            for i_ in range(d) for s_ in range(p) for q_ in range(r)}
        out["model_group"] = rows[i, s, q]
        if p > 1:
            replicas = [distributed.new_group(range(m_, world, t))
                        for m_ in range(t)]
            out["replica_group"] = replicas[m]
    if r > 1:
        rings = {(i_, s_, m_): [at(i_, s_, q_, m_) for q_ in range(r)]
                 for i_ in range(d) for s_ in range(p) for m_ in range(t)}
        groups = {key: distributed.new_group(ranks)
                  for key, ranks in rings.items()}
        out["seq_ring"] = distributed.ring_of(rings[i, s, m],
                                              groups[i, s, m])
    return out


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
    """The mesh. Under a process group (and no `devices`): its ranks on
    the D x P x R x T grid (module docstring; T = model_parallel, R =
    seq_parallel, P = pipe_parallel), the product of the widths after D
    dividing the world size, with this rank's device; batch_size, when
    given, must be a multiple of the data width D. Without a group the one
    process is the whole world (a width above 1 does not divide it): the
    first num_devices of `devices` (default: every CUDA device), as many
    as divide batch_size evenly when it is given (the JAX make_mesh's
    rule, with its warning)."""
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
        groups = _grid_groups(world, pipe_parallel, seq_parallel,
                              model_parallel)
        return Mesh(devices=(distributed.device(),),
                    ranks=tuple(range(world)), model_parallel=model_parallel,
                    seq_parallel=seq_parallel, pipe_parallel=pipe_parallel,
                    **groups)
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
