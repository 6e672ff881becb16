"""Tensor parallelism over the mesh's model axis (Megatron-style) — the
counterpart of the JAX package's parallel/tensor_parallel.py.

Sharding recipe per block (T = the model axis's width, H % T == 0):
  qkv  — reshaped [3, H, Dh, E], heads sharded      -> local [3, H/T, Dh, E]
         (one linear over its [3·H/T·Dh, E] view; the product views as
         [3, B, H/T, N, Dh] without a copy, as models.vit._block_body's)
  proj — [E, E] input columns sharded by head       -> local [E, H/T·Dh];
         partial outputs summed over the model axis (g), bias added once
  fc1  — rows sharded [Hid/T, E] (+ its bias rows)
  fc2  — columns sharded [E, Hid/T]; partial outputs summed (g) + bias
  PE bias / per-head rope tables — computed whole, this rank's heads
         sliced (a generated bias's coefficients / table per head likewise)
  everything else (LN, patch embed, cls, head, PE params) — replicated

Activations stay replicated over the model axis. Megatron's f (identity
forward, all-reduce backward) stands where a replicated activation enters
a block half, g (all-reduce forward, identity backward) where the half's
partial sums leave it: two all-reduces a block half, one forward, one
backward, over the rank's data row (Mesh.model_group). The block is
models.vit._block_body itself, which takes the group (f and g are
parallel.distributed's); this module holds the layouts and the shards.

Dropout: masks on sharded tensors (the attention probabilities of the
local heads, the fc1 rows) come from a stream of this model rank's own;
masks on replicated tensors (after g, drop-path) from a stream that every
model rank of a data rank shares, so the replicated activations, and the
params they update, stay identical on every model rank.
"""

from __future__ import annotations

import torch

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import PE_KIND_LOGITS_BIAS, ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel import distributed

QKV = ".attn.qkv.weight"


# ---------------------------------------------------------------------------
# Layouts and shards
# ---------------------------------------------------------------------------

def prepare_tp_params(params: dict, cfg: ViTConfig) -> dict:
    """qkv.weight [3E, E] -> [3, H, Dh, E] (rows are [q; k; v], head h on
    rows h·Dh..(h+1)·Dh of each); the other tensors keep their reference
    layout. Views, no copy."""
    h, dh, e = cfg.num_heads, cfg.head_dim, cfg.embed_dim
    return {k: v.reshape(3, h, dh, e) if k.endswith(QKV) else v
            for k, v in params.items()}


def restore_reference_params(tp_params: dict, cfg: ViTConfig) -> dict:
    """Inverse of prepare_tp_params (the checkpoint layout)."""
    e = cfg.embed_dim
    return {k: v.reshape(3 * e, e) if k.endswith(QKV) else v
            for k, v in tp_params.items()}


def prepare_tp_opt_state(opt_state, cfg: ViTConfig):
    """(mu, nu, count) with reference-keyed moment dicts -> the same with
    the qkv moments in the TP layout (checkpoints keep the reference
    layout on disk)."""
    mu, nu, count = opt_state
    return prepare_tp_params(mu, cfg), prepare_tp_params(nu, cfg), count


def restore_reference_opt_state(opt_state, cfg: ViTConfig):
    """Inverse of prepare_tp_opt_state."""
    mu, nu, count = opt_state
    return (restore_reference_params(mu, cfg),
            restore_reference_params(nu, cfg), count)


def tp_shard_dims(params: dict) -> dict:
    """{key: the dim sharded over the model axis, or None (replicated)} of
    TP-prepared params (the JAX tp_param_specs)."""
    def dim(key):
        if key.endswith(QKV):
            return 1                       # [3, H, Dh, E]: heads
        if key.endswith(".attn.proj.weight") or key.endswith(
                ".mlp.fc2.weight"):
            return 1                       # input columns
        if key.endswith(".mlp.fc1.weight") or key.endswith(".mlp.fc1.bias"):
            return 0                       # rows
        return None

    return {key: dim(key) for key in params}


def _has_model_axis(mesh) -> bool:
    return mesh is not None and mesh.model_parallel > 1


def shard_params(params: dict, mesh) -> dict:
    """TP-prepared params -> this rank's local ones: model rank m keeps
    slice m of T along each sharded dim (contiguous copies of their own),
    the replicated tensors as they are. Without a model axis (mesh None or
    T = 1), params as they are."""
    if not _has_model_axis(mesh):
        return dict(params)
    t, m = mesh.model_parallel, mesh.model_rank
    out = {}
    for key, d in tp_shard_dims(params).items():
        v = params[key]
        out[key] = v if d is None else v.chunk(t, dim=d)[m].clone(
            memory_format=torch.contiguous_format)
    return out


def gather_params(local: dict, mesh) -> dict:
    """Inverse of shard_params over the rank's data row: the whole
    TP-prepared tensors, exact (distributed.gather_shards), on every rank
    of the row. Without a model axis, local as it is."""
    if not _has_model_axis(mesh):
        return dict(local)
    dims = {k: d for k, d in tp_shard_dims(local).items() if d is not None}
    return distributed.gather_shards(local, dims, mesh.model_rank,
                                     mesh.model_parallel, mesh.model_group)


def shard_reference(params: dict, cfg: ViTConfig, mesh) -> dict:
    """Reference-keyed, reference-layout tensors (params or one moment
    dict) -> this rank's local TP ones; without a model axis (mesh None or
    T = 1) the train state is the reference layout, and params come back
    as they are."""
    if not _has_model_axis(mesh):
        return dict(params)
    return shard_params(prepare_tp_params(params, cfg), mesh)


def gather_reference(local: dict, cfg: ViTConfig, mesh) -> dict:
    """Inverse of shard_reference (every rank of the data row takes part)."""
    if not _has_model_axis(mesh):
        return dict(local)
    return restore_reference_params(gather_params(local, mesh), cfg)


def model_sync_keys(params: dict, cfg: ViTConfig) -> list:
    """The keys of `params` whose gradients are also summed over the model
    axis: the per-head PE params (relative table, polynomial coefficients,
    rope-mixed freqs; the pos_embed.* keys of those modes), of which a
    model rank sees only its own heads' share (the JAX make_tp_train_step's
    needs_model_sync)."""
    if not (pe_registry.get(cfg.pos_encoding).KIND == PE_KIND_LOGITS_BIAS
            or cfg.pos_encoding == "rope-mixed"):
        return []
    return sorted(k for k in params if k.startswith("pos_embed."))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def apply_tp(params: dict, images, cfg: ViTConfig, mesh, generator=None):
    """The TP forward: models.vit.apply's contract on this rank's local
    params (shard_params of the TP-prepared layout); every rank of the
    data row calls it on the same images and gets the same logits.
    generator: None (deterministic), or a pair (shared, local) of
    generators on the images' device for train-mode dropout (module
    docstring). It is models.vit.apply with the mesh, whose blocks are the
    one-device ones with f and g over the model group."""
    return vit.apply(params, images, cfg, generator, mesh=mesh)
