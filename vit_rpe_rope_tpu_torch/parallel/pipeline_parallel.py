"""Pipeline parallelism: the transformer blocks staged over the mesh's pipe
axis with a GPipe microbatch schedule — the counterpart of the JAX
package's parallel/pipeline_parallel.py.

Stage s of P owns blocks [s·depth/P, (s+1)·depth/P): its slice of the
depth-stacked params ("blocks.X" [depth, ...] cut on dim 0,
models.vit.stack_block_params), so block parameter and AdamW memory per
rank drop by P. Everything else (patch embed, cls, PE params, final norm,
head) is replicated.

Schedule (`pipeline_schedule`, the JAX contract): the rank's batch splits
into M microbatches; T = M + P - 1 ticks; microbatch t enters stage 0 at
tick t, and stage s is active for ticks [s, s + M), where it runs its
blocks on the activation that stage s - 1 sent after the tick before
(parallel.distributed.stage_hop, one hop a tick between active partners).
Bubble ticks launch nothing, as the JAX gate_bubbles lax.cond skips them.
The last stage collects the outputs [B, N, E].

The backward is the schedule's own (PipelineFunction): in JAX, AD through
the scan transposes each hop into the reverse shift, in reverse tick
order, on every device alike; here each rank's autograd engine would order
its own graph, and a blocking hop that finds its partner elsewhere hangs.
So the forward keeps each active tick's graph (its input detached) and
the backward walks the ticks in reverse: the tick's cotangent (the
output's slice on the last stage, else what stage s + 1 sent back) through
its graph, then the input's cotangent back to stage s - 1 (stage_hop's
transpose). Block-param and PE-argument gradients add up over the
microbatches; stage 0 returns the embedding's.

`apply_pp` (the JAX apply_pp): every stage embeds the whole batch, but
only stage 0's slices enter the pipe, so only stage 0 sends the
embedding params a gradient; the PE arguments are generated once per
forward (models.vit.block_pe: a bias, the streaming generated-bias marker,
or the rope tables); the head runs on the last stage's outputs, its
logits masked to the last stage and re-replicated by Megatron's g over the
stage chain (distributed.psum_identity_bwd).

Gradient layout (train_step._reduce_over_mesh): block params' gradients
are local to their stage (summed over the data axis only); the replicated
params' are partial per stage (the embedding's on stage 0, the head's on
the last, the PE params' on every stage that used them) and are summed
over the stages and the data axis. Dropout is refused, as in JAX.
"""

from __future__ import annotations

import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel

BLOCKS = "blocks."


# ---------------------------------------------------------------------------
# Layouts and shards
# ---------------------------------------------------------------------------

def has_pipe_axis(mesh) -> bool:
    return mesh is not None and mesh.pipe_parallel > 1


def pp_shard_dims(stacked: dict) -> dict:
    """{key: (pipe dim, model dim)} of depth-stacked params (the JAX
    pp_param_specs): "blocks.X" on dim 0 over the stages, nothing over a
    model axis; None where a key is not sharded."""
    return {k: (0 if k.startswith(BLOCKS) else None, None) for k in stacked}


def shard_dims(stacked: dict, mesh) -> dict:
    """pp_shard_dims, or under a model axis pp_tp.pp_tp_shard_dims."""
    if mesh.model_parallel > 1:
        from vit_rpe_rope_tpu_torch.parallel import pp_tp

        return pp_tp.pp_tp_shard_dims(stacked)
    return pp_shard_dims(stacked)


def shard_params(stacked: dict, mesh) -> dict:
    """Depth-stacked params (TP-prepared under a model axis) -> this rank's
    local ones: stage s keeps slice s of P along each pipe dim, and model
    rank m slice m of T along each model dim (contiguous copies of their
    own); the replicated tensors as they are."""
    out = {}
    for key, (pdim, mdim) in shard_dims(stacked, mesh).items():
        v = stacked[key]
        if pdim is not None:
            v = v.chunk(mesh.pipe_parallel, dim=pdim)[mesh.pipe_rank]
        if mdim is not None:
            v = v.chunk(mesh.model_parallel, dim=mdim)[mesh.model_rank]
        out[key] = v if pdim is None and mdim is None else v.clone(
            memory_format=torch.contiguous_format)
    return out


def gather_params(local: dict, mesh) -> dict:
    """Inverse of shard_params: the whole depth-stacked tensors on every
    rank of the stage chain (joined over the model row first, then over
    the chain; distributed.gather_shards)."""
    dims = shard_dims(local, mesh)
    out = distributed.gather_shards(
        local, {k: d[1] for k, d in dims.items() if d[1] is not None},
        mesh.model_rank, mesh.model_parallel, mesh.model_group)
    chain = mesh.pipe_chain
    return distributed.gather_shards(
        out, {k: d[0] for k, d in dims.items() if d[0] is not None},
        chain.rank, chain.size, chain.group)


def shard_reference(params: dict, cfg: ViTConfig, mesh) -> dict:
    """Reference-keyed, reference-layout tensors (params or one moment
    dict) -> this rank's local ones: depth-stacked (and TP-prepared under
    a model axis), then shard_params."""
    if mesh.model_parallel > 1:
        params = tensor_parallel.prepare_tp_params(params, cfg)
    return shard_params(vit.stack_block_params(params, cfg), mesh)


def gather_reference(local: dict, cfg: ViTConfig, mesh) -> dict:
    """Inverse of shard_reference (every rank of the data row takes
    part)."""
    full = vit.unstack_block_params(gather_params(local, mesh), cfg)
    if mesh.model_parallel > 1:
        full = tensor_parallel.restore_reference_params(full, cfg)
    return full


# ---------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------

def _active(stage: int, tick: int, n_micro: int) -> bool:
    return stage <= tick < stage + n_micro


def _walk(chain, n_micro: int, like, run, reverse: bool = False):
    """The ticks of one pass of the schedule on this stage: run(tick,
    microbatch, received) on the active ticks (reverse: in reverse tick
    order), then the hop of what it returned to the next stage (reverse:
    the previous), receiving what the previous (reverse: next) stage's
    active tick sent, for this stage's next tick. like: a tensor of a
    microbatch's shape and type."""
    s, p = distributed.chain_position(chain)
    ticks = range(n_micro + p - 1)
    # the partner this stage receives from, and whether it sends onwards
    partner, sends = (s + 1, s > 0) if reverse else (s - 1, s < p - 1)
    received = None
    for t in (reversed(ticks) if reverse else ticks):
        active = _active(s, t, n_micro)
        y = run(t, t - s, received) if active else None
        expects = 0 <= partner < p and _active(partner, t, n_micro)
        received = distributed.stage_hop(
            chain, y if active and sends else None,
            like if expects else None, reverse=reverse)


def _forward(x_emb, stage_fn, leaves, chain, n_micro: int, record: bool):
    """The forward ticks: the last stage's outputs [B, N, E] (zeros on the
    other stages) and, with record, each active tick's (input, output)
    graph, by microbatch."""
    s, p = distributed.chain_position(chain)
    bsz = x_emb.shape[0]
    mb = bsz // n_micro
    out = torch.zeros_like(x_emb)
    saved = {}

    def run(t, m, received):
        x = x_emb[m * mb:(m + 1) * mb] if s == 0 else received
        if record:
            x = x.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(x, leaves)
            saved[m] = (x, y)
        else:
            y = stage_fn(x, leaves)
        if s == p - 1:
            out[m * mb:(m + 1) * mb] = y.detach()
        return y.detach()

    _walk(chain, n_micro, x_emb[:mb], run)
    return out, saved


class PipelineFunction(torch.autograd.Function):
    """The schedule as one autograd node: forward(x_emb, stage_fn, chain,
    n_micro, *leaves) runs the forward ticks with each active tick's graph
    kept (leaves: the tensors stage_fn reads besides its input, detached
    here); backward walks the ticks in reverse (module docstring)."""

    @staticmethod
    def forward(ctx, x_emb, stage_fn, chain, n_micro, *leaves):
        inner = [v.detach().requires_grad_(v.requires_grad) for v in leaves]
        out, saved = _forward(x_emb.detach(), stage_fn, inner, chain,
                              n_micro, record=True)
        ctx.saved = saved
        ctx.inner, ctx.chain, ctx.n_micro = inner, chain, n_micro
        ctx.emb_like = x_emb.detach()
        return out

    @staticmethod
    def backward(ctx, g_out):
        chain, n_micro, inner = ctx.chain, ctx.n_micro, ctx.inner
        s, p = distributed.chain_position(chain)
        g_emb = torch.zeros_like(ctx.emb_like)
        mb = g_emb.shape[0] // n_micro
        wanted = [i for i, v in enumerate(inner) if v.requires_grad]
        g_leaves = [None] * len(inner)

        def run(t, m, received):
            x, y = ctx.saved.pop(m)
            g_y = g_out[m * mb:(m + 1) * mb] if s == p - 1 else received
            grads = torch.autograd.grad(
                y, [x] + [inner[i] for i in wanted], g_y, allow_unused=True)
            for i, g in zip(wanted, grads[1:]):
                if g is not None:
                    g_leaves[i] = g if g_leaves[i] is None else g_leaves[i] + g
            if s == 0:
                g_emb[m * mb:(m + 1) * mb] = grads[0]
            return grads[0]

        _walk(chain, n_micro, g_emb[:mb], run, reverse=True)
        return (g_emb, None, None, None, *g_leaves)


def pipeline_schedule(x_emb, stage_fn, leaves, chain, n_micro: int):
    """The GPipe ticks (module docstring) on this rank's stage of `chain`
    (None: one stage, plain microbatched execution). x_emb [B, N, E]: the
    whole batch's embedding (only stage 0 reads it); stage_fn(x, leaves)
    applies this stage's blocks to one microbatch [B/M, N, E], reading the
    tensors `leaves` (block params, PE arguments). Returns the last
    stage's outputs [B, N, E] (zeros on the other stages), differentiable
    in x_emb and leaves through PipelineFunction when grad is on and any
    of them requires it."""
    bsz = x_emb.shape[0]
    if bsz % n_micro:
        raise ValueError(f"batch {bsz} not divisible by pp_microbatches="
                         f"{n_micro}")
    if torch.is_grad_enabled() and any(
            v.requires_grad for v in (x_emb, *leaves)):
        return PipelineFunction.apply(x_emb, stage_fn, chain, n_micro,
                                      *leaves)
    with torch.no_grad():
        return _forward(x_emb, stage_fn, leaves, chain, n_micro,
                        record=False)[0]


def _pack_pe(bias, freqs_cis) -> tuple:
    """The PE arguments as (tensors, rebuild): rebuild(tensors) gives
    (bias, freqs_cis) back (a generated-bias marker stays a 1-tuple)."""
    marker = isinstance(bias, tuple)
    tensors = ([] if bias is None else [bias[0] if marker else bias])
    n_bias = len(tensors)
    tensors += list(freqs_cis or ())

    def rebuild(ts):
        b = None if not n_bias else ((ts[0],) if marker else ts[0])
        f = tuple(ts[n_bias:]) or None
        return b, f

    return tensors, rebuild


def apply_staged(params: dict, images, cfg: ViTConfig, mesh, n_micro: int,
                 bias, freqs_cis, impl: str, group=None):
    """The pipelined forward on this rank's local params (block params
    stacked [depth/P, ...]) with the blocks' PE arguments given (already
    cut to the rank's heads under a model axis, whose group f and g run
    over): every stage embeds the whole batch, the schedule runs the
    stage's blocks (models.vit._block_body through remat_block_fn), the
    head runs on the collected outputs, and the logits, masked to the last
    stage, are re-replicated over the stage chain. Returns [B,
    num_classes] float32 logits, the same on every stage."""
    if cfg.has_dropout:
        raise ValueError("pipeline parallelism does not support dropout")
    chain = mesh.pipe_chain if has_pipe_axis(mesh) else None
    s, p = distributed.chain_position(chain)
    x_emb = vit.embed(params, images, cfg)
    names = vit.BLOCK_PARAM_NAMES
    blocks = [params[BLOCKS + name] for name in names]
    pe, rebuild = _pack_pe(bias, freqs_cis)
    block_fn = vit.remat_block_fn(cfg, vit._block_body)

    def stage_fn(x, leaves):
        stacked, (b, f) = leaves[:len(names)], rebuild(leaves[len(names):])
        for j in range(stacked[0].shape[0]):
            block = {name: v[j] for name, v in zip(names, stacked)}
            x = block_fn(block, x, cfg, b, f, impl, group)
        return x

    x = pipeline_schedule(x_emb, stage_fn, blocks + pe, chain, n_micro)
    logits = vit.head(params, x, cfg)
    if p > 1:
        logits = logits * float(s == p - 1)
        logits = distributed.psum_identity_bwd(logits, chain.group)
    return logits


def apply_pp(params: dict, images, cfg: ViTConfig, mesh, n_micro: int):
    """The pipeline-parallel forward (the JAX apply_pp): models.vit.apply's
    contract on this rank's local params (shard_reference), every stage
    of a data rank called on the same images. mesh None (or a mesh without
    a pipe axis) is one stage: plain microbatched execution. The PE
    arguments are models.vit.block_pe's: the streaming generated-bias
    marker above the threshold, as in JAX."""
    bias, freqs_cis = vit.block_pe(params, cfg, images.device)
    return apply_staged(params, images, cfg, mesh, n_micro, bias, freqs_cis,
                        vit._attention_impl(cfg))
