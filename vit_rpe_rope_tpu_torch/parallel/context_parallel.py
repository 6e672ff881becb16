"""Context (sequence) parallelism: attention as a KV ring over the ranks of
a data row — the counterpart of the JAX package's
parallel/context_parallel.py.

Tokens are sharded over the mesh's sequence axis (parallel/mesh.py, R
ranks a data row); each rank keeps its q rows, and the k / v shards rotate
around the ring (parallel.distributed.ring_shift: one hop to the next rank
a step) while an online softmax merges the partial attention. Per-rank
attention memory drops from O(N^2) to O(N^2 / R), activations from O(N) to
O(N / R).

Layout contract (the JAX module's):
  * the global token order is shard-major: rank s of the ring owns tokens
    [s·Nl, (s+1)·Nl) of the padded sequence; the cls token (global index 0)
    is local row 0 of shard 0;
  * padding tokens (to make N divisible by R) sit at the tail of the last
    shard and are masked out of every softmax as keys; their q rows compute
    values that nothing reads (the head reads only the cls row);
  * rope cos / sin are one global table with identity rows for the cls
    token and the padding (ops/flash_attention._prep_freqs), sliced to the
    shard's rows; q and k are rotated before the ring, so the kernels never
    see rope;
  * the polynomial / relative bias is generated per (q shard, key chunk)
    from the raw PE parameters at the shard's global row offset and the
    chunk's global column offset: no [H, N, N] tensor exists. A logits-bias
    PE without a generator is materialized and pre-sliced to [H, Nl, Npad].

Two rings, chosen by `ring_dispatch`:
  * `ring_flash_attention` (RingFlashAttention): each hop is the streaming
    chunk forward (ops/flash_attention.streaming_chunk_fwd, row 4 on the
    card), the hops merged with logaddexp; it saves only (out, lse), and its
    backward re-rings the chunks through the one-pass chunk backward
    (streaming_chunk_bwd, row 5) with the whole row's lse and delta, the
    dk / dv accumulators riding the ring home with k / v. The PE parameters'
    gradient comes out partial over the ring (the train step sums it, as it
    sums every gradient). On CPU tensors the chunk entries run their plain
    twins;
  * `ring_attention`: the plain PyTorch ring (one [Nl, Nl] tile a hop, an
    online softmax), differentiated by autograd through the hop's autograd
    Function. It is the route of the unfused attention (attention_impl
    "reference") and of a PE without a generator.

`apply_cp` is models.vit.apply on this rank's token shard: the embedding
runs redundantly on every rank (O(N·E)), each rank slices its tokens, the
blocks run the ring, the head reads the cls row on shard 0 and an all-reduce
re-replicates the logits over the ring (Megatron's g: its backward is the
identity, so the gradients of the embedding, the blocks and the head come
out partial over the ring, exactly one count per token).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import (
    PE_KIND_EMBED_ADDITIVE,
    PE_KIND_LOGITS_BIAS,
    PE_KIND_QK_ROTATION,
    ViTConfig,
)
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.ops.layers import layer_norm, linear
from vit_rpe_rope_tpu_torch.ops.rotary import rotate_half_split
from vit_rpe_rope_tpu_torch.parallel import distributed

NEG_INF = fa.NEG_INF


def _bias_tile(bias, bias_kind, bias_arg, bias_grid, nl, row0, col0,
               n_valid):
    """[H, Nl, Nl] float32 bias of this shard's rows against the key chunk
    at col0, or None."""
    if bias is not None:
        return bias[:, :, col0:col0 + nl].float()
    if bias_kind == "poly":
        return fa._poly_bias_cols(bias_arg, bias_grid, nl, col0, nl,
                                  bias_arg.shape[1] - 1, row_start=row0,
                                  n_valid=n_valid)
    if bias_kind == "rel":
        return fa._rel_bias_cols(bias_arg, nl, col0, nl, row_start=row0)
    if bias_kind is not None:
        raise ValueError(f"unknown bias_kind {bias_kind!r}")
    return None


def ring_attention(q, k, v, scale, ring, bias=None, n_valid=None,
                   bias_kind=None, bias_arg=None, bias_grid: int = 0):
    """Attention with the KV ring over `ring` (a parallel.distributed.Ring,
    None for one rank), in plain PyTorch, differentiable by autograd (the
    hop's backward shifts the cotangents back).

    q, k, v: [B, H, Nl, D], this rank's tokens (shard-major global order).
    bias: an optional [H, Nl, Npad] logits bias, this shard's rows against
    every key column, exclusive with bias_kind. bias_kind "poly" (bias_arg
    [H, deg+1] coefficients, bias_grid the patch grid) or "rel" (bias_arg
    the [H, 2L-1] table): the bias generated per hop at the global offsets.
    n_valid: the global token count; keys at global indices >= n_valid are
    masked (None: every padded token is valid).

    The merge is the flash recurrence (running max m, normalizer l,
    accumulator); products in float32 of the inputs, p rounded to v's dtype
    before the product with v. Returns [B, H, Nl, D] in v's dtype."""
    if bias is not None and bias_kind is not None:
        raise ValueError("bias and bias_kind are mutually exclusive")
    my, r_total = distributed.ring_position(ring)
    b, h, nl, d = q.shape
    n_pad = nl * r_total
    n_valid = n_pad if n_valid is None else int(n_valid)
    row0 = my * nl
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, nl, d), **f32)
    m = torch.full((b, h, nl), NEG_INF, **f32)
    l = torch.zeros((b, h, nl), **f32)
    k_cur, v_cur = k, v
    for r in range(r_total):
        col0 = ((my - r) % r_total) * nl
        logits = torch.matmul(q.float(), k_cur.float().transpose(-1, -2)) \
            * scale
        tile = _bias_tile(bias, bias_kind, bias_arg, bias_grid, nl, row0,
                          col0, n_valid)
        if tile is not None:
            logits = logits + tile[None]
        if col0 + nl > n_valid:
            keys = col0 + torch.arange(nl, device=q.device)
            logits = torch.where(keys < n_valid, logits,
                                 torch.full((), NEG_INF, **f32))
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), v_cur.float())
        m = m_new
        if r < r_total - 1:  # the last hop would only restore placement
            k_cur, v_cur = distributed.ring_shift_grad(ring, k_cur, v_cur)
    return (acc / l.clamp(min=1e-30)[..., None]).to(v.dtype)


def _generated(bias_kind, bias_arg, bias_grid) -> dict:
    """The chunk entries' poly= / rel= keyword for a generated bias."""
    if bias_kind == "poly":
        return {"poly": (bias_arg, bias_grid)}
    if bias_kind == "rel":
        return {"rel": bias_arg}
    return {}


def ring_flash_fwd(q, k, v, scale, ring, n_valid, kw, mm_dtype, row0=None):
    """The forward hops of the kernel ring: (out [B, H, Nq, D] in v's
    dtype, lse [B, H, Nq] float32) of q's rows (first at global row row0,
    default this shard's first) against every shard's keys. Each hop is one
    streaming_chunk_fwd at the chunk's global column; the hops merge with
    logaddexp (o_c is normalized within its chunk, so its weight is
    exp(lse_c - lse')). A chunk whose keys are all masked gives lse_c near
    NEG_INF and a finite o_c, whose weight is then 0."""
    my, r_total = distributed.ring_position(ring)
    nl = k.shape[2]
    row0 = my * nl if row0 is None else row0
    b, h, nq, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.zeros((b, h, nq, d), **f32)
    lse = torch.full((b, h, nq), NEG_INF, **f32)
    k_cur, v_cur = k, v
    for r in range(r_total):
        col0 = ((my - r) % r_total) * nl
        o_c, lse_c = fa.streaming_chunk_fwd(q, k_cur, v_cur, scale, row0,
                                            col0, n_valid, mm_dtype=mm_dtype,
                                            **kw)
        lse_new = torch.logaddexp(lse, lse_c)
        out = (out * torch.exp(lse - lse_new)[..., None]
               + o_c.float() * torch.exp(lse_c - lse_new)[..., None])
        lse = lse_new
        if r < r_total - 1:
            k_cur, v_cur = distributed.ring_shift(ring, (k_cur, v_cur))
    return out.to(v.dtype), lse


def ring_flash_bwd(q, k, v, g, lse, delta, scale, ring, n_valid, kw,
                   mm_dtype, row0=None):
    """The backward hops of the kernel ring: (dq [B, H, Nq, D], dk, dv
    [B, H, Nl, D] of this rank's own keys, the generated bias' parameter
    gradient or None), all float32, from one streaming_chunk_bwd a hop with
    the whole row's lse and delta. The dk / dv accumulator of the chunk a
    rank holds rides the ring with it and lands on its owner after R hops;
    the parameter gradient is this rank's share (partial over the ring)."""
    my, r_total = distributed.ring_position(ring)
    nl = k.shape[2]
    row0 = my * nl if row0 is None else row0
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, **f32)
    dk = torch.zeros(k.shape, **f32)
    dv = torch.zeros(v.shape, **f32)
    dparam = None
    k_cur, v_cur = k, v
    for r in range(r_total):
        col0 = ((my - r) % r_total) * nl
        dq_c, dk_c, dv_c, dp_c = fa.streaming_chunk_bwd(
            q, k_cur, v_cur, g, lse, delta, scale, row0, col0, n_valid,
            mm_dtype=mm_dtype, **kw)
        dq += dq_c
        dk += dk_c
        dv += dv_c
        if dp_c is not None:
            dparam = dp_c if dparam is None else dparam + dp_c
        if r < r_total - 1:
            k_cur, v_cur, dk, dv = distributed.ring_shift(
                ring, (k_cur, v_cur, dk, dv))
        else:  # the accumulators' last hop home
            dk, dv = distributed.ring_shift(ring, (dk, dv))
    return dq, dk, dv, dparam


class RingFlashAttention(torch.autograd.Function):
    """The kernel ring with its hand-written backward (the JAX
    ring_flash_attention's custom VJP): forward ring_flash_fwd, saving
    (q, k, v, bias_arg, out, lse); backward ring_flash_bwd. bias_arg is
    the per-head coefficients / table of a generated bias, or None."""

    @staticmethod
    def forward(ctx, q, k, v, bias_arg, scale, ring, n_valid, bias_kind,
                bias_grid, mm_dtype):
        kw = _generated(bias_kind, bias_arg, bias_grid)
        out, lse = ring_flash_fwd(q, k, v, scale, ring, n_valid, kw,
                                  mm_dtype)
        ctx.save_for_backward(q, k, v, bias_arg, out, lse)
        ctx.args = (scale, ring, n_valid, bias_kind, bias_grid, mm_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias_arg, out, lse = ctx.saved_tensors
        scale, ring, n_valid, bias_kind, bias_grid, mm_dtype = ctx.args
        delta = (g.float() * out.float()).sum(dim=-1)
        dq, dk, dv, dparam = ring_flash_bwd(
            q, k, v, g, lse, delta, scale, ring, n_valid,
            _generated(bias_kind, bias_arg, bias_grid), mm_dtype)
        dbias_arg = None if bias_arg is None else dparam.to(bias_arg.dtype)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias_arg,
                None, None, None, None, None, None)


def ring_flash_attention(q, k, v, scale, ring, n_valid, bias_kind=None,
                         bias_arg=None, bias_grid: int = 0,
                         mm_dtype=torch.bfloat16):
    """KV-ring attention on the streaming chunk kernels (RingFlashAttention):
    q, k, v [B, H, Nl, D] this rank's tokens, n_valid the global token
    count, bias_kind / bias_arg / bias_grid as in ring_attention (generated
    biases only). mm_dtype float32 is for CPU tensors only (the twins)."""
    return RingFlashAttention.apply(q, k, v, bias_arg, scale, ring,
                                    int(n_valid), bias_kind, bias_grid,
                                    mm_dtype)


def ring_dispatch(cfg: ViTConfig, ring, n_valid, bias_kind, bias_arg,
                  bias_grid, q, k, v, scale):
    """The ring of a block (the JAX ring_dispatch). The kernel ring whenever
    the config's attention is the kernels' (models.vit._attention_impl
    "flash", which "auto" resolves to; "flash_block" too, whose one-block
    boundary cannot hold the ring's hops) and the bias is generated or
    absent; the plain ring for the unfused attention ("reference") and a
    materialized bias. The JAX rule also asks that the chunk backward's
    blocks fit a TPU's VMEM budget; the port's chunk backward segments its
    keys (flash_attention._fused_kv_seg_cols), so it has no such limit."""
    impl = vit._attention_impl(cfg)
    if impl in ("flash", "flash_block") and (bias_kind is not None
                                             or bias_arg is None):
        return ring_flash_attention(q, k, v, scale, ring, n_valid, bias_kind,
                                    bias_arg, bias_grid)
    return ring_attention(q, k, v, scale, ring,
                          bias=bias_arg if bias_kind is None else None,
                          n_valid=n_valid, bias_kind=bias_kind,
                          bias_arg=bias_arg if bias_kind else None,
                          bias_grid=bias_grid)


def _cp_block(bp: dict, x, cfg: ViTConfig, bias_arg, local_freqs, ring,
              n_valid, bias_kind, bias_grid, generator=None):
    """Pre-LN block on this rank's token shard x [B, Nl, E] (un-prefixed
    block params): every op is per token except the attention, which runs
    the ring. local_freqs: the shard's rows of the rope (cos, sin) tables,
    or None. generator: models.vit.remat_block_fn's keyword; always None
    (no dropout under context parallelism)."""
    del generator
    eps = cfg.layer_norm_eps
    h = layer_norm(x, bp["norm1.weight"], bp["norm1.bias"], eps)
    bsz, nl, e = h.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    qkv = linear(h, bp["attn.qkv.weight"])
    q, k, v = qkv.view(bsz, nl, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
    if local_freqs is not None:  # identity rows cover cls and padding
        cos, sin = local_freqs
        q = rotate_half_split(q, cos[None], sin[None])
        k = rotate_half_split(k, cos[None], sin[None])
    out = ring_dispatch(cfg, ring, n_valid, bias_kind, bias_arg, bias_grid,
                        q, k, v, dh ** -0.5)
    out = out.transpose(1, 2).reshape(bsz, nl, e)
    x = x + linear(out, bp["attn.proj.weight"], bp["attn.proj.bias"])
    h = layer_norm(x, bp["norm2.weight"], bp["norm2.bias"], eps)
    h = linear(h, bp["mlp.fc1.weight"], bp["mlp.fc1.bias"])
    h = F.gelu(h, approximate="none")
    return x + linear(h, bp["mlp.fc2.weight"], bp["mlp.fc2.bias"])


def apply_cp(params: dict, images, cfg: ViTConfig, mesh):
    """The context-parallel forward: models.vit.apply's contract on the
    ranks of a data row of `mesh` (parallel.mesh.Mesh with a sequence axis;
    None or one without it: a ring of one rank). Params are replicated,
    every rank of the row takes the same images and returns the same
    logits [B, num_classes] float32. Dropout is refused (as the JAX fit
    refuses it under context parallelism)."""
    if cfg.has_dropout:
        raise ValueError("context parallelism does not support dropout")
    ring = getattr(mesh, "seq_ring", None)
    my, r_total = distributed.ring_position(ring)
    pe_mod = pe_registry.get(cfg.pos_encoding)
    dtype = vit._DTYPES[cfg.compute_dtype]

    x = vit.patch_embed(params, images.to(dtype), cfg)
    bsz = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(bsz, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)  # [B, N, E]
    n = x.shape[1]
    n_pad = -(-n // r_total) * r_total
    nl = n_pad // r_total
    rows = slice(my * nl, (my + 1) * nl)

    bias_kind, bias_arg, bias_grid, freqs_cis = None, None, 0, None
    if pe_mod.KIND == PE_KIND_EMBED_ADDITIVE:
        x = pe_mod.add_embedding(params, x)
    elif pe_mod.KIND == PE_KIND_LOGITS_BIAS:
        if cfg.pos_encoding == "polynomial":
            bias_kind, bias_grid = "poly", cfg.grid_size
            bias_arg = pe_mod.coeff_per_head(params, cfg)
        elif cfg.pos_encoding == "relative":
            bias_kind = "rel"
            bias_arg = pe_mod.table_per_head(params, cfg)
        else:  # a logits-bias PE without a generator: materialize, slice
            full = F.pad(pe_mod.attn_bias(params, cfg),
                         (0, n_pad - n, 0, n_pad - n))
            bias_arg = full[:, rows]
    elif pe_mod.KIND == PE_KIND_QK_ROTATION:
        freqs_cis = pe_mod.freqs_cis(params, cfg, device=x.device)

    x = fa._pad_seq(x, n_pad, 1)[:, rows]
    local_freqs = None
    if freqs_cis is not None:
        cos, sin = fa._prep_freqs(freqs_cis, cfg.num_heads, n_pad,
                                  torch.float32, broadcast=False)
        local_freqs = (cos[:, rows], sin[:, rows])

    block_fn = vit.remat_block_fn(cfg, _cp_block)
    for i in range(cfg.depth):
        bp = {name: params[f"blocks.{i}.{name}"]
              for name in vit.BLOCK_PARAM_NAMES}
        x = block_fn(bp, x, cfg, bias_arg, local_freqs, ring, n, bias_kind,
                     bias_grid)
    x = layer_norm(x, params["norm.weight"], params["norm.bias"],
                   cfg.layer_norm_eps)
    # cls = global token 0 = local row 0 of shard 0; the other shards add
    # zeros to the sum that re-replicates the logits.
    logits = linear(x[:, 0], params["head.weight"], params["head.bias"])
    logits = logits * float(my == 0)
    group = ring.group if ring is not None and ring.size > 1 else None
    return distributed.psum_identity_bwd(logits, group).float()
