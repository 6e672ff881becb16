"""One differentiation boundary per transformer block (the JAX package's
ops/block_vjp.py, `attention_impl="flash_block"`).

`block_apply(cfg, block_params, x, freqs_cis)` computes the pre-LN block of
models.vit._block_body (LN1 -> qkv -> attention -> proj + residual -> LN2 ->
fc1 -> exact-erf GELU -> fc2 + residual) as ONE torch.autograd.Function.
Its forward calls the attention kernels' raw wrappers, routed as
FlashAttentionFunction / StreamingAttentionFunction route them:
`attention_fwd` where N <= STREAMING_THRESHOLD and the dense tiles fit,
`attention_stream_fwd` (which also returns the logsumexp) otherwise. Its
backward is the JAX `_block_bwd` by hand: the GELU gradient Phi(x) + x phi(x)
in float32, the LayerNorm backward recomputing its statistics from the saved
input, the attention backward through `attention_bwd` (dense), the one-pass
`attention_stream_bwd_fused` (streaming, fixed or no frequencies) or the
separate-pass `attention_stream_bwd` with dqr/dkr (streaming, rope-mixed's
learnable [H, S, D/2] tables). Residuals: x, x2, f1, q, k, v, the attention
output and (streaming) its lse; the LN statistics and the GELU are
recomputed.

Products: operands in the compute dtype with float32 accumulation, the
results cast to the compute dtype, except the weight gradients, which stay
float32 until they take their parameter's dtype. No new kernel: on CUDA
tensors the attention runs on the kernels of ops/flash_attention.py, on CPU
tensors on their twins. Bias-free blocks only (none, absolute, rope-axial,
rope-mixed): models.vit routes the bias modes to the per-call boundary.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.ops.layers import layer_norm, linear
from vit_rpe_rope_tpu_torch.utils import nan_check

_INV_SQRT_2 = 1.0 / math.sqrt(2.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _ln_bwd(dh, x, w, eps):
    """LayerNorm backward from the saved input (statistics recomputed).
    Returns (dx in x's dtype, dw float32, db float32)."""
    xf, dhf = x.float(), dh.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    sinv = torch.rsqrt(var + eps)
    xhat = (xf - mean) * sinv
    lead = tuple(range(x.dim() - 1))
    dw = (dhf * xhat).sum(dim=lead)
    db = dhf.sum(dim=lead)
    dxhat = dhf * w.float()
    dx = sinv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dw, db


def _gelu_grad(x):
    """d/dx of the exact-erf GELU, Phi(x) + x phi(x), in float32."""
    xf = x.float()
    cdf = 0.5 * (1.0 + torch.erf(xf * _INV_SQRT_2))
    pdf = _INV_SQRT_2PI * torch.exp(-0.5 * xf * xf)
    return cdf + xf * pdf


def _wgrad(dy, x):
    """float32 weight gradient dy^T x over all leading dims, [out, in]."""
    return torch.matmul(dy.reshape(-1, dy.shape[-1]).t().float(),
                        x.reshape(-1, x.shape[-1]).float())


def _primal(cfg, bp, x, freqs_cis):
    """The block's forward; returns (y, residuals)."""
    eps = cfg.layer_norm_eps
    b, n, e = x.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    h1 = layer_norm(x, bp["norm1.weight"], bp["norm1.bias"], eps)
    # Weight rows are ordered part·E + head·Dh + d: q, k, v are strided
    # views of the [B, N, 3E] product, as in models.vit._block_body.
    qkv = linear(h1, bp["attn.qkv.weight"])
    q, k, v = qkv.view(b, n, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
    cos = sin = None
    if freqs_cis is not None:
        cos, sin = fa._kernel_freqs(freqs_cis, nh, n, x.device)
    scale = dh ** -0.5
    if fa.use_dense(nh, n, False):
        ao, lse = fa.attention_fwd(q, k, v, scale, None, cos, sin), None
    else:
        ao, lse = fa.attention_stream_fwd(q, k, v, scale, None, cos, sin)
    a = ao.transpose(1, 2).reshape(b, n, e)
    x2 = x + linear(a, bp["attn.proj.weight"], bp["attn.proj.bias"])
    h2 = layer_norm(x2, bp["norm2.weight"], bp["norm2.bias"], eps)
    f1 = linear(h2, bp["mlp.fc1.weight"], bp["mlp.fc1.bias"])
    f2 = linear(F.gelu(f1, approximate="none"), bp["mlp.fc2.weight"],
                 bp["mlp.fc2.bias"])
    return x2 + f2, (x, x2, f1, q, k, v, ao, lse, cos, sin)


def _attention_bwd(cfg, q, k, v, ao, lse, dao, cos, sin, freqs_cis,
                   want_dfreqs):
    """(dq, dk, dv, (dcos, dsin) or None) of the raw attention, routed as
    the JAX `_bwd`: dense kernel; one-pass streaming without learnable
    frequencies; separate passes with dqr/dkr for [H, S, D/2] tables."""
    scale = cfg.head_dim ** -0.5
    learnable = freqs_cis is not None and freqs_cis[0].dim() == 3
    dqr = dkr = None
    if lse is None:
        dq, dk, dv, _, dqr, dkr = fa.attention_bwd(
            q, k, v, ao, dao, scale, None, cos, sin,
            want_drot=learnable and want_dfreqs)
    elif not learnable:
        delta = (dao.float() * ao.float()).sum(dim=-1)
        dq, dk, dv, _, _ = fa.attention_stream_bwd_fused(
            q, k, v, dao, lse, delta, scale, cos, sin, out_dtype=q.dtype)
    else:
        dq, dk, dv, _, dqr, dkr, _, _ = fa.attention_stream_bwd(
            q, k, v, ao, dao, lse, scale, None, cos, sin,
            want_drot=want_dfreqs)
    dfreqs = None
    if dqr is not None:
        dfreqs = fa._rot_grads_to_dfreqs(q, k, dqr, dkr, freqs_cis)
    elif freqs_cis is not None and want_dfreqs:  # fixed tables: exact zeros
        dfreqs = (torch.zeros_like(freqs_cis[0]),
                  torch.zeros_like(freqs_cis[1]))
    return dq, dk, dv, dfreqs


def _block_bwd(cfg, bp, freqs_cis, res, dy, want_dfreqs):
    """The JAX `_block_bwd`: (dict of parameter gradients in their dtypes,
    dx, (dcos, dsin) or None)."""
    x, x2, f1, q, k, v, ao, lse, cos, sin = res
    eps = cfg.layer_norm_eps
    b, n, e = x.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    cdt = x.dtype
    lead = (0, 1)

    # MLP tail: y = x2 + fc2(gelu(fc1(LN2(x2))))
    g1 = F.gelu(f1, approximate="none")
    dw2 = _wgrad(dy, g1)
    db2 = dy.float().sum(dim=lead)
    dg1 = torch.matmul(dy, bp["mlp.fc2.weight"].to(cdt))
    df1 = (dg1.float() * _gelu_grad(f1)).to(cdt)
    h2 = layer_norm(x2, bp["norm2.weight"], bp["norm2.bias"], eps)
    dw1 = _wgrad(df1, h2)
    db1 = df1.float().sum(dim=lead)
    dh2 = torch.matmul(df1, bp["mlp.fc1.weight"].to(cdt))
    dx2_ln, dn2w, dn2b = _ln_bwd(dh2, x2, bp["norm2.weight"], eps)
    dx2 = dy + dx2_ln

    # attention tail: x2 = x + proj(attn(qkv(LN1(x))))
    a = ao.transpose(1, 2).reshape(b, n, e)
    dwp = _wgrad(dx2, a)
    dpb = dx2.float().sum(dim=lead)
    dao = torch.matmul(dx2, bp["attn.proj.weight"].to(cdt)).view(
        b, n, nh, dh).transpose(1, 2)
    dq, dk, dv, dfreqs = _attention_bwd(cfg, q, k, v, ao, lse, dao, cos, sin,
                                        freqs_cis, want_dfreqs)
    # [B, N, 3, H, Dh] in the qkv weight's row order
    dqkv = torch.stack([t.to(cdt) for t in (dq, dk, dv)], dim=2)
    dqkv = dqkv.permute(0, 3, 2, 1, 4).reshape(b, n, 3 * e)
    h1 = layer_norm(x, bp["norm1.weight"], bp["norm1.bias"], eps)
    dwq = _wgrad(dqkv, h1)
    dh1 = torch.matmul(dqkv, bp["attn.qkv.weight"].to(cdt))
    dx1, dn1w, dn1b = _ln_bwd(dh1, x, bp["norm1.weight"], eps)

    grads = {
        "norm1.weight": dn1w, "norm1.bias": dn1b, "attn.qkv.weight": dwq,
        "attn.proj.weight": dwp, "attn.proj.bias": dpb,
        "norm2.weight": dn2w, "norm2.bias": dn2b,
        "mlp.fc1.weight": dw1, "mlp.fc1.bias": db1,
        "mlp.fc2.weight": dw2, "mlp.fc2.bias": db2,
    }
    # cotangents take the primal params' dtypes (float32 master weights)
    grads = {key: g.to(bp[key].dtype) for key, g in grads.items()}
    if dfreqs is not None:
        dfreqs = (dfreqs[0].to(freqs_cis[0].dtype),
                  dfreqs[1].to(freqs_cis[1].dtype))
    return grads, dx2 + dx1, dfreqs


class BlockFunction(torch.autograd.Function):
    """The JAX package's block-level custom_vjp. Arguments: cfg, the block
    parameters' names, x [B, N, E], the raw rope tables (cos, sin)
    [S|H,S, D/2] or None, then the block's parameters in the names' order."""

    @staticmethod
    def forward(ctx, cfg, names, x, cos_raw, sin_raw, *params):
        bp = dict(zip(names, params))
        freqs = (cos_raw, sin_raw) if cos_raw is not None else None
        y, res = _primal(cfg, bp, x, freqs)
        nan_check.check("block", y)
        x_, x2, f1, q, k, v, ao, lse, cos, sin = res
        ctx.save_for_backward(x_, x2, f1, q, k, v, ao, lse, cos, sin,
                              cos_raw, sin_raw, *params)
        ctx.cfg, ctx.names = cfg, names
        return y

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        res, (cos_raw, sin_raw), params = saved[:10], saved[10:12], saved[12:]
        bp = dict(zip(ctx.names, params))
        freqs = (cos_raw, sin_raw) if cos_raw is not None else None
        want_dfreqs = freqs is not None and any(ctx.needs_input_grad[3:5])
        grads, dx, dfreqs = _block_bwd(ctx.cfg, bp, freqs, res,
                                       dy.contiguous(), want_dfreqs)
        dcos, dsin = dfreqs if dfreqs is not None else (None, None)
        nan_check.check("block_bwd", dx, dcos, dsin, *grads.values())
        return (None, None, dx, dcos, dsin, *(grads[nm] for nm in ctx.names))


def block_apply(cfg, block_params, x, freqs_cis):
    """One pre-LN transformer block (eval semantics, no dropout) behind one
    differentiation boundary. block_params: the un-prefixed block dict of
    models.vit._block_body; freqs_cis: (cos, sin) [S|H,S, D/2] or None."""
    cos_raw, sin_raw = freqs_cis if freqs_cis is not None else (None, None)
    inputs = [x, cos_raw, sin_raw, *block_params.values()]
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return BlockFunction.apply(cfg, tuple(block_params), x, cos_raw,
                                   sin_raw, *block_params.values())
    return _primal(cfg, block_params, x, freqs_cis)[0]
