"""Post-training int8 quantization for serving, the JAX package's quant.py
name for name.

Three modes over the SAME int8 weights (`quantize_params` output):

* **w8a8**: int8 x int8 -> int32 products (`torch._int_mm`, cuBLASLt on
  the card) with per-token dynamic activation scales, dequantized by the
  outer product of the two scale vectors; the activations between the
  products in float32;
* **w8a8-static**: int8 products with per-tensor activation scales
  calibrated offline (`calibrate_act_scales`, `{key}:act_scale` scalars):
  a scalar divide / round / clip before each product, no reduction;
  activations between the products in bfloat16;
* **w8a16** (weight-only): the int8 weight dequantized to bfloat16 and a
  bfloat16 `torch.matmul`; activations in bfloat16.

Weights are quantized per output channel, symmetric. Everything that is
not a block linear, the patch embedding or the head (LayerNorm, GELU, the
PE, residuals, the attention and its inner products) stays in float; the
attention runs on the kernels exactly as `models.vit._block_body` calls
them (`ops/flash_attention.flash_attention`: the dense kernel up to the
dense limit, the streaming forward above it, generated polynomial /
relative biases there).

The rounding points are the JAX package's: round half to even, x / scale
(not a reciprocal), the int32 sums exact, dequantization
`y.float() * x_scale[..., None] * w_scale` left to right, w8a16's bias
added in bfloat16 after its product is rounded, w8a8-static's in float32
before the cast to the activation dtype, logits in float32.

`torch._int_mm` on CUDA takes only more than 16 rows and inner and output
widths that are multiples of 8, so every product is zero-padded (16 rows
always, so that a symbolic batch needs no branch; the widths to multiples
of 8 where they are not) and sliced back: zeros add nothing to an int32
sum. There is no float product in its place anywhere. `LAUNCHES_INT_MM`
counts the products on CUDA tensors.
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
from vit_rpe_rope_tpu_torch.models.vit import (_attention_impl, _logits_bias,
                                               patchify)
from vit_rpe_rope_tpu_torch.ops import flash_attention, reference_attention
from vit_rpe_rope_tpu_torch.ops.layers import layer_norm

# Linear-family weights to quantize: every ".weight" that feeds a matmul.
# LayerNorm weights and all biases stay float32. patch_embed.weight
# [E, C, P, P] is reshaped to its matmul form.
_QUANT_SUFFIXES = ("qkv.weight", "proj.weight", "fc1.weight", "fc2.weight")

Q8_MODES = ("w8a8", "w8a8-static", "w8a16")

# Zero rows added below every int8 product's activations: torch._int_mm on
# CUDA needs more than 16 rows, and one fixed pad keeps the row count
# symbolic in an exported program.
INT_MM_PAD_ROWS = 16
INT_MM_ALIGN = 8

LAUNCHES_INT_MM = 0  # torch._int_mm calls on CUDA tensors


def _is_quantized_key(key: str) -> bool:
    if key in ("patch_embed.weight", "head.weight"):
        return True
    return key.startswith("blocks.") and key.endswith(_QUANT_SUFFIXES)


def _over_127(v):
    """v / 127 as an IEEE division on every device (PyTorch's CUDA kernels
    divide by a Python scalar as a product with its reciprocal, which can
    round the other way)."""
    return v / v.new_full((), 127.0)


def quantize_tensor(w):
    """Symmetric int8 quantization of `w` [out, in] (torch linear layout)
    with one scale per OUT channel (reduced over `in`).
    Returns (w_q int8 [out, in], scale float32 [out])."""
    absmax = w.abs().amax(dim=1)
    scale = torch.where(absmax > 0, _over_127(absmax),
                        torch.ones_like(absmax)).float()
    w_q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return w_q.to(torch.int8), scale


def quantize_params(params: dict, cfg: ViTConfig,
                    calib_images=None) -> dict:
    """float32 reference-keyed params -> serving qparams: every matmul
    weight replaced by `{key}:q8` (int8) + `{key}:scale` (float32 per
    output channel); everything else passed through.

    calib_images: optional float [B, H, W, C] batch(es) already
    preprocessed as `models.vit.apply` takes them, on the params' device.
    When given, per-tensor activation scales are calibrated on the ORIGINAL
    float32 weights and added as `{key}:act_scale` scalars, for
    mode="w8a8-static"."""
    out = {}
    for key, w in params.items():
        w = torch.as_tensor(w)
        if _is_quantized_key(key):
            w = w.float()
            if key == "patch_embed.weight":
                w = w.reshape(w.shape[0], -1)  # matmul form [E, C*P*P]
            w_q, scale = quantize_tensor(w)
            out[key + ":q8"] = w_q
            out[key + ":scale"] = scale
        else:
            out[key] = w
    if calib_images is not None:
        out.update(calibrate_act_scales(params, calib_images, cfg))
    return out


def _q8_act(x):
    """Dynamic per-token symmetric int8 activation quantization.
    x: [..., in] float -> (x_q int8, scale float32 [...])."""
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, _over_127(absmax),
                        torch.ones_like(absmax)).float()
    x_q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return x_q.to(torch.int8), scale


def _int_mm(x_q, w_q):
    """x_q [..., in] (int8, or float holding int8 values) against w_q
    [out, in] int8 -> exact int32 [..., out] through torch._int_mm, on
    operands zero-padded to its shape rules (INT_MM_PAD_ROWS more rows,
    widths rounded up to INT_MM_ALIGN) and sliced back."""
    global LAUNCHES_INT_MM
    k, n = x_q.shape[-1], w_q.shape[0]
    k_pad = flash_attention._round_up(k, INT_MM_ALIGN)
    n_pad = flash_attention._round_up(n, INT_MM_ALIGN)
    rows = x_q.reshape(-1, k)
    m = rows.shape[0]
    a = torch.empty((m + INT_MM_PAD_ROWS, k_pad), dtype=torch.int8,
                    device=x_q.device)
    a[m:].zero_()
    if k_pad != k:
        a[:m, k:].zero_()
    a[:m, :k].copy_(rows)
    if (k_pad, n_pad) != (k, n):
        w_q = F.pad(w_q, (0, k_pad - k, 0, n_pad - n))
    y = torch._int_mm(a, w_q.t())
    if y.is_cuda:
        LAUNCHES_INT_MM += 1
    return y[:m, :n].reshape(*x_q.shape[:-1], n)


def q8_linear(x, w_q, w_scale, bias=None):
    """int8 x int8 -> int32 linear: x [..., in] @ w_q.T [in, out],
    dequantized by the outer product of the dynamic per-token and the
    static per-channel scales. (The JAX package's optimization_barrier
    here worked around a TPU compiler hang; nothing stands in for it.)"""
    x_q, x_scale = _q8_act(x)
    y = _int_mm(x_q, w_q)
    y = y.float() * x_scale[..., None] * w_scale
    if bias is not None:
        y = y + bias.float()
    return y


def q8_linear_wo(x, w_q, w_scale, bias=None):
    """Weight-only (W8A16) linear: the int8 weight dequantized in float32
    and rounded once to bfloat16, x rounded to bfloat16, their products
    summed in float32 and the result in x's dtype (a bfloat16 matmul for
    bfloat16 x, as apply_q8 gives it); the bias added in that dtype."""
    w = (w_q.float() * w_scale[:, None]).to(torch.bfloat16)
    if x.dtype == torch.bfloat16:
        y = torch.matmul(x, w.t())
    else:  # a float32 result: products of bf16 operands are exact in f32
        y = torch.matmul(x.to(torch.bfloat16).float(), w.float().t())
        y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def q8_linear_static(x, w_q, w_scale, a_scale, bias=None):
    """Static-scale int8 x int8 -> int32 linear on the calibrated
    per-tensor activation scale `a_scale` (a float32 scalar): a scalar
    divide / round / clip in float32, the product, the dequantization and
    the bias in float32, the result cast to x's dtype."""
    x_q = torch.clamp(torch.round(x.float() / a_scale), -127, 127)
    y = _int_mm(x_q, w_q)
    y = y.float() * (a_scale * w_scale)
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _make_lin(qparams: dict, mode: str):
    """Mode-dispatching linear over quantize_params output: lin(x, wkey,
    bias=None) looks up `{wkey}:q8` / `{wkey}:scale` (+ `{wkey}:act_scale`
    for the static mode) and applies the mode's product."""
    def lin(x, wkey, bias=None):
        w_q = qparams[wkey + ":q8"]
        w_scale = qparams[wkey + ":scale"]
        if mode == "w8a16":
            return q8_linear_wo(x, w_q, w_scale, bias)
        if mode == "w8a8-static":
            a_key = wkey + ":act_scale"
            if a_key not in qparams:
                raise ValueError(
                    f"mode='w8a8-static' needs calibrated activation scales "
                    f"({a_key} missing) — quantize with "
                    f"quantize_params(params, cfg, calib_images=...)")
            return q8_linear_static(x, w_q, w_scale, qparams[a_key], bias)
        return q8_linear(x, w_q, w_scale, bias)
    return lin


def _gelu(x):
    """Exact GELU. In bfloat16 it is jax.nn.gelu's formula op by op,
    0.5 * x * erfc(-x * sqrt(0.5)), each product rounded to bfloat16 as
    the JAX package rounds it, so that the int8 grid of the next product
    sees the same activations; in float32 torch's GELU."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x, approximate="none")
    sqrt_half = torch.tensor(0.5 ** 0.5, dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


def _q8_block(params, prefix, x, cfg: ViTConfig, bias, freqs_cis, impl,
              lin):
    """Serving twin of models.vit._block_body (eval only: no dropout), the
    four block linears through `lin` (quantized, or the calibration
    observer); LayerNorm statistics in float32, the attention on the
    kernels ("flash" / "flash_block") or the unfused oracle
    ("reference")."""
    eps = cfg.layer_norm_eps
    h = layer_norm(x, params[f"{prefix}.norm1.weight"],
                   params[f"{prefix}.norm1.bias"], eps)
    bsz, n, e = h.shape
    nh, dh = cfg.num_heads, cfg.head_dim
    qkv = lin(h, f"{prefix}.attn.qkv.weight")
    q, k, v = qkv.reshape(bsz, n, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
    scale = dh ** -0.5
    if impl in ("flash", "flash_block"):
        if isinstance(bias, tuple):  # generated-bias marker (_logits_bias)
            gen = ({"poly": (bias[0], cfg.grid_size)}
                   if cfg.pos_encoding == "polynomial" else {"rel": bias[0]})
            attn_out = flash_attention.flash_attention(
                q, k, v, scale, freqs_cis=freqs_cis, **gen)
        else:
            attn_out = flash_attention.flash_attention(
                q, k, v, scale, bias=bias, freqs_cis=freqs_cis)
    else:
        attn_out = reference_attention.attention(
            q, k, v, scale, bias=bias, freqs_cis=freqs_cis)
    attn_out = attn_out.transpose(1, 2).reshape(bsz, n, e)
    attn_out = lin(attn_out, f"{prefix}.attn.proj.weight",
                   params[f"{prefix}.attn.proj.bias"])
    x = x + attn_out
    h = layer_norm(x, params[f"{prefix}.norm2.weight"],
                   params[f"{prefix}.norm2.bias"], eps)
    h = lin(h, f"{prefix}.mlp.fc1.weight", params[f"{prefix}.mlp.fc1.bias"])
    h = _gelu(h)
    h = lin(h, f"{prefix}.mlp.fc2.weight", params[f"{prefix}.mlp.fc2.bias"])
    return x + h


def _forward_with_lin(params: dict, images, cfg: ViTConfig, lin,
                      adtype=torch.float32):
    """The shared eval forward (twin of models.vit.apply): every product
    with a weight goes through `lin(x, wkey, bias=None)`; LayerNorm, the
    attention, the PE stay float. Drives both the quantized modes (lin =
    _make_lin) and calibration (lin = the float32 observer of
    calibrate_act_scales)."""
    pe_mod = pe_registry.get(cfg.pos_encoding)
    b, e = images.shape[0], cfg.embed_dim
    x = patchify(images.to(adtype), cfg)
    x = lin(x, "patch_embed.weight", params["patch_embed.bias"])
    cls = params["cls_token"].to(x.dtype).expand(b, 1, e)
    x = torch.cat([cls, x], dim=1)

    bias = freqs_cis = None
    if pe_mod.KIND == PE_KIND_EMBED_ADDITIVE:
        x = pe_mod.add_embedding(params, x)
    elif pe_mod.KIND == PE_KIND_LOGITS_BIAS:
        # The float32 path's bias-or-marker: above the streaming threshold
        # the kernel generates the polynomial / relative bias itself from
        # the (unquantized) coefficients / table.
        bias = _logits_bias(pe_mod, params, cfg)
    elif pe_mod.KIND == PE_KIND_QK_ROTATION:
        freqs_cis = pe_mod.freqs_cis(params, cfg, device=x.device)

    impl = _attention_impl(cfg)
    for i in range(cfg.depth):
        x = _q8_block(params, f"blocks.{i}", x, cfg, bias, freqs_cis, impl,
                      lin)
    x = layer_norm(x, params["norm.weight"], params["norm.bias"],
                   cfg.layer_norm_eps)
    logits = lin(x[:, 0], "head.weight", params["head.bias"])
    return logits.float()


def apply_q8(qparams: dict, images, cfg: ViTConfig, mode: str = "w8a8"):
    """Quantized forward: [B, H, W, C] float images -> [B, classes] float32
    logits, models.vit.apply's eval semantics. mode: "w8a8" (int8 products,
    dynamic per-token scales, float32 activations), "w8a8-static" (int8
    products, calibrated per-tensor scales, bfloat16 activations) or
    "w8a16" (weight-only, bfloat16)."""
    if mode not in Q8_MODES:
        raise ValueError(f"unknown int8 mode {mode!r}; "
                         f"options: {sorted(Q8_MODES)}")
    adtype = torch.float32 if mode == "w8a8" else torch.bfloat16
    return _forward_with_lin(qparams, images, cfg, _make_lin(qparams, mode),
                             adtype)


def calibrate_act_scales(params: dict, calib_images, cfg: ViTConfig) -> dict:
    """Activation scales for mode="w8a8-static": the float32 eval forward
    over the calibration batches, recording the abs-max of the INPUT of
    every quantized product; returns `{wkey}:act_scale` float32 scalars
    (abs-max / 127, per tensor).

    params: the ORIGINAL float32 params (not quantize_params output), so
    the observed activations carry no weight-quantization error.
    calib_images: one float [B, H, W, C] tensor or a list of them, already
    preprocessed, on the params' device. Runs eagerly, without gradients."""
    absmax: dict = {}

    def observer(x, wkey, bias=None):
        xf = x.float()
        m = xf.abs().amax()
        absmax[wkey] = m if wkey not in absmax \
            else torch.maximum(absmax[wkey], m)
        w = torch.as_tensor(params[wkey]).float()
        if wkey == "patch_embed.weight":
            w = w.reshape(w.shape[0], -1)
        y = torch.matmul(xf, w.t())
        if bias is not None:
            y = y + bias.float()
        return y

    batches = calib_images if isinstance(calib_images, (list, tuple)) \
        else [calib_images]
    with torch.no_grad():
        for images in batches:
            _forward_with_lin(params, torch.as_tensor(images), cfg, observer)
    return {wkey + ":act_scale":
            _over_127(torch.clamp(m, min=1e-12).float())
            for wkey, m in absmax.items()}
