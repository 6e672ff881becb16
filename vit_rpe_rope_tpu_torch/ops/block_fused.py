"""A whole pre-LN transformer block forward in one hand-written CUDA kernel
(ops/csrc/block_fused.cu) — the port of the JAX package's experimental
Pallas `_block_kernel` and the function that launches it, `block_forward`
(vit_rpe_rope_tpu/ops/block_fused.py).

What is computed, for x [B, N, E] (cls token at 0), per image:

1. LN1 in float32;
2. qkv = bf16(h) . bf16(Wqkv^T), float32 accumulation;
3. with rope, the half-split rotation of q and k in float32, the cos / sin
   tables [N, Dh/2] carrying an identity row for the cls token;
4. s = bf16(q) . bf16(k)^T * Dh^-0.5; keys at index >= N masked to -1e30;
5. p = exp(s - m) against the FINAL row max m, denom = sum of p;
6. o = (bf16(p) . bf16(v)) / denom: p is rounded unnormalized and the
   division comes after the product;
7. x2 = x + (bf16(o) . bf16(Wproj^T) + bproj); LN2; f1 = bf16(h2) .
   bf16(W1^T) + b1;
8. GELU through the Abramowitz & Stegun erf polynomial (7.1.26, as the
   JAX kernel, which cannot lower erf);
9. y = (x2 + bf16(g) . bf16(W2^T)) + b2, in x's dtype.

No logits bias and no backward, as in the JAX package. Given rope-mixed's
per-head tables ([H, S, D/2]), every head rotates by head 0's table, as the
JAX `block_forward` does (its `_prep_freqs(.., 1, ..)` keeps `cos[0]`): a
copy of the JAX package's behaviour, not a rope-mixed block.

`block_forward` is the kernel's wrapper: on a CUDA tensor it launches the
kernel once (counted in LAUNCHES_BLOCK_FUSED), on a CPU tensor it runs
`block_forward_plain`, the kernel's plain PyTorch twin with the same
rounding points. The kernel holds one image in shared memory
(`smem_layout`); shapes whose image does not fit raise a ValueError that
names the limit.
"""

from __future__ import annotations

import ctypes

import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build
from vit_rpe_rope_tpu_torch.ops.flash_attention import (
    _prep_freqs, _rotate, _round_up)

SOURCE = cuda_build.CSRC / "block_fused.cu"

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES_BLOCK_FUSED = 0

# Shared memory one CTA (one image) may use on an H100: 227 KB.
SMEM_LIMIT = 232_448
ROW_TILE = 16      # rows are padded to whole 16-row WMMA tiles
MLP_CHUNK = 128    # hidden columns of fc1 -> GELU -> fc2 per pass

_SQRT_HALF = 2.0 ** -0.5

# The integer arguments of the C entry point, in the order of its enum Dim.
_DIMS = ("B", "N", "E", "H", "DH", "HID", "IS_BF16", "HAS_ROPE", "NP", "CH",
         "LDR", "LDH", "LDD", "LDQ", "LDS", "LDP", "LDO", "LDF", "LDG",
         "XRES", "HLN", "STAGE", "Q", "K", "V", "O", "P", "DEN", "F1", "G",
         "SMEM")


def _erf(x):
    """erf by Abramowitz & Stegun 7.1.26 (|error| < 1.5e-7), as the JAX
    kernel evaluates it."""
    ax = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * ax)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def _ln(x, w, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def _mm(a, w):
    """bf16(a) . bf16(w)^T with float32 accumulation; w torch-layout
    [out, in]."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        w.to(torch.bfloat16).float().t())


def _tables(freqs_cis, n):
    """(cos, sin) [S, D/2], or per-head [H, S, D/2] of which head 0's is
    kept (the JAX `block_forward`'s `cos[0]`), -> float32 [N, D/2] with the cls
    identity row."""
    if freqs_cis is None:
        return None, None
    cos, sin = _prep_freqs(freqs_cis, 1, n, torch.float32)
    return cos[0].contiguous(), sin[0].contiguous()


def block_forward_plain(x, block_params, cfg, freqs_cis=None):
    """The kernel's function in plain PyTorch (module docstring), on the
    unpadded sequence: padded keys are masked in the kernel, so the valid
    rows do not depend on the padding."""
    bsz, n, e = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    bp = block_params
    cos, sin = _tables(freqs_cis, n)
    xf = x.float()
    qkv = _mm(_ln(xf, bp["norm1.weight"], bp["norm1.bias"], eps),
              bp["attn.qkv.weight"])
    q, k, v = qkv.view(bsz, n, 3, h, dh).permute(2, 0, 3, 1, 4).unbind(0)
    if cos is not None:
        q, k = _rotate(q, cos.to(x.device), sin.to(x.device)), \
            _rotate(k, cos.to(x.device), sin.to(x.device))
    s = torch.matmul(q.to(torch.bfloat16).float(),
                     k.to(torch.bfloat16).float().transpose(-1, -2)) \
        * dh ** -0.5
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(),
                     v.to(torch.bfloat16).float()) / p.sum(dim=-1,
                                                           keepdim=True)
    a = o.transpose(1, 2).reshape(bsz, n, e)
    xf = xf + (_mm(a, bp["attn.proj.weight"]) + bp["attn.proj.bias"].float())
    f1 = _mm(_ln(xf, bp["norm2.weight"], bp["norm2.bias"], eps),
             bp["mlp.fc1.weight"]) + bp["mlp.fc1.bias"].float()
    g = 0.5 * f1 * (1.0 + _erf(f1 * _SQRT_HALF))
    xf = xf + _mm(g, bp["mlp.fc2.weight"]) + bp["mlp.fc2.bias"].float()
    return xf.to(x.dtype)


def smem_layout(n: int, e: int, dh: int, hidden: int) -> dict:
    """The kernel's shared memory for one image of n tokens: row pitches
    (elements) and 128-byte aligned offsets (bytes) of its buffers, keyed as
    the C entry point's Dim. SMEM is the total in bytes.

    xres f32 [Np, E] the residual stream; hln bf16 [Np, E] the LN output;
    then either the attention of one head (a float32 staging slab for the
    qkv product, then the logits, then the unnormalized output; bf16 q, k,
    v, o [Np, Dh]; bf16 p [Np, Np]; the row sums) or one MLP chunk (float32
    f1 [Np, 128], bf16 GELU output [Np, 128])."""
    npad = _round_up(n, ROW_TILE)
    ch = min(MLP_CHUNK, hidden)
    lay = dict(NP=npad, CH=ch, LDR=e + 4, LDH=e + 8, LDD=dh + 8,
               LDQ=3 * dh + 4, LDS=npad + 4, LDP=npad + 8, LDO=dh + 4,
               LDF=ch + 4, LDG=ch + 8)

    def size(rows, pitch, nbytes):
        return _round_up(rows * pitch * nbytes, 128)

    off = 0
    for name, pitch, nbytes in (("XRES", lay["LDR"], 4),
                                ("HLN", lay["LDH"], 2)):
        lay[name] = off
        off += size(npad, pitch, nbytes)
    region = off
    att = region
    for name, pitch, nbytes in (
            ("STAGE", max(lay["LDQ"], lay["LDS"], lay["LDO"]), 4),
            ("Q", lay["LDD"], 2), ("K", lay["LDD"], 2), ("V", lay["LDD"], 2),
            ("O", lay["LDD"], 2), ("P", lay["LDP"], 2), ("DEN", 1, 4)):
        lay[name] = att
        att += size(npad, pitch, nbytes)
    mlp = region
    for name, pitch, nbytes in (("F1", lay["LDF"], 4), ("G", lay["LDG"], 2)):
        lay[name] = mlp
        mlp += size(npad, pitch, nbytes)
    lay["SMEM"] = max(att, mlp)
    return lay


def _bind(lib):
    lib.block_fused_fwd.restype = ctypes.c_int
    lib.block_fused_fwd.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # 15 pointers
        ctypes.POINTER(ctypes.c_int),      # the Dim integers
        ctypes.c_float, ctypes.c_float,    # eps scale
        ctypes.c_void_p]                   # stream


def _library():
    return cuda_build.load(SOURCE, _bind)


def _bf16_weight(w):
    """A contiguous bf16 copy of a weight (the kernel's B operands are read
    as bf16 WMMA fragments straight from memory: 256-byte aligned)."""
    w = w.detach().to(torch.bfloat16).contiguous()
    return w if w.data_ptr() % 256 == 0 else w.clone()


def _f32(t):
    return t.detach().to(torch.float32).contiguous()


def block_forward(x, block_params, cfg, freqs_cis=None, batch_tile: int = 8):
    """One fused-block forward, the JAX package's `block_forward`: x
    [B, N, E] (cls at 0), block_params un-prefixed (norm1.weight,
    attn.qkv.weight [3E, E] torch layout, ...), freqs_cis (cos, sin)
    [S, D/2] for rope-axial, [H, S, D/2] (head 0's used for every head, as
    in the JAX package) or None. Returns [B, N, E] in x's dtype.
    batch_tile is the JAX package's grid tile; results do not depend on it
    (one CTA per image here).

    CPU tensors run the plain twin. CUDA tensors launch the kernel on the
    current stream, or raise."""
    global LAUNCHES_BLOCK_FUSED
    if int(batch_tile) < 1:
        raise ValueError(f"batch_tile must be >= 1; got {batch_tile}")
    bsz, n, e = x.shape
    h, dh, hid = cfg.num_heads, cfg.head_dim, cfg.mlp_hidden_dim
    cos, sin = _tables(freqs_cis, n)
    if x.device.type == "cpu":
        return block_forward_plain(x, block_params, cfg, freqs_cis)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_forward takes float32 or bfloat16; got "
                        f"{x.dtype}")
    if e != cfg.embed_dim or e % ROW_TILE or dh % ROW_TILE or \
            hid % ROW_TILE:
        raise ValueError(f"the fused block kernel takes E, head dim and "
                         f"hidden width in multiples of {ROW_TILE}; got E={e}"
                         f", Dh={dh}, hidden={hid}")
    if not 1 <= bsz <= 2 ** 31 - 1:
        raise ValueError(f"unsupported batch {bsz}")
    lay = smem_layout(n, e, dh, hid)
    if lay["SMEM"] > SMEM_LIMIT:
        raise ValueError(
            f"one image of {n} tokens at E={e} (Dh={dh}, hidden={hid}) needs "
            f"{lay['SMEM']} bytes of shared memory; the fused block kernel "
            f"holds an image in one CTA, at most {SMEM_LIMIT} bytes (227 KB) "
            f"on an H100")
    bp = block_params
    x = x.contiguous()
    out = torch.empty_like(x)
    dev = x.device
    vecs = [_f32(bp[nm]).to(dev) for nm in (
        "norm1.weight", "norm1.bias", "attn.proj.bias", "norm2.weight",
        "norm2.bias", "mlp.fc1.bias", "mlp.fc2.bias")]
    mats = [_bf16_weight(bp[nm].to(dev)) for nm in (
        "attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
        "mlp.fc2.weight")]
    if cos is not None:
        cos, sin = cos.to(dev), sin.to(dev)
    tensors = (x, out, *vecs, *mats, cos, sin)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() if t is not None else None for t in tensors))
    lay.update(B=bsz, N=n, E=e, H=h, DH=dh, HID=hid,
               IS_BF16=int(x.dtype == torch.bfloat16),
               HAS_ROPE=int(cos is not None))
    dims = (ctypes.c_int * len(_DIMS))(*(int(lay[k]) for k in _DIMS))
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.block_fused_fwd(ptrs, dims, float(cfg.layer_norm_eps),
                                  float(dh ** -0.5),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_fused_fwd launch failed: CUDA error {err}")
    LAUNCHES_BLOCK_FUSED += 1
    return out
