"""Fused dense attention, forward and backward, with in-kernel rope, on
hand-written CUDA kernels (ops/csrc/attn_fwd.cu, ops/csrc/attn_bwd.cu) — the
port of the JAX package's Pallas `_attn_kernel` / `_dense_bwd_kernel` and
their drivers `_forward` / `_bwd_dense`, with the `jax.custom_vjp` around
them as a `torch.autograd.Function`.

What is computed, for q, k, v [B, H, N, D]:

* rope (axial / mixed): q and k are rotated in float32 with the half-split
  convention; the cos/sin tables carry an IDENTITY row for the cls token
  (cos=1, sin=0), so one uniform rotation leaves token 0 unrotated
  (`_prep_freqs`);
* bias (relative / polynomial): an optional materialized [H, N, N] float32
  bias added to the scaled logits (`_poly_bias_cols` / `_rel_bias_cols`
  build it from the coefficients / table below the streaming threshold);
* products: operands rounded to bfloat16, accumulated in float32 — the
  JAX kernels' regime; softmax statistics in float32. The forward rounds
  p = exp(s - max) to bfloat16 for the PV product and divides by the row
  sum AFTER it; the backward normalizes p BEFORE rounding it;
* outputs in the input dtype; the backward's dbias and rotated-space
  dqr/dkr in float32.

`attention_fwd` / `attention_bwd` are the kernels' wrappers: on a CUDA
tensor they launch the kernel (and count the launch in LAUNCHES /
LAUNCHES_BWD), on a CPU tensor they run `attention_plain` /
`attention_bwd_plain`, the kernels' plain PyTorch twins. Nothing falls
back: a CUDA call the kernel cannot take raises.

`flash_attention` takes the autograd Function when grad is enabled and an
input requires it, and calls the forward wrapper directly otherwise. The
gradient of a generated bias (polynomial coefficients, relative table)
flows from dbias through torch autograd of the bias generator; learnable
rope-mixed frequencies get theirs from dqr/dkr (`_rot_grads_to_dfreqs`).

The streaming kernels of the JAX package (`_stream_kernel`,
`_stream_bwd_fused_kernel` and the separate-pass `_bwd_streaming`
kernels) are not ported yet: above STREAMING_THRESHOLD, or where
`_dense_attn_fits` fails, `flash_attention` raises.
"""

from __future__ import annotations

import ctypes

import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build

LANE = 128
NEG_INF = -1e30

# Sequences longer than this take the JAX package's streaming kernels.
STREAMING_THRESHOLD = 2048

# Launches of the CUDA kernel since the count was last reset (plain int:
# a run shows that its main path went through the kernel by reading it).
LAUNCHES = 0

# Launches of the backward kernel (one per attention_bwd call on CUDA).
LAUNCHES_BWD = 0

SOURCE = cuda_build.CSRC / "attn_fwd.cu"
BWD_SOURCE = cuda_build.CSRC / "attn_bwd.cu"
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are instantiated for


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dense_attn_fits(h: int, n: int, has_bias: bool) -> bool:
    """The JAX package's routing predicate between its dense and streaming
    kernels (a TPU VMEM budget), kept so both packages route the same
    shapes the same way."""
    nq = _round_up(n, 8)
    nk = _round_up(n, LANE)
    tiles = (4 + (1 if has_bias else 0)) * h * nq * nk * 4
    return tiles <= 12 * 1024 * 1024


def _prep_freqs(freqs_cis, num_heads, n_pad, dtype, broadcast=True):
    """(cos, sin) [S, D/2] or [H, S, D/2] (S = N-1 patch tokens) ->
    [H, Np, D/2] with an identity row for the cls token and identity rows in
    the padding region. broadcast=False keeps head-shared tables (rope-axial)
    at H=1."""
    cos, sin = freqs_cis
    if cos.dim() == 2:
        reps = num_heads if broadcast else 1
        cos = cos[None].expand((reps,) + tuple(cos.shape))
        sin = sin[None].expand((reps,) + tuple(sin.shape))
    h, s, d2 = cos.shape
    pad_rows = n_pad - s - 1
    ones = torch.ones((h, 1 + pad_rows, d2), dtype=cos.dtype, device=cos.device)
    zeros = torch.zeros((h, 1 + pad_rows, d2), dtype=sin.dtype,
                        device=sin.device)
    cos = torch.cat([ones[:, :1], cos, ones[:, 1:]], dim=1)
    sin = torch.cat([zeros[:, :1], sin, zeros[:, 1:]], dim=1)
    return cos.to(dtype), sin.to(dtype)


def _poly_bias_cols(coeff_hk, grid, n_rows, start, width, degree,
                    row_start=0, n_valid=None):
    """[H, n_rows, width] polynomial bias for token rows
    [row_start, row_start+n_rows) against token columns [start, start+width);
    zero on the cls row/col (and, with n_valid, on padded indices)."""
    device = coeff_hk.device
    rows = row_start + torch.arange(n_rows, device=device)
    cols = start + torch.arange(width, device=device)
    xq, yq = (rows - 1) % grid, torch.div(rows - 1, grid, rounding_mode="floor")
    xk, yk = (cols - 1) % grid, torch.div(cols - 1, grid, rounding_mode="floor")
    dist = ((xq[:, None] - xk[None, :]).abs()
            + (yq[:, None] - yk[None, :]).abs()).float()
    powers = torch.stack([dist ** kk for kk in range(degree + 1)], dim=-1)
    bias = torch.einsum("nwk,hk->hnw", powers, coeff_hk.float())
    mask = (rows[:, None] > 0) & (cols[None, :] > 0)
    if n_valid is not None:
        mask = mask & (rows[:, None] < n_valid) & (cols[None, :] < n_valid)
    return torch.where(mask[None], bias, torch.zeros((), device=device))


def _rel_bias_cols(table_h, n_rows, start, width, row_start=0):
    """[H, n_rows, width] relative bias for token rows
    [row_start, row_start+n_rows) × cols [start, start+width), gathered from
    the [H, 2L-1] table; out-of-table offsets clamp to the table edge."""
    ell = (table_h.shape[1] + 1) // 2
    device = table_h.device
    rows = row_start + torch.arange(n_rows, device=device)
    cols = start + torch.arange(width, device=device)
    idx = (rows[:, None] - cols[None, :] + ell - 1).clamp(
        0, table_h.shape[1] - 1)
    return table_h[:, idx].float()


# ---------------------------------------------------------------------------
# The plain twin
# ---------------------------------------------------------------------------

def _rotate(x, cos, sin):
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_plain(q, k, v, scale, bias=None, cos=None, sin=None,
                    mm_dtype=torch.bfloat16):
    """The kernel's function in plain PyTorch, on unpadded tensors.

    q, k, v [B, H, N, D]; bias [H, N, N] float32 or None; cos/sin
    [1|H, N, D/2] float32 (from _prep_freqs: row 0 is the identity) or None.
    mm_dtype rounds the product operands: bfloat16 reproduces the kernel
    (rounding to bf16 and multiplying in f32 is exact for bf16 products),
    float32 the JAX package's high-precision twin.
    """
    qf, kf = q.float(), k.float()
    if cos is not None:
        qf = _rotate(qf, cos[None], sin[None])
        kf = _rotate(kf, cos[None], sin[None])
    qm = qf.to(mm_dtype).float()
    km = kf.to(mm_dtype).float()
    logits = torch.matmul(qm, km.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[None]
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(mm_dtype).float(), v.to(mm_dtype).float())
    return (out / denom).to(q.dtype)


def attention_bwd_plain(q, k, v, out, g, scale, bias=None, cos=None,
                        sin=None, mm_dtype=torch.bfloat16, want_dbias=False,
                        want_drot=False):
    """The backward kernel's function in plain PyTorch, on unpadded tensors:
    the rounding points of `_dense_bwd_kernel` (see the module docstring).

    Arguments as attention_plain, plus the forward's output `out` and the
    output cotangent `g` [B, H, N, D]. Returns (dq, dk, dv, dbias, dqr,
    dkr): dq/dk/dv in the input dtype; dbias = sum over the batch of ds,
    float32 [H, N, N], when want_dbias; dqr/dkr, float32 dq/dk before the
    inverse rotation, when want_drot (else None)."""
    qf, kf = q.float(), k.float()
    if cos is not None:
        qf = _rotate(qf, cos[None], sin[None])
        kf = _rotate(kf, cos[None], sin[None])
    qm = qf.to(mm_dtype).float()
    km = kf.to(mm_dtype).float()
    s = torch.matmul(qm, km.transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias[None]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pd = p / p.sum(dim=-1, keepdim=True)
    gf = g.float()
    gm = gf.to(mm_dtype).float()
    dv = torch.matmul(pd.to(mm_dtype).float().transpose(-1, -2), gm)
    gv = torch.matmul(gm, v.to(mm_dtype).float().transpose(-1, -2))
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    ds = pd * (gv - delta)
    dsm = ds.to(mm_dtype).float()
    dq = scale * torch.matmul(dsm, km)
    dk = scale * torch.matmul(dsm.transpose(-1, -2), qm)
    dbias = ds.sum(dim=0) if want_dbias else None
    dqr, dkr = (dq, dk) if want_drot else (None, None)
    if cos is not None:  # inverse rotation back to unrotated space
        dq = _rotate(dq, cos[None], -sin[None])
        dk = _rotate(dk, cos[None], -sin[None])
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dqr, dkr)


def _rot_grads_to_dfreqs(q, k, dqr, dkr, freqs_cis):
    """(dcos, dsin) for learnable per-head frequencies from rotated-space
    gradients. With r = [x1·cos − x2·sin, x1·sin + x2·cos] and g = ∂L/∂r:
      ∂L/∂cos = g1·x1 + g2·x2,   ∂L/∂sin = −g1·x2 + g2·x1,
    summed over the batch, for both the q and k sides; the cls row (the
    identity row of the kernel's tables) is dropped, so the result has the
    caller's [S|H,S, D/2] layout."""
    def side(x, gr):
        d2 = x.shape[-1] // 2
        x1, x2 = x[..., :d2], x[..., d2:]
        g1, g2 = gr[..., :d2].float(), gr[..., d2:].float()
        return (g1 * x1 + g2 * x2).sum(dim=0), (-g1 * x2 + g2 * x1).sum(dim=0)

    dcos_q, dsin_q = side(q.float(), dqr)
    dcos_k, dsin_k = side(k.float(), dkr)
    s = freqs_cis[0].shape[-2]  # patch-token rows in the caller's layout
    dcos = dcos_q[:, 1:1 + s] + dcos_k[:, 1:1 + s]
    dsin = dsin_q[:, 1:1 + s] + dsin_k[:, 1:1 + s]
    if freqs_cis[0].dim() == 2:  # shared across heads (axial layout)
        dcos, dsin = dcos.sum(dim=0), dsin.sum(dim=0)
    return dcos.to(freqs_cis[0].dtype), dsin.to(freqs_cis[1].dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels: bind, launch
# ---------------------------------------------------------------------------

def _bind_fwd(lib):
    lib.attn_fwd.restype = ctypes.c_int
    lib.attn_fwd.argtypes = (
        [ctypes.c_void_p] * 7                     # q k v out bias cos sin
        + [ctypes.c_int] * 6                      # B H N D is_bf16 cos_heads
        + [ctypes.POINTER(ctypes.c_longlong)]     # 12 strides
        + [ctypes.c_float, ctypes.c_void_p])      # scale stream


def _bind_bwd(lib):
    lib.attn_bwd_batch_group.restype = ctypes.c_int
    lib.attn_bwd_batch_group.argtypes = ()
    lib.attn_bwd.restype = ctypes.c_int
    lib.attn_bwd.argtypes = (
        [ctypes.POINTER(ctypes.c_void_p),         # 16 pointers
         ctypes.POINTER(ctypes.c_longlong)]       # 24 strides
        + [ctypes.c_int] * 7          # B H N D is_bf16 cos_heads groups
        + [ctypes.c_float, ctypes.c_void_p])      # scale stream


def _library():
    return cuda_build.load(SOURCE, _bind_fwd)


def _bwd_library():
    return cuda_build.load(BWD_SOURCE, _bind_bwd)


def _check_cuda_inputs(q, k, v, bias, cos, sin):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_fwd takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, H, N, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"attn_fwd is built for head dims {HEAD_DIMS}; "
                         f"got {d}")
    if min(b, h, n) < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if bias is not None:
        if (bias.shape != (h, n, n) or bias.dtype != torch.float32
                or not bias.is_contiguous() or bias.device != q.device):
            raise ValueError("bias must be a contiguous float32 [H, N, N] "
                             "tensor on q's device")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin come together")
    if cos is not None:
        for t in (cos, sin):
            if (t.dim() != 3 or t.shape[0] not in (1, h)
                    or tuple(t.shape[1:]) != (n, d // 2)
                    or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != q.device):
                raise ValueError("cos/sin must be contiguous float32 "
                                 "[1|H, N, D/2] tensors on q's device")
        if cos.shape != sin.shape:
            raise ValueError("cos and sin must have one shape")


def attention_fwd(q, k, v, scale, bias=None, cos=None, sin=None):
    """The kernel's wrapper; arguments as attention_plain (bf16 products).

    CPU tensors run the plain twin. CUDA tensors launch the kernel on the
    current stream, or raise. The output is [B, H, N, D] laid out as
    [B, N, H, D] in memory, so the caller's transpose to [B, N, H*D] is a
    view."""
    global LAUNCHES
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, bias, cos, sin)
    _check_cuda_inputs(q, k, v, bias, cos, sin)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bias.data_ptr() if bias is not None else None,
            cos.data_ptr() if cos is not None else None,
            sin.data_ptr() if sin is not None else None,
            b, h, n, d, int(q.dtype == torch.bfloat16),
            cos.shape[0] if cos is not None else 0,
            strides, float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def attention_bwd(q, k, v, out, g, scale, bias=None, cos=None, sin=None,
                  want_dbias=False, want_drot=False):
    """The backward kernel's wrapper; arguments and results as
    attention_bwd_plain (bf16 products).

    CPU tensors run the plain twin. CUDA tensors launch the kernel on the
    current stream, or raise. dq, dk and dv are views of one [B, N, 3, H, D]
    buffer (the layout of the model's qkv product)."""
    global LAUNCHES_BWD
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, g, scale, bias, cos, sin,
                                   want_dbias=want_dbias, want_drot=want_drot)
    _check_cuda_inputs(q, k, v, bias, cos, sin)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    if out.stride(-1) != 1:
        raise ValueError("out must be contiguous in its last dim")
    if g.stride(-1) != 1:
        g = g.contiguous()
    if want_dbias and bias is None:
        raise ValueError("dbias needs the bias the forward was given")
    b, h, n, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    stats = torch.empty((3, b, h, n), **f32)
    dqr = dkr = dbias = part = None
    if want_drot:
        dqr = torch.empty((b, h, n, d), **f32)
        dkr = torch.empty((b, h, n, d), **f32)
    lib = _bwd_library()
    groups = -(-b // lib.attn_bwd_batch_group())
    if want_dbias:
        dbias = torch.empty((h, n, n), **f32)
        if groups > 1:
            part = torch.empty((groups, h, n, n), **f32)
    tensors = (q, k, v, out, g, dq, dk, dv, dqr, dkr, bias, cos, sin, stats,
               dbias, part)
    ptrs = (ctypes.c_void_p * 16)(
        *(t.data_ptr() if t is not None else None for t in tensors))
    strides = (ctypes.c_longlong * 24)(
        *(s for t in tensors[:8] for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = lib.attn_bwd(
            ptrs, strides, b, h, n, d, int(q.dtype == torch.bfloat16),
            cos.shape[0] if cos is not None else 0, groups, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_bwd launch failed: CUDA error {err}")
    LAUNCHES_BWD += 1
    return dq, dk, dv, dbias, dqr, dkr


class FlashAttentionFunction(torch.autograd.Function):
    """The JAX package's custom_vjp around the dense kernels: forward
    `attention_fwd`, backward `attention_bwd`. bias is the materialized f32
    [H, N, N] bias (or None); cos/sin the caller's raw [S|H,S, D/2] tables
    (or None), prepared for the kernels inside."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cos_raw, sin_raw, scale):
        cos = sin = None
        if cos_raw is not None:
            cos, sin = _kernel_freqs((cos_raw, sin_raw), q.shape[1],
                                     q.shape[2], q.device)
        out = attention_fwd(q, k, v, scale, bias, cos, sin)
        ctx.save_for_backward(q, k, v, out, bias, cos, sin, cos_raw, sin_raw)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, bias, cos, sin, cos_raw, sin_raw = ctx.saved_tensors
        want_drot = cos_raw is not None and any(ctx.needs_input_grad[4:6])
        dq, dk, dv, dbias, dqr, dkr = attention_bwd(
            q, k, v, out, g, ctx.scale, bias, cos, sin,
            want_dbias=ctx.needs_input_grad[3], want_drot=want_drot)
        dcos = dsin = None
        if want_drot:
            dcos, dsin = _rot_grads_to_dfreqs(q, k, dqr, dkr,
                                              (cos_raw, sin_raw))
        return dq, dk, dv, dbias, dcos, dsin, None


# ---------------------------------------------------------------------------
# Public entry: routing and bias / rope preparation (the JAX `_forward` and
# the dense branch of `_bwd`)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale, bias=None, freqs_cis=None, poly=None,
                    rel=None):
    """Fused attention over [B, H, N, D] -> [B, H, N, D], differentiable.

    bias: [H, N, N]; freqs_cis: (cos, sin) [S|H,S, D/2] over the N-1 patch
    tokens; poly: (coeff_hk [H, deg+1], grid_size); rel: table [H, 2N-1].
    bias, poly and rel are mutually exclusive."""
    _, h, n, _ = q.shape
    has_biasish = bias is not None or poly is not None or rel is not None
    inputs = [q, k, v, bias, rel, poly[0] if poly is not None else None,
              *(freqs_cis or ())]
    training = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    if n > STREAMING_THRESHOLD or not _dense_attn_fits(h, n, has_biasish):
        raise NotImplementedError(
            f"attention at N={n}, H={h} takes the streaming route, whose "
            f"kernels (_stream_kernel; in training _stream_bwd_fused_kernel "
            f"and _bwd_streaming) are not ported yet")
    if training:
        bias = _dense_bias(h, n, q.device, bias, poly, rel)
        cos_raw, sin_raw = freqs_cis if freqs_cis is not None else (None, None)
        return FlashAttentionFunction.apply(q, k, v, bias, cos_raw, sin_raw,
                                            scale)
    bias, cos, sin = prepare_pe(h, n, q.device, bias, freqs_cis, poly, rel)
    return attention_fwd(q, k, v, scale, bias, cos, sin)


def _dense_bias(h, n, device, bias=None, poly=None, rel=None):
    """The one materialized bias of bias / poly / rel: a contiguous f32
    [H, N, N] tensor (differentiable in the coefficients / table) or None."""
    if sum(x is not None for x in (bias, poly, rel)) > 1:
        raise ValueError("bias/poly/rel are mutually exclusive")
    if poly is not None:
        coeff_hk, grid = poly
        bias = _poly_bias_cols(coeff_hk, int(grid), n, 0, n,
                               coeff_hk.shape[1] - 1)
    elif rel is not None:
        bias = _rel_bias_cols(rel, n, 0, n)
    if bias is None:
        return None
    return bias.to(device=device, dtype=torch.float32).contiguous()


def _kernel_freqs(freqs_cis, h, n, device):
    """(cos, sin) [S|H,S, D/2] -> contiguous f32 [1|H, N, D/2] tables with
    the cls identity row."""
    cos, sin = _prep_freqs(freqs_cis, h, n, torch.float32, broadcast=False)
    return cos.to(device).contiguous(), sin.to(device).contiguous()


def prepare_pe(h, n, device, bias=None, freqs_cis=None, poly=None, rel=None):
    """flash_attention's PE arguments -> the kernels' (bias, cos, sin): a
    contiguous f32 [H, N, N] bias (materialized from poly / rel) and
    contiguous f32 [1|H, N, D/2] rope tables with the cls identity row."""
    bias = _dense_bias(h, n, device, bias, poly, rel)
    cos = sin = None
    if freqs_cis is not None:
        cos, sin = _kernel_freqs(freqs_cis, h, n, device)
    return bias, cos, sin
