"""Fused attention, forward and backward, with in-kernel rope, on
hand-written CUDA kernels — the port of the JAX package's Pallas attention
kernels and the functions that launch them, with the `jax.custom_vjp`
around them as `torch.autograd.Function`s. Two routes, chosen as the JAX
package chooses them (`STREAMING_THRESHOLD`, `_dense_attn_fits`):

* dense (`_attn_kernel` / `_dense_bwd_kernel`, launched by `_forward` /
  `_bwd_dense`): ops/csrc/attn_fwd.cu, attn_bwd.cu, in two routes chosen
  by `dense_resident`: resident, one CTA per (batch, head) holding the
  whole head in shared memory, a single-pass forward and a single-launch
  backward (plus a slab sum for dbias), for every dense shape of the
  repo's models (N <= 208); wide, CTAs per 64-row tile, for the rest;
* streaming, an online softmax over key tiles that saves the per-row
  logsumexp (`_stream_kernel`, launched by `_forward_streaming_impl`):
  ops/csrc/attn_stream_fwd.cu, whose second entry runs q rows against one
  key chunk at global offsets (`streaming_chunk_fwd`, the forward of the
  bounded train step); both entries follow a prologue that rounds the keys
  and values to bf16 once per call (`attention_stream_fwd_prologue`). Its
  backward is one pass that computes dq, dk, dv and the gradient of a
  generated bias' parameters from one sweep over the logits
  (`_stream_bwd_fused_kernel`, launched by
  `_bwd_streaming_fused`, over key segments by `_bwd_fused_segmented`, on a
  key chunk at global offsets by `streaming_chunk_bwd`):
  ops/csrc/attn_stream_bwd_fused.cu, after a prologue that rounds the
  operands to bf16 once per call (`attention_stream_bwd_fused_prologue`);
  or, with a materialized bias (dbias) or
  learnable rope frequencies (dqr/dkr), separate dq, dk/dv and dbias passes
  (`_stream_bwd_dq_kernel`, `_stream_bwd_dkv_kernel`,
  `_stream_bwd_dbias_kernel`, launched by `_bwd_streaming`, whose direct
  callers also get the generated bias' parameter gradient from
  `_stream_bwd_dcoeff_kernel` / `_stream_bwd_dtable_kernel`):
  ops/csrc/attn_stream_bwd.cu and attn_stream_bwd_fused.cu. There dbias
  comes from the dq pass, which forms ds anyway (per-batch f32 slabs summed
  in batch order, within DBIAS_SCRATCH_BYTES), not from a pass of its own.

What is computed, for q, k, v [B, H, N, D]:

* rope (axial / mixed): q and k are rotated in float32 with the half-split
  convention; the cos/sin tables carry an IDENTITY row for the cls token
  (cos=1, sin=0), so one uniform rotation leaves token 0 unrotated
  (`_prep_freqs`);
* bias (relative / polynomial): an optional materialized [H, N, N] float32
  bias added to the scaled logits (`_poly_bias_cols` / `_rel_bias_cols`
  build it from the coefficients / table); the streaming kernels can also
  GENERATE it per element from the coefficients or the table, so that no
  [H, N, N] tensor exists above the streaming threshold;
* products: operands rounded to bfloat16, accumulated in float32 — the
  JAX kernels' regime; softmax statistics in float32. The dense forward
  rounds p = exp(s - max) to bfloat16 against the FINAL row max and divides
  by the row sum after the PV product; the streaming forward rounds p
  against the RUNNING max of the key tiles seen so far, so its result
  depends on the tile width (the twins take it as an argument). The dense
  backward normalizes p before rounding it; the streaming backward forms
  p = exp(s - lse) from the forward's logsumexp and recomputes no max;
* outputs in the input dtype; the backward's dbias and rotated-space
  dqr/dkr, and the streaming forward's lse [B, H, N], in float32.

`attention_fwd` / `attention_bwd` / `attention_stream_fwd_prologue` /
`attention_stream_fwd` / `streaming_chunk_fwd` /
`attention_stream_bwd_prologue` /
`attention_stream_bwd` / `attention_stream_bwd_fused_prologue` /
`attention_stream_bwd_fused` are the kernels'
wrappers: on a CUDA tensor they launch the kernel (and count the launch in
LAUNCHES / LAUNCHES_BWD, with the dense route's own count in
LAUNCHES_RESIDENT or LAUNCHES_WIDE / LAUNCHES_BWD_RESIDENT or
LAUNCHES_BWD_WIDE, / LAUNCHES_STREAM_FWD_PROLOGUE / LAUNCHES_STREAM_FWD /
LAUNCHES_STREAM_CHUNK_FWD / LAUNCHES_STREAM_PROLOGUE / LAUNCHES_STREAM_DQ,
LAUNCHES_STREAM_DKV, LAUNCHES_STREAM_DBIAS, LAUNCHES_STREAM_DCOEFF and
LAUNCHES_STREAM_DTABLE / LAUNCHES_STREAM_FUSED_PROLOGUE /
LAUNCHES_STREAM_FUSED, each where its kernel is
launched), on a CPU tensor they run `attention_plain` /
`attention_bwd_plain` / `attention_stream_fwd_prologue_plain` /
`attention_stream_plain` (on a whole sequence or a key chunk) /
`attention_stream_bwd_prologue_plain` /
`attention_stream_bwd_plain` / `attention_stream_bwd_fused_prologue_plain`
/ `attention_stream_bwd_fused_plain`, the
kernels' plain PyTorch twins. Nothing falls back: a CUDA call the kernel
cannot take raises.

`flash_attention` takes the route's autograd Function when grad is enabled
and an input requires it, and calls the forward wrapper directly otherwise.
On the dense route the gradient of a bias built from polynomial coefficients
or a relative table flows from dbias through torch autograd of the bias
generator; on the streaming route the one-pass kernel sums it per element
(no [H, N, N] tensor). Learnable rope-mixed frequencies get theirs from
dqr/dkr (`_rot_grads_to_dfreqs`). The streaming route takes the one-pass
backward where the JAX package's `_bwd` does: without a materialized bias
and without learnable frequencies (none, absolute, rope-axial, a generated
polynomial or relative bias), at any sequence length.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build

LANE = 128
NEG_INF = -1e30

# Sequences longer than this take the streaming kernels.
STREAMING_THRESHOLD = 2048

# Launches of the CUDA kernel since the count was last reset (plain int:
# a run shows that its main path went through the kernel by reading it).
LAUNCHES = 0

# Launches of the backward kernel (one per attention_bwd call on CUDA).
LAUNCHES_BWD = 0

# The dense wrappers' launches by route (each also counted in LAUNCHES /
# LAUNCHES_BWD): the resident kernels and the wide ones.
LAUNCHES_RESIDENT = 0
LAUNCHES_WIDE = 0
LAUNCHES_BWD_RESIDENT = 0
LAUNCHES_BWD_WIDE = 0

# Launches of the streaming kernels: the forward, the separate passes'
# prologue, the dq kernel, the dk/dv kernel, each counted where it is
# launched, and dbias: the dq kernel's dbias instance (counted in
# LAUNCHES_STREAM_DQ too) with its sum kernel.
LAUNCHES_STREAM_FWD = 0
LAUNCHES_STREAM_PROLOGUE = 0
LAUNCHES_STREAM_DQ = 0
LAUNCHES_STREAM_DKV = 0
LAUNCHES_STREAM_DBIAS = 0

# Launches of the streaming forward on a key chunk at global offsets (the
# bounded train step's forward), and of the forward's prologue (one before
# every whole-sequence and every chunk launch).
LAUNCHES_STREAM_CHUNK_FWD = 0
LAUNCHES_STREAM_FWD_PROLOGUE = 0

# Launches of the one-pass streaming backward (one per key segment), of its
# prologue (one before every one-pass launch) and of the separate-pass
# coefficient / table gradient kernels.
LAUNCHES_STREAM_FUSED = 0
LAUNCHES_STREAM_FUSED_PROLOGUE = 0
LAUNCHES_STREAM_DCOEFF = 0
LAUNCHES_STREAM_DTABLE = 0

# Key-tile widths of the streaming route: the JAX package's (the twins'
# default, so that the CPU path rounds p where the JAX kernel does) and the
# CUDA kernels' (what a twin is given when a kernel is held to it).
KV_TILE = 512
STREAM_TILE = 64
# Polynomial terms (degree + 1) the CUDA kernels take: the JAX package's LANE
# coefficient lanes. The first REG_POLY_TERMS live in registers; the one-pass
# backward's per-CTA partial sums come in groups of that many
# (csrc/attn_stream.cuh).
MAX_POLY_TERMS = LANE
REG_POLY_TERMS = 8
# Tiles of the one-pass backward's twin on the CPU path: the JAX package's.
# (p = exp(s - lse) needs no running max, so here the tiles change only the
# order of the float32 sums.)
FUSED_Q_TILE = 256
# The one-pass kernel's CTAs own 128 keys each (STREAM_BWD_ROWS) and run in
# thread-block clusters of FUSED_CLUSTER along the keys; each cluster keeps
# its share of dq in an f32 slab of the size of dq. Its wrapper sweeps the
# keys in segments that keep these slabs within the budget
# (csrc/attn_stream_bwd_fused.cu's CLUSTER is FUSED_CLUSTER).
FUSED_CLUSTER = 4
FUSED_SCRATCH_BYTES = 1 << 30
# The separate-pass backward's dq kernel writes each batch's float32 ds into
# an [H, N, dbias_pitch(N)] slab for dbias, summed afterwards in batch order;
# above this budget it writes fewer slabs, each CTA adding several batches in
# order.
DBIAS_SCRATCH_BYTES = 1 << 30
# Query rows of one dq CTA and keys of one dk/dv CTA of the separate passes
# (csrc/attn_stream_bwd.cu): their prologue's bf16 operands are padded with
# zero rows to a multiple of it.
STREAM_BWD_ROWS = 128

SOURCE = cuda_build.CSRC / "attn_fwd.cu"
BWD_SOURCE = cuda_build.CSRC / "attn_bwd.cu"
STREAM_SOURCE = cuda_build.CSRC / "attn_stream_fwd.cu"
STREAM_BWD_SOURCE = cuda_build.CSRC / "attn_stream_bwd.cu"
STREAM_FUSED_SOURCE = cuda_build.CSRC / "attn_stream_bwd_fused.cu"
HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are instantiated for


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pad_seq(x, n_pad: int, axis: int):
    """Zero-pad `axis` of x up to n_pad entries."""
    pad = n_pad - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return torch.nn.functional.pad(x, widths)


class HeadPad:
    """Zero-padding of the head dim D up to the next head dim the kernels are
    built for (HEAD_DIMS), so that every D the JAX package trains runs on
    them. scale is passed explicitly, so zero columns change neither the
    logits nor the output; their gradients come back as zeros and are cut
    off. With rope (halves=True) each half is padded on its own,
    [x1 | 0 | x2 | 0], since the rotation pairs column i with i + D/2, and
    the cos / sin tables are padded with 1 / 0. lse and delta do not change.
    Padding copies q, k, v (which are strided views of the qkv product) and
    the other [.., D] operands into new contiguous tensors: one extra read
    and write of each per call."""

    def __init__(self, d: int, halves: bool):
        built = [hd for hd in HEAD_DIMS if hd >= d]
        if not built:
            raise ValueError(f"the attention kernels are built for head dims "
                             f"up to {HEAD_DIMS[-1]}; got {d}")
        self.d, self.d_pad, self.halves = d, built[0], halves

    @classmethod
    def needed(cls, q, cos=None):
        """A HeadPad for q's head dim, or None where the kernels take it."""
        d = q.shape[-1]
        return None if d in HEAD_DIMS else cls(d, cos is not None)

    def pad(self, x):
        """[..., D] -> [..., D'] (None passes through)."""
        if x is None:
            return None
        if not self.halves:
            return torch.nn.functional.pad(x, (0, self.d_pad - self.d))
        h, hp = self.d // 2, self.d_pad // 2
        z = x.new_zeros(x.shape[:-1] + (hp - h,))
        return torch.cat([x[..., :h], z, x[..., h:], z], dim=-1)

    def unpad(self, x):
        """[..., D'] -> [..., D] (a view without halves; None passes
        through)."""
        if x is None:
            return None
        if not self.halves:
            return x[..., :self.d]
        h, hp = self.d // 2, self.d_pad // 2
        return torch.cat([x[..., :h], x[..., hp:hp + h]], dim=-1)

    def tables(self, cos, sin):
        """cos / sin [.., D/2] padded with 1 / 0 to [.., D'/2]."""
        if cos is None:
            return None, None
        widths = (0, (self.d_pad - self.d) // 2)
        return (torch.nn.functional.pad(cos, widths, value=1.0).contiguous(),
                torch.nn.functional.pad(sin, widths).contiguous())


def _dense_attn_fits(h: int, n: int, has_bias: bool) -> bool:
    """The JAX package's routing predicate between its dense and streaming
    kernels (a TPU VMEM budget), kept so both packages route the same
    shapes the same way."""
    nq = _round_up(n, 8)
    nk = _round_up(n, LANE)
    tiles = (4 + (1 if has_bias else 0)) * h * nq * nk * 4
    return tiles <= 12 * 1024 * 1024


def use_dense(h: int, n: int, has_bias: bool) -> bool:
    """Whether attention over n tokens takes the dense kernels (else the
    streaming ones), as the JAX package routes it."""
    return n <= STREAMING_THRESHOLD and _dense_attn_fits(h, n, has_bias)


# The resident dense kernels (csrc/attn_dense.cuh): a CTA of ceil(N/16)
# warps holds one (batch, head). Each thread keeps 8 f32 scores per 16-key
# block in registers beside about RESIDENT_OTHER_REGS others (the forward's
# count at 13 blocks, from the -Xptxas -v report), within the register
# file's 65,536 over the CTA's threads rounded up to 4 warps (at most 255 a
# thread); 13 blocks (N <= 208) is the most that fits, and the kernels are
# built for buckets of up to 5 and up to 13 blocks. The backward stages
# four bf16 [N_pad, D + 8] tiles and three f32 [N_pad] row vectors, the
# forward three tiles, within the 232,448 bytes of shared memory a CTA can
# have.
RESIDENT_OTHER_REGS = 24
SMEM_BYTES = 232448


def _resident_regs(kb: int) -> int:
    """Registers a thread of a CTA of kb warps can have."""
    return min(255, 65536 // _round_up(32 * kb, 128))


def _resident_max_blocks() -> int:
    return max(kb for kb in range(1, 65)
               if 8 * kb + RESIDENT_OTHER_REGS <= _resident_regs(kb))


RESIDENT_MAX_BLOCKS = _resident_max_blocks()


def resident_smem_bytes(n: int, d: int, backward: bool) -> int:
    """Shared memory of a resident kernel's CTA at n tokens, head dim d."""
    n_pad = _round_up(n, 16)
    tiles = (4 if backward else 3) * n_pad * (d + 8) * 2
    return tiles + (3 * n_pad * 4 if backward else 0)


@functools.lru_cache(maxsize=None)
def dense_resident(h: int, n: int, d: int, has_bias: bool) -> bool:
    """Whether a dense attention call over n tokens at the built head dim d
    takes the resident kernels (else the wide ones): a dense shape
    (`use_dense`) whose blocks fit the registers and whose backward fits
    the shared memory. A bias changes neither."""
    return (use_dense(h, n, has_bias) and d in HEAD_DIMS
            and -(-n // 16) <= RESIDENT_MAX_BLOCKS
            and resident_smem_bytes(n, d, backward=True) <= SMEM_BYTES)


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


def _poly_dist(rows, cols, grid):
    """[rows, cols] float32 L1 distance between the patch coordinates
    ((t-1) % grid, (t-1) // grid) of token rows and token columns."""
    xq, yq = (rows - 1) % grid, torch.div(rows - 1, grid, rounding_mode="floor")
    xk, yk = (cols - 1) % grid, torch.div(cols - 1, grid, rounding_mode="floor")
    return ((xq[:, None] - xk[None, :]).abs()
            + (yq[:, None] - yk[None, :]).abs()).float()


def _poly_bias_cols(coeff_hk, grid, n_rows, start, width, degree,
                    row_start=0, n_valid=None):
    """[H, n_rows, width] polynomial bias for token rows
    [row_start, row_start+n_rows) against token columns [start, start+width);
    zero on the cls row/col (and, with n_valid, on padded indices)."""
    device = coeff_hk.device
    rows = row_start + torch.arange(n_rows, device=device)
    cols = start + torch.arange(width, device=device)
    dist = _poly_dist(rows, cols, grid)
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
# The streaming route's plain twins
# ---------------------------------------------------------------------------

def _check_rel_covers(rel, n):
    """The generated relative bias indexes its table per element; a table
    that covers fewer tokens than the sequence would be read out of range."""
    if rel is not None and n > (rel.shape[1] + 1) // 2:
        raise ValueError(f"relative table covers L={(rel.shape[1] + 1) // 2} "
                         f"tokens < sequence {n}")


def _bias_cols(n, start, width, bias=None, poly=None, rel=None, row0=0,
               n_valid=None):
    """[H, N, width] float32 bias of the N query rows from global token row0
    against the key columns [start, start+width): a slice of the materialized
    bias, or generated from poly=(coeff_hk, grid) / the rel table, with
    n_valid (default N) the global token count; None without any."""
    if bias is not None:
        return bias[:, :, start:start + width]
    if poly is not None:
        coeff_hk, grid = poly
        return _poly_bias_cols(coeff_hk, int(grid), n, start, width,
                               coeff_hk.shape[1] - 1, row_start=row0,
                               n_valid=n if n_valid is None else n_valid)
    if rel is not None:
        return _rel_bias_cols(rel, n, start, width, row_start=row0)
    return None


def _rotated_operands(q, k, cos, sin, mm_dtype):
    """q and k rotated in float32 and rounded to the product dtype."""
    qf, kf = q.float(), k.float()
    if cos is not None:
        qf = _rotate(qf, cos[None], sin[None])
        kf = _rotate(kf, cos[None], sin[None])
    return qf.to(mm_dtype).float(), kf.to(mm_dtype).float()


def attention_stream_plain(q, k, v, scale, bias=None, cos=None, sin=None,
                           poly=None, rel=None, kv_tile=KV_TILE,
                           mm_dtype=torch.bfloat16, row0=0, col0=0,
                           n_valid=None):
    """The streaming forward kernel's function in plain PyTorch, on unpadded
    tensors: an online softmax over key tiles of `kv_tile`, p rounded
    against the running max. Arguments as attention_plain, plus the
    generated biases poly=(coeff_hk [H, deg+1], grid) and rel [H, 2L-1].
    Returns (out [B, H, N, D] in the input dtype, lse [B, H, N] float32).

    On a key chunk (the JAX package's `streaming_chunk_fwd`): k, v
    [B, H, Nc, D] whose first key is global token col0, q's first row global
    token row0, keys at global indices >= n_valid (default N) masked, poly /
    rel generated at the global indices; out is then normalized within the
    chunk and lse is the chunk's. A chunk takes no bias and no rope tables
    (the caller rotates q and k)."""
    n, nk = q.shape[2], k.shape[2]
    n_valid = n if n_valid is None else int(n_valid)
    if (nk != n or row0 or col0 or n_valid != n) and (
            bias is not None or cos is not None):
        raise ValueError("a key chunk takes the generated biases only: no "
                         "materialized bias, no rope tables")
    qm, km = _rotated_operands(q, k, cos, sin, mm_dtype)
    vm = v.to(mm_dtype).float()
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for start in range(0, nk, kv_tile):
        kt = km[:, :, start:start + kv_tile]
        s = torch.matmul(qm, kt.transpose(-1, -2)) * scale
        cols = _bias_cols(n, col0 + start, kt.shape[2], bias, poly, rel,
                          row0=row0, n_valid=n_valid)
        if cols is not None:
            s = s + cols[None]
        if col0 + start + kt.shape[2] > n_valid:
            keys = col0 + start + torch.arange(kt.shape[2], device=q.device)
            s = torch.where(keys < n_valid, s,
                            torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.matmul(p.to(mm_dtype).float(),
                          vm[:, :, start:start + kv_tile])
        acc = acc * corr[..., None] + pv
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def streaming_lse(q, k, scale, bias=None, cos=None, sin=None, poly=None,
                  rel=None):
    """Per-row logsumexp [B, H, N] recomputed over key tiles with float32
    products (the JAX package's `_streaming_lse`): what
    attention_stream_bwd uses when a direct caller has no saved lse."""
    n = q.shape[2]
    qf, kf = _rotated_operands(q, k, cos, sin, torch.float32)
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for start in range(0, n, KV_TILE):
        kt = kf[:, :, start:start + KV_TILE]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        cols = _bias_cols(n, start, kt.shape[2], bias, poly, rel)
        if cols is not None:
            s = s + cols[None]
        m_new = torch.maximum(m, s.amax(dim=-1))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
    return m + torch.log(l)


def attention_stream_bwd_plain(q, k, v, out, g, lse, scale, bias=None,
                               cos=None, sin=None, poly=None, rel=None,
                               kv_tile=KV_TILE, mm_dtype=torch.bfloat16,
                               want_dbias=False, want_drot=False,
                               want_dparam=False):
    """The streaming backward kernels' function in plain PyTorch, on
    unpadded tensors, over key tiles of `kv_tile` (nothing [N, N] is held):
    p = exp(s - lse) from the forward's lse, the rounding points of the
    module docstring. Arguments as attention_bwd_plain, plus lse [B, H, N]
    float32 and the generated biases of attention_stream_plain. Returns
    (dq, dk, dv, dbias, dqr, dkr, dcoeff, dtable): the first six as
    attention_bwd_plain; with want_dparam, the gradient of the generated
    bias' parameters from the float32 ds, dcoeff [H, deg+1] float32 for
    poly= or dtable [H, 2L-1] float32 for rel= (else None)."""
    n = q.shape[2]
    dcoeff, dtable = _dparam_zeros(poly if want_dparam else None,
                                   rel if want_dparam else None, q.device)
    rows = torch.arange(n, device=q.device)
    qm, km = _rotated_operands(q, k, cos, sin, mm_dtype)
    vm = v.to(mm_dtype).float()
    gf = g.float()
    gm = gf.to(mm_dtype).float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(dq)
    dbias = None
    if want_dbias:
        dbias = torch.empty(bias.shape, dtype=torch.float32, device=q.device)
    for start in range(0, n, kv_tile):
        tile = slice(start, start + kv_tile)
        kt, vt = km[:, :, tile], vm[:, :, tile]
        s = torch.matmul(qm, kt.transpose(-1, -2)) * scale
        cols = _bias_cols(n, start, kt.shape[2], bias, poly, rel)
        if cols is not None:
            s = s + cols[None]
        p = torch.exp(s - lse[..., None])
        gv = torch.matmul(gm, vt.transpose(-1, -2))
        ds = p * (gv - delta)
        dsm = ds.to(mm_dtype).float()
        dq = dq + scale * torch.matmul(dsm, kt)
        dk[:, :, tile] = scale * torch.matmul(dsm.transpose(-1, -2), qm)
        dv[:, :, tile] = torch.matmul(p.to(mm_dtype).float().transpose(-1, -2),
                                      gm)
        if want_dbias:
            dbias[:, :, tile] = ds.sum(dim=0)
        if want_dparam:
            cols = torch.arange(start, start + kt.shape[2], device=q.device)
            _add_dparam(dcoeff, dtable, ds, rows, cols, cols < n, n, poly)
    dqr, dkr = (dq, dk) if want_drot else (None, None)
    if cos is not None:  # inverse rotation back to unrotated space
        dq = _rotate(dq, cos[None], -sin[None])
        dk = _rotate(dk, cos[None], -sin[None])
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias, dqr, dkr,
            dcoeff, dtable)


def stream_fwd_rows(nk):
    """Rows of the streaming forward's key / value scratch for NK keys: NK
    rounded up to the kernel's key tile STREAM_TILE (its loop reads whole
    tiles; the rows past NK are zero)."""
    return _round_up(nk, STREAM_TILE)


def attention_stream_fwd_prologue_plain(k, v, cos=None, sin=None):
    """The streaming forward's prologue kernel in plain PyTorch: ops
    [2, B, H, stream_fwd_rows(NK), D] bfloat16 holding kf =
    bf16(rotate(k)) (rotation in float32) and bf16(v), zero rows past NK."""
    b, h, nk, d = k.shape
    kf = k.float()
    if cos is not None:
        kf = _rotate(kf, cos[None], sin[None])
    ops = torch.zeros((2, b, h, stream_fwd_rows(nk), d), dtype=torch.bfloat16,
                      device=k.device)
    ops[0, :, :, :nk] = kf.to(torch.bfloat16)
    ops[1, :, :, :nk] = v.to(torch.bfloat16)
    return ops


def stream_bwd_rows(n):
    """Rows of the separate passes' operand scratch for N tokens: N
    rounded up to STREAM_BWD_ROWS."""
    return _round_up(n, STREAM_BWD_ROWS)


def dbias_pitch(n):
    """Row pitch (floats) of the separate passes' padded bias and dbias
    slabs: N rounded up to 4, so that rows are whole 16-byte pieces."""
    return _round_up(n, 4)


def attention_stream_bwd_prologue_plain(q, k, v, out, g, cos=None, sin=None):
    """The separate passes' prologue kernel in plain PyTorch: (ops, delta)
    with ops [4, B, H, stream_bwd_rows(N), D] bfloat16 holding qf, kf =
    bf16(rotate(q)), bf16(rotate(k)) (rotation in float32), bf16(v) and
    bf16(g), zero rows past N, and delta = sum_d g * out [B, H, N]
    float32."""
    b, h, n, d = q.shape
    qm, km = _rotated_operands(q, k, cos, sin, torch.bfloat16)
    ops = torch.zeros((4, b, h, stream_bwd_rows(n), d), dtype=torch.bfloat16,
                      device=q.device)
    for i, x in enumerate((qm, km, v, g)):
        ops[i, :, :, :n] = x.to(torch.bfloat16)
    return ops, (g.float() * out.float()).sum(dim=-1)


def fused_slabs(nk):
    """dq slabs of one one-pass launch over nk keys: one per thread-block
    cluster of FUSED_CLUSTER CTAs of STREAM_BWD_ROWS keys."""
    return -(-nk // (STREAM_BWD_ROWS * FUSED_CLUSTER))


def fused_scratch_shapes(b, h, n, nk, d):
    """The one-pass kernel's scratch as its C entry lays it out, for n query
    rows against nk keys: (the f32 dq slabs [fused_slabs(nk), B, H,
    stream_bwd_rows(n), D], the bf16 operands [B * H * (2 *
    stream_bwd_rows(n) + 2 * stream_bwd_rows(nk)) * D]: qf, kf, bf16 v,
    bf16 g, each a [B, H, rows, D] block)."""
    nqp, nkp = stream_bwd_rows(n), stream_bwd_rows(nk)
    return ((fused_slabs(nk), b, h, nqp, d),
            (b * h * (2 * nqp + 2 * nkp) * d,))


def _fused_operands(ops, b, h, n, nk, d):
    """(qf, kf, bf16 v, bf16 g) [B, H, rows, D] views of the flat bf16
    operands of fused_scratch_shapes."""
    nqp, nkp = stream_bwd_rows(n), stream_bwd_rows(nk)
    sizes = [b * h * r * d for r in (nqp, nkp, nkp, nqp)]
    return tuple(x.view(b, h, -1, d) for x in ops.split(sizes))


def attention_stream_bwd_fused_prologue_plain(q, k, v, g, cos=None,
                                              sin=None):
    """The one-pass backward's prologue kernel in plain PyTorch: (qf, kf,
    bf16 v, bf16 g) bfloat16 [B, H, rows, D], qf, kf = bf16(rotate(q)),
    bf16(rotate(k)) (rotation in float32; whole sequences only), rows
    stream_bwd_rows(N) for q and g, stream_bwd_rows(NK) for k and v, zero
    past N / NK."""
    b, h, n, d = q.shape
    nk = k.shape[2]
    qm, km = _rotated_operands(q, k, cos, sin, torch.bfloat16)
    ops = torch.zeros(fused_scratch_shapes(b, h, n, nk, d)[1],
                      dtype=torch.bfloat16, device=q.device)
    parts = _fused_operands(ops, b, h, n, nk, d)
    for part, x in zip(parts, (qm, km, v, g)):
        part[:, :, :x.shape[2]] = x.to(torch.bfloat16)
    return parts


def _dparam_zeros(poly, rel, device):
    """Zeroed float32 (dcoeff, dtable) for the generated bias given."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(poly[0].shape, **f32) if poly is not None else None,
            torch.zeros(rel.shape, **f32) if rel is not None else None)


def _add_dparam(dcoeff, dtable, ds, rows, cols, kmask, n_valid, poly):
    """Add one tile's share of the generated bias' parameter gradient, in
    place: ds [B, H, rows, cols] float32 at GLOBAL token rows / cols, kmask
    the keys that were not masked. dcoeff[h, m] gets the sum of ds * dist^m
    over patch tokens against patch tokens below n_valid; dtable[h, row -
    col + L - 1] the sum of ds over rows below n_valid and unmasked keys."""
    if dcoeff is not None:
        valid = ((rows[:, None] > 0) & (cols[None, :] > 0)
                 & (rows[:, None] < n_valid) & (cols[None, :] < n_valid))
        dsz = torch.where(valid, ds, torch.zeros((), device=ds.device)).sum(0)
        dist = _poly_dist(rows, cols, int(poly[1]))
        pw = torch.ones_like(dist)
        for m in range(dcoeff.shape[1]):
            dcoeff[:, m] += (dsz * pw).sum(dim=(1, 2))
            pw = pw * dist
    if dtable is not None:
        valid = (rows[:, None] < n_valid) & kmask[None, :]
        dsz = torch.where(valid, ds, torch.zeros((), device=ds.device)).sum(0)
        ell = (dtable.shape[1] + 1) // 2
        idx = (rows[:, None] - cols[None, :] + ell - 1).clamp(
            0, dtable.shape[1] - 1)
        dtable.index_add_(1, idx.reshape(-1), dsz.reshape(dsz.shape[0], -1))


def attention_stream_bwd_fused_plain(q, k, v, g, lse, delta, scale, cos=None,
                                     sin=None, poly=None, rel=None,
                                     q_tile=FUSED_Q_TILE, kv_tile=KV_TILE,
                                     n_valid=None, row0=0, col0=0,
                                     chunk_cols=None, mm_dtype=torch.bfloat16):
    """The one-pass streaming backward kernel's function in plain PyTorch,
    on unpadded tensors, over (q_tile, kv_tile) tiles: s, p and ds of a tile
    are formed once and feed dq, dk, dv and the generated bias' parameter
    gradient.

    q, g [B, H, N, D]; k, v [B, H, Nc, D], a key chunk whose first key is
    global token col0 (q's first row is global token row0); lse and delta =
    sum_d g * out [B, H, N] float32, of the whole softmax row. Keys at
    global indices >= n_valid (default N) or at local indices >= chunk_cols
    are masked. cos/sin [1|H, N, D/2] rotate q and k (whole sequences only:
    Nc == N, no offsets). Rounding as the JAX kernel: q, k rotated in float32
    then rounded to mm_dtype, p and ds rounded to mm_dtype before the three
    gradient products, the parameter sums from the float32 ds.
    Returns (dq, dk, dv, dcoeff, dtable) in float32; dcoeff [H, deg+1] with
    poly=, dtable [H, 2L-1] with rel=, else None."""
    n, nc = q.shape[2], k.shape[2]
    n_valid = n if n_valid is None else int(n_valid)
    if cos is not None and (nc != n or row0 or col0):
        raise ValueError("rope tables rotate whole sequences: the keys must "
                         "be q's own, at offsets (0, 0)")
    width = nc if chunk_cols is None else min(nc, int(chunk_cols))
    qm, km = _rotated_operands(q, k, cos, sin, mm_dtype)
    vm = v.to(mm_dtype).float()
    gm = g.float().to(mm_dtype).float()
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, **f32)
    dk, dv = torch.zeros(k.shape, **f32), torch.zeros(k.shape, **f32)
    dcoeff, dtable = _dparam_zeros(poly, rel, q.device)
    for qs in range(0, n, q_tile):
        qt = slice(qs, min(qs + q_tile, n))
        rows = row0 + torch.arange(qt.start, qt.stop, device=q.device)
        for ks in range(0, nc, kv_tile):
            kt = slice(ks, min(ks + kv_tile, nc))
            cols_l = torch.arange(kt.start, kt.stop, device=q.device)
            cols = col0 + cols_l
            kmask = (cols < n_valid) & (cols_l < width)
            s = torch.matmul(qm[:, :, qt], km[:, :, kt].transpose(-1, -2)) \
                * scale
            if poly is not None:
                s = s + _poly_bias_cols(
                    poly[0], int(poly[1]), len(rows), col0 + ks, len(cols),
                    poly[0].shape[1] - 1, row_start=row0 + qs,
                    n_valid=n_valid)[None]
            if rel is not None:
                s = s + _rel_bias_cols(rel, len(rows), col0 + ks, len(cols),
                                       row_start=row0 + qs)[None]
            s = torch.where(kmask, s, torch.full((), NEG_INF, **f32))
            p = torch.exp(s - lse[:, :, qt, None])
            gv = torch.matmul(gm[:, :, qt], vm[:, :, kt].transpose(-1, -2))
            ds = p * (gv - delta[:, :, qt, None])
            dsm = ds.to(mm_dtype).float()
            dv[:, :, kt] += torch.matmul(
                p.to(mm_dtype).float().transpose(-1, -2), gm[:, :, qt])
            dk[:, :, kt] += scale * torch.matmul(dsm.transpose(-1, -2),
                                                 qm[:, :, qt])
            dq[:, :, qt] += scale * torch.matmul(dsm, km[:, :, kt])
            _add_dparam(dcoeff, dtable, ds, rows, cols, kmask, n_valid, poly)
    if cos is not None:  # inverse rotation back to unrotated space
        dq = _rotate(dq, cos[None], -sin[None])
        dk = _rotate(dk, cos[None], -sin[None])
    return dq, dk, dv, dcoeff, dtable


# ---------------------------------------------------------------------------
# The CUDA kernels: bind, launch
# ---------------------------------------------------------------------------

def _bind_fwd(lib):
    for fn in (lib.attn_fwd, lib.attn_fwd_resident):
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 7                 # q k v out bias cos sin
            + [ctypes.c_int] * 6                  # B H N D is_bf16 cos_heads
            + [ctypes.POINTER(ctypes.c_longlong)]  # 12 strides
            + [ctypes.c_float, ctypes.c_void_p])  # scale stream


def _bind_bwd(lib):
    lib.attn_bwd_batch_group.restype = ctypes.c_int
    lib.attn_bwd_batch_group.argtypes = ()
    for fn in (lib.attn_bwd, lib.attn_bwd_resident):
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.POINTER(ctypes.c_void_p),     # 16 pointers
             ctypes.POINTER(ctypes.c_longlong)]   # 24 strides
            + [ctypes.c_int] * 7      # B H N D is_bf16 cos_heads groups|per
            + [ctypes.c_float, ctypes.c_void_p])  # scale stream


def _bind_stream(*names):
    def bind(lib):
        for name in names:
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p),    # pointers
                           ctypes.POINTER(ctypes.c_longlong),  # strides
                           ctypes.POINTER(ctypes.c_int),       # _stream_dims
                           ctypes.c_float, ctypes.c_void_p]    # scale stream
    return bind


def _library():
    return cuda_build.load(SOURCE, _bind_fwd)


def _bwd_library():
    return cuda_build.load(BWD_SOURCE, _bind_bwd)


def _stream_library():
    return cuda_build.load(STREAM_SOURCE, _bind_stream(
        "attn_stream_fwd_prologue", "attn_stream_fwd",
        "attn_stream_chunk_fwd"))


def _stream_bwd_library():
    return cuda_build.load(STREAM_BWD_SOURCE, _bind_stream(
        "attn_stream_bwd_prologue", "attn_stream_bwd_dq",
        "attn_stream_bwd_dkv"))


def _stream_fused_library():
    return cuda_build.load(STREAM_FUSED_SOURCE, _bind_stream(
        "attn_stream_bwd_fused", "attn_stream_bwd_fused_prologue",
        "attn_stream_bwd_dcoeff", "attn_stream_bwd_dtable"))


def _check_cuda_inputs(q, k, v, bias, cos, sin, key_chunk=False,
                       pitched=False):
    """Raise on what the attention kernels do not take. key_chunk: k and v
    may hold another number of tokens than q (the one-pass backward).
    pitched: the bias may also lie as `pitched_bias` lays it out (the
    streaming kernels)."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"attn_fwd takes float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    kv_shape = q.shape[:2] + k.shape[2:3] + q.shape[3:] if key_chunk \
        else q.shape
    if q.dim() != 4 or k.shape != kv_shape or v.shape != kv_shape:
        raise ValueError(f"q, k, v must be [B, H, N, D] of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:  # HeadPad brings every D up to 128 to one of them
        raise ValueError(f"attn_fwd is built for head dims {HEAD_DIMS}; "
                         f"got {d}")
    if min(b, h, n, k.shape[2]) < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    if bias is not None:
        laid_out = bias.is_contiguous() or (pitched and _is_pitched(bias))
        if (bias.shape != (h, n, n) or bias.dtype != torch.float32
                or not laid_out or bias.device != q.device):
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


def _is_aligned(t):
    """Whether the kernels' 16-byte loads and stores can reach t's rows: its
    base address and every stride above the last are multiples of 16
    bytes."""
    unit = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and not any(
        st % unit for st in t.stride()[:-1])


def _is_pitched(bias):
    """Whether bias [H, N, N] lies as the streaming kernels read it: rows
    dbias_pitch(N) floats apart from a 16-byte aligned base, in storage that
    also holds the last row's padding."""
    h, n, _ = bias.shape
    pitch = dbias_pitch(n)
    return (bias.stride() == (n * pitch, pitch, 1)
            and bias.data_ptr() % 16 == 0
            and (bias.storage_offset() + h * n * pitch) * bias.element_size()
            <= bias.untyped_storage().nbytes())


def pitched_bias(bias):
    """bias [H, N, N] as the streaming kernels read it (`_is_pitched`, so
    that its rows are whole 16-byte pieces): bias itself where it lies so
    already, else an [H, N, N] view of a copy zero-padded to rows of
    dbias_pitch(N) floats. StreamingAttentionFunction pads once, in its
    forward, and hands the view to both wrappers. None passes through."""
    if bias is None or _is_pitched(bias):
        return bias
    n = bias.shape[1]
    pitch = dbias_pitch(n)
    padded = (torch.nn.functional.pad(bias, (0, pitch - n)) if pitch != n
              else bias.clone(memory_format=torch.contiguous_format))
    return padded[:, :, :n]


def _aligned(t):
    """t, or a contiguous copy of it where the kernels' 16-byte loads could
    not read its rows (see _is_aligned; None passes through)."""
    if t is None or _is_aligned(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def attention_fwd(q, k, v, scale, bias=None, cos=None, sin=None):
    """The kernel's wrapper; arguments as attention_plain (bf16 products).

    CPU tensors run the plain twin. CUDA tensors launch the resident or the
    wide kernel, as `dense_resident` decides, on the current stream, or
    raise. The output is [B, H, N, D] laid out as [B, N, H, D] in memory,
    so the caller's transpose to [B, N, H*D] is a view."""
    global LAUNCHES, LAUNCHES_RESIDENT, LAUNCHES_WIDE
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, bias, cos, sin)
    hp = HeadPad.needed(q, cos)
    if hp is not None:
        return hp.unpad(attention_fwd(hp.pad(q), hp.pad(k), hp.pad(v), scale,
                                      bias, *hp.tables(cos, sin)))
    _check_cuda_inputs(q, k, v, bias, cos, sin)
    b, h, n, d = q.shape
    resident = dense_resident(h, n, d, bias is not None)
    if resident:
        q, k, v, cos, sin = map(_aligned, (q, k, v, cos, sin))
    out = torch.empty((b, n, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _library()
    launch = lib.attn_fwd_resident if resident else lib.attn_fwd
    with torch.cuda.device(q.device):
        err = launch(
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
    if resident:
        LAUNCHES_RESIDENT += 1
    else:
        LAUNCHES_WIDE += 1
    return out


def attention_bwd(q, k, v, out, g, scale, bias=None, cos=None, sin=None,
                  want_dbias=False, want_drot=False, dbias_budget=None):
    """The backward kernel's wrapper; arguments and results as
    attention_bwd_plain (bf16 products). dbias_budget: the bytes of the
    resident route's dbias slabs (default DBIAS_SCRATCH_BYTES).

    CPU tensors run the plain twin. CUDA tensors launch the resident kernel
    (with the slab sum for dbias) or the wide kernels, as `dense_resident`
    decides, on the current stream, or raise. dq, dk and dv are views of
    one [B, N, 3, H, D] buffer (the layout of the model's qkv product)."""
    global LAUNCHES_BWD, LAUNCHES_BWD_RESIDENT, LAUNCHES_BWD_WIDE
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, out, g, scale, bias, cos, sin,
                                   want_dbias=want_dbias, want_drot=want_drot)
    hp = HeadPad.needed(q, cos)
    if hp is not None:
        dq, dk, dv, dbias, dqr, dkr = attention_bwd(
            *map(hp.pad, (q, k, v, out, g)), scale, bias,
            *hp.tables(cos, sin), want_dbias=want_dbias, want_drot=want_drot,
            dbias_budget=dbias_budget)
        return (*map(hp.unpad, (dq, dk, dv)), dbias, hp.unpad(dqr),
                hp.unpad(dkr))
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
    resident = dense_resident(h, n, d, bias is not None)
    if resident:
        q, k, v, out, g, cos, sin = map(_aligned, (q, k, v, out, g, cos, sin))
    f32 = dict(dtype=torch.float32, device=q.device)
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    dqr = dkr = dbias = part = stats = None
    if want_drot:
        dqr = torch.empty((b, h, n, d), **f32)
        dkr = torch.empty((b, h, n, d), **f32)
    lib = _bwd_library()
    if resident:
        groups = 1  # batches per CTA
        if want_dbias:  # slab rows padded to 16 bytes
            slabs = dbias_groups(b, h, n, dbias_budget, _round_up(n, 4))
            groups = -(-b // slabs)
            part = torch.empty((slabs, h, n, _round_up(n, 4)), **f32)
        launch = lib.attn_bwd_resident
    else:
        stats = torch.empty((3, b, h, n), **f32)
        groups = -(-b // lib.attn_bwd_batch_group())
        if want_dbias and groups > 1:
            part = torch.empty((groups, h, n, n), **f32)
        launch = lib.attn_bwd
    if want_dbias:
        dbias = torch.empty((h, n, n), **f32)
    tensors = (q, k, v, out, g, dq, dk, dv, dqr, dkr, bias, cos, sin, stats,
               dbias, part)
    ptrs = (ctypes.c_void_p * 16)(
        *(t.data_ptr() if t is not None else None for t in tensors))
    strides = (ctypes.c_longlong * 24)(
        *(s for t in tensors[:8] for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = launch(
            ptrs, strides, b, h, n, d, int(q.dtype == torch.bfloat16),
            cos.shape[0] if cos is not None else 0, groups, float(scale),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_bwd launch failed: CUDA error {err}")
    LAUNCHES_BWD += 1
    if resident:
        LAUNCHES_BWD_RESIDENT += 1
    else:
        LAUNCHES_BWD_WIDE += 1
    return dq, dk, dv, dbias, dqr, dkr


def _check_generated(q, poly, rel):
    """The generated biases as the CUDA kernels take them: (coeff [H, terms]
    contiguous f32 or None, grid, table [H, 2L-1] contiguous f32 or None)."""
    h = q.shape[1]
    coeff, grid, table = None, 0, None
    if poly is not None:
        coeff, grid = poly
        if (coeff.dim() != 2 or coeff.shape[0] != h or int(grid) < 1
                or not 1 <= coeff.shape[1] <= MAX_POLY_TERMS):
            raise ValueError(f"poly must be (coeff [H, 1..{MAX_POLY_TERMS}], "
                             f"grid >= 1); got {tuple(coeff.shape)}, {grid}")
        coeff = coeff.detach().to(q.device, torch.float32).contiguous()
    if rel is not None:
        if rel.dim() != 2 or rel.shape[0] != h or rel.shape[1] % 2 != 1:
            raise ValueError(f"rel must be a [H, 2L-1] table; got "
                             f"{tuple(rel.shape)}")
        table = rel.detach().to(q.device, torch.float32).contiguous()
    return coeff, int(grid), table


def _stream_dims(q, cos, coeff, grid, table, groups=0, row0=0, col0=0,
                 n_valid=None, nk=None, kv_valid=None):
    """The integer arguments of the streaming kernels' C entry points, in
    the order of attn::Dim (csrc/attn_stream.cuh). By default the call covers
    the whole sequence: global offsets (0, 0), every key valid, as many keys
    as query rows."""
    b, h, n, d = q.shape
    nk = n if nk is None else nk
    return (ctypes.c_int * 15)(
        b, h, n, d, int(q.dtype == torch.bfloat16),
        cos.shape[0] if cos is not None else 0,
        coeff.shape[1] if coeff is not None else 0, grid,
        (table.shape[1] + 1) // 2 if table is not None else 0,
        row0, col0, n if n_valid is None else n_valid, groups, nk,
        nk if kv_valid is None else kv_valid)


def _pointers(*tensors):
    return (ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() if t is not None else None for t in tensors))


def _strides(*tensors):
    """The (batch, head, token) strides of each tensor (zeros for None)."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors
          for s in (t.stride()[:3] if t is not None else (0, 0, 0))))


def attention_stream_fwd_prologue(k, v, cos=None, sin=None):
    """The streaming forward's prologue kernel's wrapper: ops as
    attention_stream_fwd_prologue_plain. CPU tensors run the twin. CUDA
    tensors (at a built head dim) launch the kernel on the current stream,
    or raise. The forward wrappers launch it through their own entry
    points."""
    global LAUNCHES_STREAM_FWD_PROLOGUE
    if k.device.type == "cpu":
        return attention_stream_fwd_prologue_plain(k, v, cos, sin)
    _check_cuda_inputs(k, k, v, None, cos, sin)
    k, v = _aligned(k), _aligned(v)
    ops = _fwd_scratch(k)
    with torch.cuda.device(k.device):
        err = _stream_library().attn_stream_fwd_prologue(
            _pointers(k, k, v, None, None, None, cos, sin, None, None, ops),
            _strides(k, k, v, None), _stream_dims(k, cos, None, 0, None), 1.0,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_fwd_prologue launch failed: CUDA "
                           f"error {err}")
    LAUNCHES_STREAM_FWD_PROLOGUE += 1
    return ops


def _fwd_scratch(k):
    """The prologue's [2, B, H, stream_fwd_rows(NK), D] bf16 scratch."""
    b, h, nk, d = k.shape
    return torch.empty((2, b, h, stream_fwd_rows(nk), d), dtype=torch.bfloat16,
                       device=k.device)


def attention_stream_fwd(q, k, v, scale, bias=None, cos=None, sin=None,
                         poly=None, rel=None):
    """The streaming forward kernel's wrapper; arguments and results
    (out, lse) as attention_stream_plain (bf16 products).

    CPU tensors run the plain twin with the JAX package's key tile. CUDA
    tensors launch the prologue (as `attention_stream_fwd_prologue`: k and
    v rounded once) and the kernel (key tile STREAM_TILE) on the current
    stream, through one entry point, or raise. A bias that does not lie as
    `pitched_bias` lays it out is copied so first. out is [B, H, N, D] laid
    out as [B, N, H, D] in memory."""
    global LAUNCHES_STREAM_FWD, LAUNCHES_STREAM_FWD_PROLOGUE
    _check_rel_covers(rel, q.shape[2])
    if q.device.type == "cpu":
        return attention_stream_plain(q, k, v, scale, bias, cos, sin, poly,
                                      rel)
    hp = HeadPad.needed(q, cos)
    if hp is not None:
        out, lse = attention_stream_fwd(hp.pad(q), hp.pad(k), hp.pad(v), scale,
                                        bias, *hp.tables(cos, sin), poly, rel)
        return hp.unpad(out), lse
    _check_cuda_inputs(q, k, v, bias, cos, sin, pitched=True)
    coeff, grid, table = _check_generated(q, poly, rel)
    q, k, v = map(_aligned, (q, k, v))
    bias = pitched_bias(bias)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    ops = _fwd_scratch(k)
    with torch.cuda.device(q.device):
        err = _stream_library().attn_stream_fwd(
            _pointers(q, k, v, out, lse, bias, cos, sin, coeff, table, ops),
            _strides(q, k, v, out), _stream_dims(q, cos, coeff, grid, table),
            float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_fwd launch failed: CUDA error {err}")
    LAUNCHES_STREAM_FWD_PROLOGUE += 1
    LAUNCHES_STREAM_FWD += 1
    return out, lse


def _check_bf16_products(mm_dtype):
    if mm_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernels multiply in bfloat16; float32 "
                         "products are the plain twins' (CPU tensors)")


def streaming_chunk_fwd(q, k, v, scale, row0, col0, n_valid, poly=None,
                        rel=None, out=None, lse=None,
                        mm_dtype=torch.bfloat16):
    """One chunk's share of the streaming forward (the JAX package's
    `streaming_chunk_fwd`): q rows [B, H, Nl, D] at global rows
    [row0, row0+Nl) against one key chunk [B, H, Nc, D] at global columns
    [col0, col0+Nc), n_valid the global token count (keys at global indices
    >= n_valid are masked). The polynomial / relative bias is generated at
    the global indices; the caller rotates q and k. Returns (out_c
    [B, H, Nl, D] normalized within the chunk, lse_c [B, H, Nl] float32).
    out / lse: views to write them into (rows of longer buffers, unit last
    stride), else they are allocated.

    CPU tensors run attention_stream_plain at the JAX package's key tile for
    this chunk (min(KV_TILE, Nc rounded up to 128)), with mm_dtype products.
    CUDA tensors launch the prologue (the chunk's keys and values rounded
    once) and the kernel (key tile STREAM_TILE) on the current stream,
    through one entry point, or raise; they multiply in bfloat16 only. An
    out view that the kernel's 16-byte stores cannot reach is written
    through a copy."""
    global LAUNCHES_STREAM_CHUNK_FWD, LAUNCHES_STREAM_FWD_PROLOGUE
    b, h, nl, d = q.shape
    nc = k.shape[2]
    row0, col0, n_valid = int(row0), int(col0), int(n_valid)
    _check_rel_covers(rel, n_valid)
    if poly is not None and rel is not None:
        raise ValueError("poly and rel are mutually exclusive")
    if q.device.type == "cpu":
        got = attention_stream_plain(
            q, k, v, scale, poly=poly, rel=rel,
            kv_tile=min(KV_TILE, _round_up(nc, LANE)), mm_dtype=mm_dtype,
            row0=row0, col0=col0, n_valid=n_valid)
        return tuple(x if dst is None else dst.copy_(x)
                     for x, dst in zip(got, (out, lse)))
    _check_bf16_products(mm_dtype)
    hp = HeadPad.needed(q)
    if hp is not None:
        out_p, lse = streaming_chunk_fwd(hp.pad(q), hp.pad(k), hp.pad(v),
                                         scale, row0, col0, n_valid, poly,
                                         rel, lse=lse)
        if out is None:
            return hp.unpad(out_p), lse
        return out.copy_(hp.unpad(out_p)), lse
    _check_cuda_inputs(q, k, v, None, None, None, key_chunk=True)
    coeff, grid, table = _check_generated(q, poly, rel)
    q, k, v = map(_aligned, (q, k, v))
    if out is None:
        out = torch.empty((b, nl, h, d), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
    elif (out.shape != q.shape or out.dtype != q.dtype
          or out.device != q.device or out.stride(-1) != 1):
        raise ValueError("out must match q in shape, dtype and device, with "
                         "a unit last stride")
    if lse is None:
        lse = torch.empty((b, h, nl), dtype=torch.float32, device=q.device)
    elif (lse.shape != (b, h, nl) or lse.dtype != torch.float32
          or lse.device != q.device or lse.stride(-1) != 1):
        raise ValueError("lse must be a float32 [B, H, Nl] view on q's device "
                         "with a unit last stride")
    dst = out if _is_aligned(out) else torch.empty(q.shape, dtype=q.dtype,
                                                   device=q.device)
    strides = (ctypes.c_longlong * 14)(*_strides(q, k, v, dst),
                                       *lse.stride()[:2])
    ops = _fwd_scratch(k)
    with torch.cuda.device(q.device):
        err = _stream_library().attn_stream_chunk_fwd(
            _pointers(q, k, v, dst, lse, None, None, None, coeff, table, ops),
            strides,
            _stream_dims(q, None, coeff, grid, table, row0=row0, col0=col0,
                         n_valid=n_valid, nk=nc, kv_valid=nc),
            float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_chunk_fwd launch failed: CUDA error "
                           f"{err}")
    LAUNCHES_STREAM_FWD_PROLOGUE += 1
    LAUNCHES_STREAM_CHUNK_FWD += 1
    if dst is not out:
        out.copy_(dst)
    return out, lse


def dbias_groups(b, h, n, budget=None, width=None):
    """The batch groups of the dbias slabs: one per batch while B float32
    [H, N, width] slabs of ds (width: N by default; the separate passes and
    the resident dense backward pass their row pitch, dbias_pitch(N)) fit
    in `budget` bytes (default DBIAS_SCRATCH_BYTES), else as few groups of
    ceil(B / fitting slabs) batches as cover B (at least one). Each group's
    run of batches goes to one CTA per row tile and head, which adds them
    into its slab in order."""
    budget = DBIAS_SCRATCH_BYTES if budget is None else budget
    width = n if width is None else width
    per = -(-b // max(1, min(b, budget // (h * n * width * 4))))
    return -(-b // per)


def _stream_bwd_pointers(q, k, v, g, out, lse, delta, ops, dq=None, dk=None,
                         dv=None, dqr=None, dkr=None, bias=None, cos=None,
                         sin=None, coeff=None, table=None, dbias=None,
                         part=None):
    """The pointer and stride arguments of csrc/attn_stream_bwd.cu's C
    entry points, in their order."""
    return (_pointers(q, k, v, g, lse, delta, dq, dk, dv, dqr, dkr, bias, cos,
                      sin, coeff, table, dbias, part, out, ops),
            _strides(q, k, v, g, dq, dk, dv, out))


def _stream_bwd_inputs(q, k, v, out, g, cos, sin, bias=None):
    """Raise on what the separate passes do not take; returns q, k, v, out
    and g with rows that the prologue can read in 16-byte pieces (copies
    where needed)."""
    _check_cuda_inputs(q, k, v, bias, cos, sin, pitched=True)
    for name, t in (("out", out), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, dtype and device")
    return tuple(_aligned(t if t.stride(-1) == 1 else t.contiguous())
                 for t in (q, k, v, out, g))


def attention_stream_bwd_prologue(q, k, v, out, g, cos=None, sin=None):
    """The separate passes' prologue kernel's wrapper: (ops, delta) as
    attention_stream_bwd_prologue_plain. CPU tensors run the twin. CUDA
    tensors (at a built head dim) launch the kernel on the current stream,
    or raise."""
    if q.device.type == "cpu":
        return attention_stream_bwd_prologue_plain(q, k, v, out, g, cos, sin)
    return _prologue(*_stream_bwd_inputs(q, k, v, out, g, cos, sin), cos, sin)


def _prologue(q, k, v, out, g, cos, sin):
    """The prologue kernel launched on checked inputs: (ops, delta)."""
    global LAUNCHES_STREAM_PROLOGUE
    b, h, n, d = q.shape
    ops = torch.empty((4, b, h, stream_bwd_rows(n), d), dtype=torch.bfloat16,
                      device=q.device)
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    args = (*_stream_bwd_pointers(q, k, v, g, out, None, delta, ops, cos=cos,
                                  sin=sin),
            _stream_dims(q, cos, None, 0, None), 1.0)
    with torch.cuda.device(q.device):
        err = _stream_bwd_library().attn_stream_bwd_prologue(
            *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_bwd_prologue launch failed: CUDA "
                           f"error {err}")
    LAUNCHES_STREAM_PROLOGUE += 1
    return ops, delta


def attention_stream_bwd(q, k, v, out, g, lse, scale, bias=None, cos=None,
                         sin=None, poly=None, rel=None, want_dbias=False,
                         want_drot=False, want_dparam=False,
                         dbias_budget=None):
    """The separate-pass streaming backward's wrapper; arguments and results
    as attention_stream_bwd_plain (bf16 products). lse=None recomputes it
    (streaming_lse), for callers without the forward's.

    CPU tensors run the plain twin with the JAX package's key tile. CUDA
    tensors launch the prologue (`attention_stream_bwd_prologue`: the
    operands rounded once, and delta), the dq kernel (with want_dbias its
    dbias instance, then the sum over the batch groups' slabs,
    `dbias_groups` with `dbias_budget` at the row pitch `dbias_pitch`), the
    dk/dv kernel and, with want_dparam and poly= / rel=, the dcoeff /
    dtable kernel on the current stream, or raise. A bias that does not lie
    as `pitched_bias` lays it out (rows at that pitch) is copied so first.
    dq, dk and dv are views of one [B, N, 3, H, D] buffer."""
    global LAUNCHES_STREAM_DQ, LAUNCHES_STREAM_DKV, LAUNCHES_STREAM_DBIAS
    global LAUNCHES_STREAM_DCOEFF, LAUNCHES_STREAM_DTABLE
    _check_rel_covers(rel, q.shape[2])
    if want_dbias and bias is None:
        raise ValueError("dbias needs the bias the forward was given")
    if want_dparam and poly is None and rel is None:
        raise ValueError("a parameter gradient needs poly= or rel=")
    if lse is None:
        lse = streaming_lse(q, k, scale, bias, cos, sin, poly, rel)
    if q.device.type == "cpu":
        return attention_stream_bwd_plain(
            q, k, v, out, g, lse, scale, bias, cos, sin, poly, rel,
            want_dbias=want_dbias, want_drot=want_drot,
            want_dparam=want_dparam)
    hp = HeadPad.needed(q, cos)
    if hp is not None:
        dq, dk, dv, dbias, dqr, dkr, dcoeff, dtable = attention_stream_bwd(
            *map(hp.pad, (q, k, v, out, g)), lse, scale, bias,
            *hp.tables(cos, sin), poly, rel, want_dbias=want_dbias,
            want_drot=want_drot, want_dparam=want_dparam,
            dbias_budget=dbias_budget)
        return (*map(hp.unpad, (dq, dk, dv)), dbias, hp.unpad(dqr),
                hp.unpad(dkr), dcoeff, dtable)
    q, k, v, out, g = _stream_bwd_inputs(q, k, v, out, g, cos, sin, bias)
    coeff, grid, table = _check_generated(q, poly, rel)
    b, h, n, d = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    if lse.shape != (b, h, n) or lse.dtype != torch.float32 or \
            lse.device != q.device:
        raise ValueError("lse must be a float32 [B, H, N] tensor on q's "
                         "device")
    lse = lse.contiguous()
    ops, delta = _prologue(q, k, v, out, g, cos, sin)
    dqkv = torch.empty((b, n, 3, h, d), dtype=q.dtype, device=q.device)
    dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    dqr = dkr = dbias = part = None
    if want_drot:
        dqr = torch.empty((b, h, n, d), **f32)
        dkr = torch.empty((b, h, n, d), **f32)
    pitch = dbias_pitch(n)
    bias = pitched_bias(bias)
    groups = 0
    if want_dbias:
        groups = dbias_groups(b, h, n, dbias_budget, pitch)
        dbias = torch.empty((h, n, n), **f32)
        part = torch.empty((groups, h, n, pitch), **f32)
    lib = _stream_bwd_library()
    args = (*_stream_bwd_pointers(q, k, v, g, out, lse, delta, ops, dq, dk,
                                  dv, dqr, dkr, bias, cos, sin, coeff, table,
                                  dbias, part),
            _stream_dims(q, cos, coeff, grid, table, groups), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attn_stream_bwd_dq(*args, stream)
        if err != 0:
            raise RuntimeError(f"attn_stream_bwd_dq launch failed: CUDA "
                               f"error {err}")
        LAUNCHES_STREAM_DQ += 1
        LAUNCHES_STREAM_DBIAS += int(want_dbias)
        err = lib.attn_stream_bwd_dkv(*args, stream)
        if err != 0:
            raise RuntimeError(f"attn_stream_bwd_dkv launch failed: CUDA "
                               f"error {err}")
        LAUNCHES_STREAM_DKV += 1
        dcoeff = dtable = None
        if want_dparam:
            dparam, part = _dparam_scratch(q, n, coeff, table)
            fused_args = (  # the sweep reads the prologue's operands
                _pointers(q, k, v, g, lse, delta, None, None, None, ops,
                          dparam, part, cos, sin, coeff, table), args[1],
                _stream_dims(q, cos, coeff, grid, table), float(scale))
            if coeff is not None:
                err = _stream_fused_library().attn_stream_bwd_dcoeff(
                    *fused_args, stream)
                dcoeff = dparam
            else:
                err = _stream_fused_library().attn_stream_bwd_dtable(
                    *fused_args, stream)
                dtable = dparam
            if err != 0:
                raise RuntimeError(f"attn_stream_bwd_dcoeff / dtable launch "
                                   f"failed: CUDA error {err}")
            if coeff is not None:
                LAUNCHES_STREAM_DCOEFF += 1
            else:
                LAUNCHES_STREAM_DTABLE += 1
    return dq, dk, dv, dbias, dqr, dkr, dcoeff, dtable


def _dparam_scratch(q, nk, coeff, table):
    """(dparam, its per-CTA partial sums) as attn_stream_bwd_fused.cu lays
    them out for q's rows against nk keys (one CTA per STREAM_BWD_ROWS
    keys), or (None, None)."""
    b, h, n, _ = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    n_kt = -(-nk // STREAM_BWD_ROWS)
    if coeff is not None:
        terms = coeff.shape[1]  # poly_part_cols of csrc/attn_stream.cuh
        cols = max(REG_POLY_TERMS, _round_up(terms, REG_POLY_TERMS))
        return (torch.empty(coeff.shape, **f32),
                torch.empty((b, h, n_kt, cols), **f32))
    if table is not None:  # the diagonals of every 64-query tile
        return (torch.empty(table.shape, **f32),
                torch.empty((b, h, n_kt, _round_up(n, STREAM_TILE)
                             + STREAM_BWD_ROWS), **f32))
    return None, None


def _fused_kv_seg_cols(b, h, n, d):
    """The most keys one launch of the one-pass kernel takes: each cluster
    of FUSED_CLUSTER CTAs of STREAM_BWD_ROWS keys holds an f32
    [B, H, stream_bwd_rows(N), D] slab of dq partial sums, and the slabs of
    one launch stay within FUSED_SCRATCH_BYTES (at least one cluster)."""
    slab = b * h * stream_bwd_rows(n) * d * 4
    return (STREAM_BWD_ROWS * FUSED_CLUSTER
            * max(1, FUSED_SCRATCH_BYTES // slab))


def attention_stream_bwd_fused_prologue(q, k, v, g, cos=None, sin=None):
    """The one-pass backward's prologue kernel's wrapper: (qf, kf, bf16 v,
    bf16 g) as attention_stream_bwd_fused_prologue_plain. CPU tensors run
    the twin. CUDA tensors (at a built head dim) launch the kernel on the
    current stream, or raise. attention_stream_bwd_fused launches it through
    its own entry point."""
    global LAUNCHES_STREAM_FUSED_PROLOGUE
    if q.device.type == "cpu":
        return attention_stream_bwd_fused_prologue_plain(q, k, v, g, cos, sin)
    q, k, v, g = _fused_inputs(q, k, v, g, cos, sin)
    b, h, n, d = q.shape
    ops = torch.empty(fused_scratch_shapes(b, h, n, k.shape[2], d)[1],
                      dtype=torch.bfloat16, device=q.device)
    with torch.cuda.device(q.device):
        err = _stream_fused_library().attn_stream_bwd_fused_prologue(
            _pointers(q, k, v, g, None, None, None, None, None, ops, None,
                      None, cos, sin, None, None),
            _strides(q, k, v, g, None, None, None),
            _stream_dims(q, cos, None, 0, None, nk=k.shape[2]), 1.0,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_bwd_fused_prologue launch failed: "
                           f"CUDA error {err}")
    LAUNCHES_STREAM_FUSED_PROLOGUE += 1
    return _fused_operands(ops, b, h, n, k.shape[2], d)


def _fused_inputs(q, k, v, g, cos, sin):
    """Raise on what the one-pass kernels do not take; returns q, k, v and
    g with rows that the prologue can read in 16-byte pieces (copies where
    needed)."""
    _check_cuda_inputs(q, k, v, None, cos, sin, key_chunk=True)
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device:
        raise ValueError("g must match q in shape, dtype and device")
    return tuple(_aligned(t if t.stride(-1) == 1 else t.contiguous())
                 for t in (q, k, v, g))


def attention_stream_bwd_fused(q, k, v, g, lse, delta, scale, cos=None,
                               sin=None, poly=None, rel=None, n_valid=None,
                               row0=0, col0=0, chunk_cols=None,
                               out_dtype=torch.float32,
                               mm_dtype=torch.bfloat16):
    """The one-pass streaming backward kernel's wrapper; arguments and
    results (dq, dk, dv, dcoeff, dtable) as attention_stream_bwd_fused_plain,
    dq / dk / dv in out_dtype.

    A key extent wider than `_fused_kv_seg_cols` is swept in segments
    (`_bwd_fused_segmented`). Otherwise CPU tensors run the plain twin with
    the JAX package's tiles and mm_dtype products, and CUDA tensors launch
    the prologue (as `attention_stream_bwd_fused_prologue`: the operands
    rounded once) and the kernel (bf16 products only) on the current
    stream, through one entry point, or raise. With as many keys as query
    rows, dq, dk and dv are views of one [B, N, 3, H, D] buffer."""
    global LAUNCHES_STREAM_FUSED, LAUNCHES_STREAM_FUSED_PROLOGUE
    b, h, n, d = q.shape
    nc = k.shape[2]
    n_valid = n if n_valid is None else int(n_valid)
    row0, col0 = int(row0), int(col0)
    _check_rel_covers(rel, n_valid)
    if poly is not None and rel is not None:
        raise ValueError("poly and rel are mutually exclusive")
    if cos is not None and (nc != n or row0 or col0):
        raise ValueError("rope tables rotate whole sequences: the keys must "
                         "be q's own, at offsets (0, 0)")
    hp = HeadPad.needed(q, cos) if q.device.type != "cpu" else None
    if hp is not None:
        dq, dk, dv, dcoeff, dtable = attention_stream_bwd_fused(
            *map(hp.pad, (q, k, v, g)), lse, delta, scale,
            *hp.tables(cos, sin), poly, rel, n_valid, row0, col0, chunk_cols,
            out_dtype, mm_dtype)
        return (*map(hp.unpad, (dq, dk, dv)), dcoeff, dtable)
    width = nc if chunk_cols is None else min(nc, int(chunk_cols))
    seg_cols = _fused_kv_seg_cols(b, h, n, d)
    if width > seg_cols:
        return _bwd_fused_segmented(q, k, v, g, lse, delta, scale, cos, sin,
                                    poly, rel, n_valid, row0, col0, width,
                                    seg_cols, out_dtype, mm_dtype)
    if q.device.type == "cpu":
        dq, dk, dv, dcoeff, dtable = attention_stream_bwd_fused_plain(
            q, k, v, g, lse, delta, scale, cos, sin, poly, rel,
            n_valid=n_valid, row0=row0, col0=col0, chunk_cols=chunk_cols,
            mm_dtype=mm_dtype)
        return (dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype), dcoeff,
                dtable)
    _check_bf16_products(mm_dtype)
    q, k, v, g = _fused_inputs(q, k, v, g, cos, sin)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, h, n) or t.dtype != torch.float32
                or t.device != q.device):
            raise ValueError(f"{name} must be a float32 [B, H, N] tensor on "
                             f"q's device")
    coeff, grid, table = _check_generated(q, poly, rel)
    lse, delta = lse.contiguous(), delta.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    if nc == n:
        dqkv = torch.empty((b, n, 3, h, d), **f32)
        dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        dq, dk, dv = (torch.empty((b, rows, h, d), **f32).transpose(1, 2)
                      for rows in (n, nc, nc))
    slabs, ops = fused_scratch_shapes(b, h, n, nc, d)
    # one buffer: the slabs, then the bf16 operands (two to a float)
    scratch = torch.empty(math.prod(slabs) + ops[0] // 2, **f32)
    dparam, part = _dparam_scratch(q, nc, coeff, table)
    with torch.cuda.device(q.device):
        err = _stream_fused_library().attn_stream_bwd_fused(
            _pointers(q, k, v, g, lse, delta, dq, dk, dv, scratch, dparam,
                      part, cos, sin, coeff, table),
            _strides(q, k, v, g, dq, dk, dv),
            _stream_dims(q, cos, coeff, grid, table, row0=row0, col0=col0,
                         n_valid=n_valid, nk=nc, kv_valid=width),
            float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_stream_bwd_fused launch failed: CUDA error "
                           f"{err}")
    LAUNCHES_STREAM_FUSED_PROLOGUE += 1
    LAUNCHES_STREAM_FUSED += 1
    if nc == n and out_dtype != torch.float32:
        dqkv = dqkv.to(out_dtype)  # one pass over the three gradients
        dq, dk, dv = (dqkv[:, :, i].transpose(1, 2) for i in range(3))
    return (dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype),
            dparam if coeff is not None else None,
            dparam if table is not None else None)


def _bwd_fused_segmented(q, k, v, g, lse, delta, scale, cos, sin, poly, rel,
                         n_valid, row0, col0, width, seg_cols, out_dtype,
                         mm_dtype):
    """The one-pass backward over key segments of seg_cols keys at global
    column offsets (the JAX package's `_bwd_fused_segmented`): dq and the
    parameter gradients are summed over the segments in float32, each
    segment of dk and dv is written once. Fixed-frequency rope is applied
    once outside the sweep: q and k are rotated (in float32) before it, dq
    and dk rotated back after it."""
    if cos is not None:
        q = _rotate(q.float(), cos[None], sin[None])
        k = _rotate(k.float(), cos[None], sin[None])
        v, g = v.float(), g.float()  # one dtype for the kernel; exact
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, **f32)
    dk, dv = torch.zeros(k.shape, **f32), torch.zeros(k.shape, **f32)
    dcoeff, dtable = _dparam_zeros(poly, rel, q.device)
    for s0 in range(0, width, seg_cols):
        seg = slice(s0, min(s0 + seg_cols, width))
        dq_s, dk_s, dv_s, dc_s, dt_s = attention_stream_bwd_fused(
            q, k[:, :, seg], v[:, :, seg], g, lse, delta, scale, None, None,
            poly, rel, n_valid, row0, col0 + s0, mm_dtype=mm_dtype)
        dq += dq_s
        dk[:, :, seg], dv[:, :, seg] = dk_s, dv_s
        if dcoeff is not None:
            dcoeff += dc_s
        if dtable is not None:
            dtable += dt_s
    if cos is not None:
        dq = _rotate(dq, cos[None], -sin[None])
        dk = _rotate(dk, cos[None], -sin[None])
    return dq.to(out_dtype), dk.to(out_dtype), dv.to(out_dtype), dcoeff, dtable


def streaming_chunk_bwd(q, k, v, g, lse, delta, scale, row0, col0, n_valid,
                        poly=None, rel=None, mm_dtype=torch.bfloat16):
    """One chunk's share of the streaming backward (the JAX package's
    `streaming_chunk_bwd`): the gradients of this shard's q rows (first row
    at global token row0) against one key chunk (first key at global token
    col0), with the lse and delta of the WHOLE softmax row and n_valid the
    global token count. Returns (dq partial [B, H, N, D], dk and dv of the
    chunk [B, H, Nc, D], the chunk's share of dcoeff / dtable or None), all
    float32, from the one-pass kernel (one launch per key segment of
    `_fused_kv_seg_cols`). mm_dtype float32 is for CPU tensors only."""
    dq, dk, dv, dcoeff, dtable = attention_stream_bwd_fused(
        q, k, v, g, lse, delta, scale, None, None, poly, rel, n_valid, row0,
        col0, mm_dtype=mm_dtype)
    return dq, dk, dv, dcoeff if dcoeff is not None else dtable


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


class StreamingAttentionFunction(torch.autograd.Function):
    """The JAX package's custom_vjp around the streaming kernels: forward
    `attention_stream_fwd`, which saves the per-row logsumexp; backward as
    the streaming branch of `_bwd`: the one-pass `attention_stream_bwd_fused`
    without a materialized bias and without learnable (3-D) frequencies,
    else `attention_stream_bwd` in separate passes. Arguments as
    FlashAttentionFunction, plus the generated biases coeff (with grid) and
    table, whose gradients are summed in the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias, cos_raw, sin_raw, coeff, table, grid,
                scale):
        cos = sin = None
        if cos_raw is not None:
            cos, sin = _kernel_freqs((cos_raw, sin_raw), q.shape[1],
                                     q.shape[2], q.device)
        poly = (coeff, grid) if coeff is not None else None
        if q.device.type != "cpu":  # padded once for both wrappers
            bias = pitched_bias(bias)
        out, lse = attention_stream_fwd(q, k, v, scale, bias, cos, sin, poly,
                                        table)
        ctx.save_for_backward(q, k, v, out, lse, bias, cos, sin, cos_raw,
                              sin_raw, coeff, table)
        ctx.scale, ctx.grid = scale, grid
        return out

    @staticmethod
    def backward(ctx, g):
        (q, k, v, out, lse, bias, cos, sin, cos_raw, sin_raw, coeff,
         table) = ctx.saved_tensors
        poly = (coeff, ctx.grid) if coeff is not None else None
        dcos = dsin = None
        if bias is None and (cos_raw is None or cos_raw.dim() == 2):
            delta = (g.float() * out.float()).sum(dim=-1)
            dq, dk, dv, dcoeff, dtable = attention_stream_bwd_fused(
                q, k, v, g, lse, delta, ctx.scale, cos, sin, poly, table,
                out_dtype=q.dtype)
            dbias = None
            if ctx.needs_input_grad[4]:  # fixed frequencies: an exact zero
                dcos = torch.zeros_like(cos_raw)
            if ctx.needs_input_grad[5]:
                dsin = torch.zeros_like(sin_raw)
        else:
            want_drot = cos_raw is not None and any(ctx.needs_input_grad[4:6])
            dq, dk, dv, dbias, dqr, dkr, dcoeff, dtable = attention_stream_bwd(
                q, k, v, out, g, lse, ctx.scale, bias, cos, sin, poly, table,
                want_dbias=ctx.needs_input_grad[3], want_drot=want_drot,
                want_dparam=any(ctx.needs_input_grad[6:8]))
            if want_drot:
                dcos, dsin = _rot_grads_to_dfreqs(q, k, dqr, dkr,
                                                  (cos_raw, sin_raw))
        if dcoeff is not None:
            dcoeff = dcoeff.to(coeff.dtype)
        if dtable is not None:
            dtable = dtable.to(table.dtype)
        return dq, dk, dv, dbias, dcos, dsin, dcoeff, dtable, None, None


# ---------------------------------------------------------------------------
# Public entry: routing and bias / rope preparation (the JAX `_forward` and
# the dense branch of `_bwd`)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, scale, bias=None, freqs_cis=None, poly=None,
                    rel=None):
    """Fused attention over [B, H, N, D] -> [B, H, N, D], differentiable.

    bias: [H, N, N]; freqs_cis: (cos, sin) [S|H,S, D/2] over the N-1 patch
    tokens; poly: (coeff_hk [H, deg+1], grid_size); rel: table [H, 2N-1].
    bias, poly and rel are mutually exclusive. Shapes up to
    STREAMING_THRESHOLD tokens that `_dense_attn_fits` take the dense
    kernels, with poly / rel materialized; every other shape streams, with
    poly / rel generated in the kernels, forward and backward."""
    _, h, n, _ = q.shape
    if sum(x is not None for x in (bias, poly, rel)) > 1:
        raise ValueError("bias/poly/rel are mutually exclusive")
    has_biasish = bias is not None or poly is not None or rel is not None
    generator = poly[0] if poly is not None else rel
    inputs = [q, k, v, bias, generator, *(freqs_cis or ())]
    training = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in inputs)
    cos_raw, sin_raw = freqs_cis if freqs_cis is not None else (None, None)
    if not use_dense(h, n, has_biasish):
        if not training:
            bias, cos, sin = prepare_pe(h, n, q.device, bias, freqs_cis)
            return attention_stream_fwd(q, k, v, scale, bias, cos, sin, poly,
                                        rel)[0]
        if bias is not None:
            bias = _dense_bias(h, n, q.device, bias)
        coeff, grid = poly if poly is not None else (None, 0)
        return StreamingAttentionFunction.apply(
            q, k, v, bias, cos_raw, sin_raw, coeff, rel, int(grid), scale)
    if training:
        bias = _dense_bias(h, n, q.device, bias, poly, rel)
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
