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

`block_forward` is the kernel's wrapper: on a CUDA tensor it rounds the
four weight matrices to bf16 in one prologue launch (`block_weights_bf16`,
counted in LAUNCHES_BLOCK_FUSED_PROLOGUE; twin `block_weights_bf16_plain`)
and launches the block kernel once (LAUNCHES_BLOCK_FUSED); on a CPU tensor
it runs `block_forward_plain`, the kernel's plain PyTorch twin with the same
rounding points. The kernel spreads one image over a thread-block cluster,
its 16-row tiles split along the tokens; `block_plan` picks the cluster
size and lays out each CTA's shared memory, and refuses, with a ValueError
that names the limit, images of more than 208 tokens (the scores of a row
tile for every key are held in registers) or whose rows do not fit in
227 KB a CTA in any cluster it can take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build
from vit_rpe_rope_tpu_torch.ops.flash_attention import (
    _prep_freqs, _rotate, _round_up)
from vit_rpe_rope_tpu_torch.utils import nan_check

SOURCE = cuda_build.CSRC / "block_fused.cu"

# Launches of the block kernel and of its weight prologue since the counts
# were last reset; the number of the last launch's clusters that the card
# can hold at once (cudaOccupancyMaxActiveClusters).
LAUNCHES_BLOCK_FUSED = 0
LAUNCHES_BLOCK_FUSED_PROLOGUE = 0
ACTIVE_CLUSTERS = None

# Shared memory one CTA may use on an H100: 227 KB.
SMEM_LIMIT = 232_448
ROW_TILE = 16         # rows are padded to whole 16-row mma tiles
MAX_TILES = 5         # 16-row tiles a CTA holds (the kernel's MAX_TILES)
MAX_KEY_BLOCKS = 13   # key blocks of 16 whose scores a warp holds in
                      # registers: N <= 208
MAX_CLUSTER = 16      # CTAs a cluster may take (above 8: non-portable)
MAX_E = 1024          # widths whose LN rows a warp keeps in registers
W_TILE = 128          # output columns of a weight tile of the ring
DEPTH_CHOICES = (128, 64)  # its depth, the deepest that fits
STAGES = 2            # slots of the weight ring (the kernel's STAGES)
WEIGHT_NAMES = ("attn.qkv.weight", "attn.proj.weight", "mlp.fc1.weight",
                "mlp.fc2.weight")
VECTOR_NAMES = ("norm1.weight", "norm1.bias", "attn.proj.bias",
                "norm2.weight", "norm2.bias", "mlp.fc1.bias", "mlp.fc2.bias")

_SQRT_HALF = 2.0 ** -0.5

# The integer arguments of the C entry point, in the order of its enum Dim.
_DIMS = ("B", "N", "E", "H", "DH", "HID", "IS_BF16", "HAS_ROPE", "TAB_ROWS",
         "KEY_BLOCKS", "TILES", "CLUSTER", "CH", "KT", "LDR", "LDH", "LDG",
         "LDW", "XRES", "HLN", "Q", "K", "V", "G", "RING", "BAR", "SMEM")


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


def _layout(n: int, e: int, hidden: int, tiles: int, depth: int):
    """One CTA's shared memory with `tiles` 16-row tiles and a ring of
    STAGES weight tiles `depth` deep, or None if it exceeds SMEM_LIMIT.
    The hidden width goes in the fewest chunks whose GELU output fits (over
    Q, K and V, which it may outgrow up to the limit). The residual's rows
    are padded by 4 floats (conflict-free epilogue stores) where that
    fits."""
    for pad in (4, 0):
        lay = _layout_padded(n, e, hidden, tiles, depth, pad)
        if lay is not None:
            return lay
    return None


def _layout_padded(n, e, hidden, tiles, depth, pad):
    blocks = -(-n // ROW_TILE)
    rows = ROW_TILE * tiles
    lay = dict(KEY_BLOCKS=blocks, TILES=tiles, CLUSTER=-(-blocks // tiles),
               KT=depth, LDR=e + pad, LDH=e + 8, LDW=depth + 8)

    def size(n_rows, pitch, nbytes):
        return _round_up(n_rows * pitch * nbytes, 128)

    xres, hln = size(rows, lay["LDR"], 4), size(rows, lay["LDH"], 2)
    qkv = size(rows, lay["LDH"], 2) + 2 * size(rows, e, 2)
    ring = STAGES * size(W_TILE, lay["LDW"], 2)
    room = max(qkv, SMEM_LIMIT - xres - hln - ring - size(2 * STAGES, 8, 1))
    for chunks in range(1, hidden // ROW_TILE + 1):
        # more than one chunk: whole column tiles of W1 and k tiles of W2
        ch = hidden if chunks == 1 else _round_up(-(-hidden // chunks), W_TILE)
        if size(rows, ch + 8, 2) <= room:
            break
    else:
        return None
    lay.update(CH=ch, LDG=ch + 8, XRES=0, HLN=xres, Q=xres + hln)
    lay.update(K=lay["Q"] + size(rows, lay["LDH"], 2), G=lay["Q"])
    lay["V"] = lay["K"] + size(rows, e, 2)  # K and V in fragment order
    lay["RING"] = lay["Q"] + max(qkv, size(rows, ch + 8, 2))
    lay["BAR"] = lay["RING"] + ring  # a full and an empty mbarrier a slot
    lay["SMEM"] = lay["BAR"] + size(2 * STAGES, 8, 1)
    return lay if lay["SMEM"] <= SMEM_LIMIT else None


def block_plan(n: int, e: int, dh: int, hidden: int, cluster: int = None,
               kt: int = None) -> dict:
    """How the kernel runs an image of n tokens: the cluster size (CLUSTER:
    the CTAs its rows are split over), 16-row tiles a CTA (TILES; rank r
    holds tiles r * TILES ..), the key blocks of the image (KEY_BLOCKS), the
    weight tiles' depth (KT), the hidden chunk (CH), row pitches in elements
    and 128-byte aligned offsets in bytes of each CTA's buffers, keyed as
    the C entry point's Dim, and SMEM, a CTA's total.

    By default the fewest CTAs an image can take (each takes in the whole
    block's weights), then the deepest weight tiles; `cluster` and `kt` ask
    for others (for measurements, launched through `_launch`). Raises
    ValueError naming the limit when none fits."""
    return dict(_plan(n, e, dh, hidden, cluster, kt))


@functools.lru_cache(maxsize=None)
def _plan(n: int, e: int, dh: int, hidden: int, cluster: int = None,
          kt: int = None) -> dict:
    """block_plan's answer, cached per shape."""
    if e % ROW_TILE or dh % ROW_TILE or hidden % ROW_TILE or e % dh or \
            e > MAX_E:
        raise ValueError(f"the fused block kernel takes E (up to {MAX_E}), "
                         f"head dim and hidden width in multiples of "
                         f"{ROW_TILE}; got E={e}, Dh={dh}, hidden={hidden}")
    blocks = -(-n // ROW_TILE)
    if blocks > MAX_KEY_BLOCKS:
        raise ValueError(
            f"one image of {n} tokens is more than the fused block kernel "
            f"holds: at most {MAX_KEY_BLOCKS * ROW_TILE} tokens (the scores "
            f"of a 16-row tile against every key sit in registers)")
    for tiles in range(min(MAX_TILES, blocks), 0, -1):
        size = -(-blocks // tiles)
        if -(-blocks // size) != tiles or size > MAX_CLUSTER or (
                cluster is not None and size != cluster):
            continue
        for depth in (kt,) if kt else DEPTH_CHOICES:
            lay = _layout(n, e, hidden, tiles, depth)
            if lay is not None:
                return lay
    raise ValueError(
        f"one image of {n} tokens at E={e} (Dh={dh}, hidden={hidden}) needs "
        f"more than {SMEM_LIMIT} bytes (227 KB) of shared memory a CTA "
        + (f"in a cluster of {cluster}" if cluster is not None else
           f"in every cluster the fused block kernel can take (at most "
           f"{MAX_CLUSTER} CTAs of at most {MAX_TILES} 16-row tiles)")
        + " on an H100")


def cluster_sizes(n: int, e: int, dh: int, hidden: int) -> list:
    """Every cluster size block_plan can take for this image."""
    out = []
    for size in range(1, MAX_CLUSTER + 1):
        try:
            _plan(n, e, dh, hidden, cluster=size)
        except ValueError:
            continue
        out.append(size)
    return out


def _bind(lib):
    lib.block_fused_prologue.restype = ctypes.c_int
    lib.block_fused_prologue.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),  # 4 sources, the destination
        ctypes.POINTER(ctypes.c_int),     # E, hidden, head dim, tile depth
        ctypes.c_void_p]                  # stream
    lib.block_fused_fwd.restype = ctypes.c_int
    lib.block_fused_fwd.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),   # 12 pointers
        ctypes.POINTER(ctypes.c_int),      # the Dim integers
        ctypes.c_float, ctypes.c_float,    # eps scale
        ctypes.c_void_p,                   # stream
        ctypes.POINTER(ctypes.c_int)]      # clusters resident at once


def _library():
    return cuda_build.load(SOURCE, _bind)


def _f32(t, dev):
    """t as a contiguous float32 tensor on dev (itself when it is one)."""
    if t.dtype == torch.float32 and t.device == dev and t.is_contiguous():
        return t.detach()
    return t.detach().to(dev, torch.float32).contiguous()


def _tiled(w, group, kt):
    """One weight matrix [width, K] rounded to bf16 as the kernel's ring takes
    it: tiles of W_TILE output columns by kt, tile (ct, k tile) one
    contiguous [W_TILE, kt + 8] block, row r of tile ct the output column
    whose 16-column pair is ct * 8 + r // 16: of a pair p, the 8 columns at
    (p // (group / 16)) * group + (p % (group / 16)) * 8 and the 8 at
    group / 2 after them (a head's column d beside d + Dh/2 for the
    rotation; in order when group is 16); zeros past the width, past K and in
    the 8 padding columns."""
    width, k = w.shape
    n_ct, n_kt = -(-width // W_TILE), -(-k // kt)
    r = torch.arange(n_ct * W_TILE, device=w.device)
    nb = (r % W_TILE) // 8
    pair = (r // W_TILE) * (W_TILE // 16) + nb // 2
    per = group // 16
    col = (pair // per) * group + (pair % per) * 8 + (nb % 2) * (group // 2) \
        + r % 8
    valid = pair < width // 16
    rows = torch.zeros((n_ct * W_TILE, n_kt * kt), dtype=torch.bfloat16,
                       device=w.device)
    rows[valid, :k] = w.detach().to(torch.bfloat16)[col[valid]]
    tiles = rows.view(n_ct, W_TILE, n_kt, kt).permute(0, 2, 1, 3)
    return torch.nn.functional.pad(tiles, (0, 8)).reshape(-1)


def block_weights_bf16_plain(block_params, head_dim, kt):
    """Wqkv (columns in groups of the head dim), Wproj, W1, W2 (groups of
    16) as `_tiled` lays them out, back to back: the prologue's twin."""
    groups = (head_dim, 16, 16, 16)
    return torch.cat([_tiled(block_params[nm], grp, kt)
                      for nm, grp in zip(WEIGHT_NAMES, groups)])


def _prologue_args(block_params, device, head_dim, kt):
    """The prologue's pointers, its dims and its output (uninitialized)."""
    mats = [_f32(block_params[nm], device) for nm in WEIGHT_NAMES]
    e, hid = mats[1].shape[0], mats[2].shape[0]
    size = sum(-(-wd // W_TILE) * -(-k // kt) * W_TILE * (kt + 8)
               for wd, k in ((3 * e, e), (e, e), (hid, e), (e, hid)))
    out = torch.empty(size, dtype=torch.bfloat16, device=device)
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in (*mats, out)))
    return ptrs, (ctypes.c_int * 4)(e, hid, head_dim, kt), out


def _launch_prologue(lib, args, stream):
    global LAUNCHES_BLOCK_FUSED_PROLOGUE
    err = lib.block_fused_prologue(args[0], args[1], stream)
    if err != 0:
        raise RuntimeError(f"block_fused_prologue launch failed: CUDA error "
                           f"{err}")
    LAUNCHES_BLOCK_FUSED_PROLOGUE += 1
    return args[2]


def block_weights_bf16(block_params, device, head_dim, kt):
    """block_weights_bf16_plain on the card: one launch of the prologue
    kernel (float32 weights are read where they lie; others are made
    float32 first)."""
    args = _prologue_args(block_params, device, head_dim, kt)
    lib = _library()
    with torch.cuda.device(device):
        return _launch_prologue(lib, args,
                                torch.cuda.current_stream().cuda_stream)


def _kernel_tables(freqs_cis, n, dh, device):
    """The rope tables as the kernel reads them: float32 [S, Dh/2] for
    tokens 1 .. S (head 0's of per-head tables, as `_tables`), S <= n - 1;
    the cls token and tokens past S are not rotated."""
    cos, sin = freqs_cis
    if cos.dim() == 3:
        cos, sin = cos[0], sin[0]
    if cos.shape[-1] != dh // 2 or cos.shape[0] > n - 1 or \
            sin.shape != cos.shape:
        raise ValueError(f"rope tables of shape {tuple(cos.shape)} do not "
                         f"fit {n} tokens of head dim {dh}")
    return _f32(cos, device), _f32(sin, device)


def block_forward(x, block_params, cfg, freqs_cis=None, batch_tile: int = 8):
    """One fused-block forward, the JAX package's `block_forward`: x
    [B, N, E] (cls at 0), block_params un-prefixed (norm1.weight,
    attn.qkv.weight [3E, E] torch layout, ...), freqs_cis (cos, sin)
    [S, D/2] for rope-axial, [H, S, D/2] (head 0's used for every head, as
    in the JAX package) or None. Returns [B, N, E] in x's dtype.
    batch_tile is the JAX package's grid tile; results do not depend on it.

    CPU tensors run the plain twin. CUDA tensors launch the prologue and
    the kernel on the current stream, or raise."""
    if int(batch_tile) < 1:
        raise ValueError(f"batch_tile must be >= 1; got {batch_tile}")
    if x.device.type == "cpu":
        return block_forward_plain(x, block_params, cfg, freqs_cis)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_forward takes float32 or bfloat16; got "
                        f"{x.dtype}")
    bsz, n, e = x.shape
    if e != cfg.embed_dim or not 1 <= bsz <= 2 ** 27:
        raise ValueError(f"x {tuple(x.shape)} does not fit E="
                         f"{cfg.embed_dim} or its batch is out of range")
    lay = block_plan(n, e, cfg.head_dim, cfg.mlp_hidden_dim)
    out = _launch(x, block_params, cfg, freqs_cis, lay)
    nan_check.check("block_fused", out)
    return out


def _launch(x, block_params, cfg, freqs_cis, lay):
    """block_forward on a CUDA tensor x under the plan `lay` (block_plan's,
    which may be asked for another cluster size or tile depth than its
    own): one launch of the weight prologue and one of the kernel."""
    global LAUNCHES_BLOCK_FUSED, ACTIVE_CLUSTERS
    bsz, n, e = x.shape
    h, dh, hid = cfg.num_heads, cfg.head_dim, cfg.mlp_hidden_dim
    lay = dict(lay)
    dev = x.device
    cos = sin = None
    if freqs_cis is not None:
        cos, sin = _kernel_tables(freqs_cis, n, dh, dev)
    x = x.contiguous()
    out = torch.empty_like(x)
    vecs = [_f32(block_params[nm], dev) for nm in VECTOR_NAMES]
    prologue = _prologue_args(block_params, dev, dh, lay["KT"])
    tensors = (x, out, *vecs, prologue[2], cos, sin)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *(t.data_ptr() if t is not None else None for t in tensors))
    lay.update(B=bsz, N=n, E=e, H=h, DH=dh, HID=hid,
               IS_BF16=int(x.dtype == torch.bfloat16),
               HAS_ROPE=int(cos is not None),
               TAB_ROWS=0 if cos is None else cos.shape[0])
    dims = (ctypes.c_int * len(_DIMS))(*(int(lay[k]) for k in _DIMS))
    active = ctypes.c_int(0)
    lib = _library()
    with torch.cuda.device(dev):  # both launches on the current stream
        stream = torch.cuda.current_stream().cuda_stream
        _launch_prologue(lib, prologue, stream)
        err = lib.block_fused_fwd(ptrs, dims, float(cfg.layer_norm_eps),
                                  float(dh ** -0.5), stream,
                                  ctypes.byref(active))
    ACTIVE_CLUSTERS = active.value
    if err == -1:
        raise ValueError(
            f"no cluster of {lay['CLUSTER']} CTAs with {lay['SMEM']} bytes of "
            f"shared memory each fits on this card")
    if err != 0:
        raise RuntimeError(f"block_fused_fwd launch failed: CUDA error {err}")
    LAUNCHES_BLOCK_FUSED += 1
    return out
