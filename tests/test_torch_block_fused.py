"""PyTorch port, the fused pre-LN block forward (ops/block_fused.py, row 12
of the kernel table): the kernel's plain twin `block_forward_plain` against
the JAX package's `block_forward` (its Pallas `_block_kernel` in interpret
mode) and against the port's per-op block (`models.vit._block_body`), at a
small shape (B=2, N=17, E=64, 2 heads of 32, hidden 256), without rope and
with rope-axial's head-shared tables and with rope-mixed's per-head tables
(head 0's for every head, as the JAX `block_forward` keeps `cos[0]`), and
at ViT-S/16@224's widths (N=197, E=384, 6 heads of 64, hidden 1536, batch
1); the weight prologue's twin (the tiles the kernel's ring takes) and the
rope tables as the kernel reads them; the plan (cluster size, rows a CTA,
shared-memory layout) the CUDA kernel is launched with.

Tolerances: against the JAX kernel, 2e-3 of the output's largest entry
(the same rounding points on both sides; rotated q / k in float32 can round
to the other bf16 neighbour where the two frameworks contract a multiply
and an add differently: 3.1e-4 seen with rope, 6e-8 without); against the
per-op block 2e-2, the JAX package's own bound for its fused kernel against
its XLA block (bf16 products against float32 ones).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.ops import block_fused as jbf
from vit_rpe_rope_tpu.pe import rope_axial as jrope_axial
from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import block_fused

KW = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=64, depth=1,
          num_heads=2)
def block_shapes(e, hid):
    return {"norm1.weight": (e,), "norm1.bias": (e,),
            "attn.qkv.weight": (3 * e, e), "attn.proj.weight": (e, e),
            "attn.proj.bias": (e,), "norm2.weight": (e,), "norm2.bias": (e,),
            "mlp.fc1.weight": (hid, e), "mlp.fc1.bias": (hid,),
            "mlp.fc2.weight": (e, hid), "mlp.fc2.bias": (e,)}


def block_inputs(seed, e=64, hid=256, shape=(2, 17, 64)):
    """Seeded block params (LN weights around 1) and x (default [2, 17,
    64])."""
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in block_shapes(e, hid).items()}
    params["norm1.weight"] += 1.0
    params["norm2.weight"] += 1.0
    x = rng.standard_normal(shape).astype(np.float32)
    return params, x


def port(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


def close_to_largest(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("batch_tile", [1, 2])
@pytest.mark.parametrize("pe", ["none", "rope-axial"])
def test_twin_matches_jax_block_forward(pe, batch_tile):
    jcfg = JaxViTConfig(**KW, pos_encoding=pe)
    cfg = ViTConfig(**KW, pos_encoding=pe)
    params, x = block_inputs(seed=0)
    jfreqs = jrope_axial.freqs_cis({}, jcfg) if pe == "rope-axial" else None
    freqs = (pe_registry.get(pe).freqs_cis({}, cfg, device="cpu")
             if pe == "rope-axial" else None)
    if freqs is not None:  # both packages' tables agree
        for a, b in zip(freqs, jfreqs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    want = np.asarray(jbf.block_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        freqs_cis=jfreqs, batch_tile=batch_tile))
    got = block_fused.block_forward(torch.from_numpy(x), port(params), cfg,
                                    freqs_cis=freqs, batch_tile=batch_tile)
    close_to_largest(got.numpy(), want, 2e-3)
    # the wrapper on a CPU tensor is the twin
    torch.testing.assert_close(got, block_fused.block_forward_plain(
        torch.from_numpy(x), port(params), cfg, freqs), rtol=0, atol=0)


@pytest.mark.parametrize("pe", ["none", "rope-axial"])
def test_twin_matches_the_per_op_block(pe):
    cfg = ViTConfig(**KW, pos_encoding=pe, attention_impl="flash")
    params, x = block_inputs(seed=1)
    freqs = (pe_registry.get(pe).freqs_cis({}, cfg, device="cpu")
             if pe == "rope-axial" else None)
    want = vit._block_body(port(params), torch.from_numpy(x), cfg, None,
                           freqs, "flash")
    got = block_fused.block_forward_plain(torch.from_numpy(x), port(params),
                                          cfg, freqs)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("batch_tile", [1, 2])
def test_per_head_tables_rotate_by_head_0_as_jax(batch_tile):
    """rope-mixed's [H, S, D/2] tables, the same seeded ones on both sides:
    the JAX block_forward rotates every head by head 0's table, and so does
    the port (twin and wrapper); held to the JAX kernel in interpret mode at
    the rope tolerance above, and to the port's block on head 0's table
    alone, bit for bit."""
    cfg = ViTConfig(**KW, pos_encoding="rope-mixed")
    jcfg = JaxViTConfig(**KW, pos_encoding="rope-mixed")
    params, x = block_inputs(seed=2)
    pe_params = pe_registry.get("rope-mixed").init_params(
        torch.Generator().manual_seed(0), cfg)
    freqs = pe_registry.get("rope-mixed").freqs_cis(pe_params, cfg)
    assert freqs[0].dim() == 3 and freqs[0].shape[0] == cfg.num_heads
    assert not torch.equal(freqs[0][0], freqs[0][1])  # heads differ
    want = np.asarray(jbf.block_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        freqs_cis=tuple(jnp.asarray(t.numpy()) for t in freqs),
        batch_tile=batch_tile))
    got = block_fused.block_forward(torch.from_numpy(x), port(params), cfg,
                                    freqs_cis=freqs, batch_tile=batch_tile)
    close_to_largest(got.numpy(), want, 2e-3)
    head0 = block_fused.block_forward_plain(
        torch.from_numpy(x), port(params), cfg, (freqs[0][0], freqs[1][0]))
    torch.testing.assert_close(got, head0, rtol=0, atol=0)


def test_batch_tile_below_one_is_refused():
    params, x = block_inputs(seed=2)
    with pytest.raises(ValueError, match="batch_tile"):
        block_fused.block_forward(torch.from_numpy(x), port(params),
                                  ViTConfig(**KW), batch_tile=0)


VIT_S = dict(img_size=224, patch_size=16, in_chans=3, embed_dim=384,
             depth=1, num_heads=6)


@pytest.mark.parametrize("pe", ["none", "rope-axial"])
def test_twin_matches_jax_block_forward_at_vit_s_widths(pe):
    """ViT-S/16@224 (N=197, E=384, 6 heads of 64, hidden 1536), batch 1:
    the shape the kernel spreads over a cluster, its twin against the JAX
    kernel in interpret mode at the same 2e-3 of the largest entry."""
    jcfg = JaxViTConfig(**VIT_S, pos_encoding=pe)
    cfg = ViTConfig(**VIT_S, pos_encoding=pe)
    params, x = block_inputs(seed=3, e=384, hid=1536, shape=(1, 197, 384))
    jfreqs = jrope_axial.freqs_cis({}, jcfg) if pe == "rope-axial" else None
    freqs = (pe_registry.get(pe).freqs_cis({}, cfg, device="cpu")
             if pe == "rope-axial" else None)
    want = np.asarray(jbf.block_forward(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()}, jcfg,
        freqs_cis=jfreqs, batch_tile=1))
    got = block_fused.block_forward(torch.from_numpy(x), port(params), cfg,
                                    freqs_cis=freqs)
    close_to_largest(got.numpy(), want, 2e-3)


@pytest.mark.parametrize("width,k,group,kt", [
    (192, 64, 32, 64), (64, 256, 16, 128), (144, 48, 48, 64),
    (1152, 384, 64, 128)])
def test_weight_tiles_hold_every_column_once_beside_its_partner(width, k,
                                                                group, kt):
    """The prologue's twin (`_tiled`): tile (ct, k tile) of W [width, K] is
    a [128, kt + 8] block whose row r holds bf16(W) of the column of pair
    ct * 8 + r // 16 (a head's column d beside d + group / 2), its k range,
    zeros past the width and K and in the padding; every column once.
    Checked row by row against that rule written out here."""
    w = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (width, k)).astype(np.float32))
    tiles = block_fused._tiled(w, group, kt)
    n_ct, n_kt = -(-width // 128), -(-k // kt)
    tiles = tiles.view(n_ct, n_kt, 128, kt + 8)
    wb = w.to(torch.bfloat16)
    seen = []
    for ct in range(n_ct):
        for r in range(128):
            pair, half = ct * 8 + r // 16, (r // 8) % 2
            if pair >= width // 16:
                assert not tiles[ct, :, r].any()
                continue
            per = group // 16
            col = (pair // per) * group + (pair % per) * 8 \
                + half * (group // 2) + r % 8
            seen.append(col)
            assert torch.equal(tiles[ct, :, r, :kt].reshape(-1)[:k], wb[col])
            assert not tiles[ct, :, r, :kt].reshape(-1)[k:].any()
            assert not tiles[ct, :, r, kt:].any()
    assert sorted(seen) == list(range(width))


def test_weight_twin_tiles_the_four_matrices_back_to_back():
    """block_weights_bf16_plain: Wqkv in groups of the head dim, then
    Wproj, W1, W2 in groups of 16, each `_tiled`."""
    params, _ = block_inputs(seed=4)
    flat = block_fused.block_weights_bf16_plain(port(params), 32, 64)
    parts = [block_fused._tiled(torch.from_numpy(params[nm]), grp, 64)
             for nm, grp in (("attn.qkv.weight", 32), ("attn.proj.weight", 16),
                             ("mlp.fc1.weight", 16), ("mlp.fc2.weight", 16))]
    assert torch.equal(flat, torch.cat(parts))


@pytest.mark.parametrize("per_head", [False, True])
def test_kernel_tables_are_the_twin_tables_past_the_cls_row(per_head):
    """The kernel reads the raw tables for tokens 1 .. S (head 0's of
    per-head tables) and leaves the cls token unrotated: the twin's tables
    (`_tables`) are exactly that, with the identity row first."""
    rng = np.random.default_rng(5)
    shape = (2, 16, 16) if per_head else (16, 16)
    phase = torch.from_numpy(rng.uniform(0, 6, shape).astype(np.float32))
    freqs = (torch.cos(phase), torch.sin(phase))
    cos, sin = block_fused._kernel_tables(freqs, 17, 32, "cpu")
    twin_cos, twin_sin = block_fused._tables(freqs, 17)
    assert torch.equal(twin_cos[0], torch.ones(16))
    assert torch.equal(twin_sin[0], torch.zeros(16))
    assert torch.equal(twin_cos[1:], cos) and torch.equal(twin_sin[1:], sin)
    with pytest.raises(ValueError, match="do not fit"):
        block_fused._kernel_tables(freqs, 16, 32, "cpu")


PLAN_SHAPES = {"vit-tiny/4": (65, 192, 32, 768),
               "vit-s/16@224": (197, 384, 64, 1536),
               "cpu-test": (17, 64, 32, 256)}
PLAN_CASES = [(label, size) for label, shape in PLAN_SHAPES.items()
              for size in block_fused.cluster_sizes(*shape)]


@pytest.mark.parametrize("label,size", PLAN_CASES)
def test_block_plan_fits_and_covers_every_row_once(label, size):
    """Every cluster size the plan takes at ViT-tiny/4, ViT-S/16@224 and the
    CPU tests' shape: a CTA's buffers 128-byte aligned, apart from one
    another (G over Q, K and V only) and within SMEM_LIMIT; the ranks'
    16-row tiles cover the image's rows exactly once, each rank at least
    one tile."""
    n, e, dh, hid = PLAN_SHAPES[label]
    lay = block_fused.block_plan(n, e, dh, hid, cluster=size)
    assert lay["CLUSTER"] == size and lay["SMEM"] <= block_fused.SMEM_LIMIT
    assert all(lay[k] % 128 == 0 for k in ("XRES", "HLN", "Q", "K", "V",
                                           "G", "RING", "BAR"))
    rows = 16 * lay["TILES"]
    spans = {"XRES": rows * lay["LDR"] * 4, "HLN": rows * lay["LDH"] * 2,
             "Q": rows * lay["LDH"] * 2, "K": rows * e * 2,
             "V": rows * e * 2,
             "RING": block_fused.STAGES * block_fused.W_TILE * lay["LDW"] * 2,
             "BAR": block_fused.STAGES * 2 * 8}
    ends = sorted((lay[k], lay[k] + v) for k, v in spans.items())
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))
    assert ends[-1][1] <= lay["SMEM"]
    assert lay["G"] == lay["Q"] and \
        lay["G"] + rows * lay["LDG"] * 2 <= lay["RING"]
    assert lay["CH"] % 16 == 0 and lay["CH"] <= hid
    assert lay["KT"] in block_fused.DEPTH_CHOICES and lay["LDW"] >= lay["KT"]
    blocks = -(-n // 16)
    assert lay["KEY_BLOCKS"] == blocks
    owned = [t for r in range(size)
             for t in range(r * lay["TILES"],
                            min((r + 1) * lay["TILES"], blocks))]
    assert owned == list(range(blocks))
    assert all(r * lay["TILES"] < blocks for r in range(size))


def test_block_plan_spreads_vit_s_over_a_cluster():
    """ViT-S/16@224 does not fit one CTA (its float32 residual alone is
    319 KB): the plan's own choice is a cluster; ViT-tiny/4's is one CTA."""
    assert block_fused.block_plan(197, 384, 64, 1536)["CLUSTER"] > 1
    assert block_fused.block_plan(65, 192, 32, 768)["CLUSTER"] == 1
    assert 1 not in block_fused.cluster_sizes(197, 384, 64, 1536)


@pytest.mark.parametrize("shape,limit", [
    ((577, 384, 64, 1536), "at most 208 tokens"),
    ((197, 1024, 64, 4096), "232448 bytes"),
    ((65, 192, 24, 768), "multiples of 16")])
def test_block_plan_refuses_what_it_cannot_hold(shape, limit):
    """ViT-S/16@384 (N=577): more keys than a warp's registers hold; E=1024
    at N=197: no cluster's CTAs fit their rows in 227 KB; head dims off the
    16-wide fragments. Each raises naming its limit."""
    with pytest.raises(ValueError, match=limit):
        block_fused.block_plan(*shape)
