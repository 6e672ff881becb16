"""PyTorch port, the fused pre-LN block forward (ops/block_fused.py, row 12
of the kernel table): the kernel's plain twin `block_forward_plain` against
the JAX package's `block_forward` (its Pallas `_block_kernel` in interpret
mode) and against the port's per-op block (`models.vit._block_body`), at a
small shape (B=2, N=17, E=64, 2 heads of 32, hidden 256), without rope and
with rope-axial's head-shared tables and with rope-mixed's per-head tables
(head 0's for every head, as the JAX `block_forward` keeps `cos[0]`); the
shared-memory layout the CUDA kernel is launched with.

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
SHAPES = {"norm1.weight": (64,), "norm1.bias": (64,),
          "attn.qkv.weight": (192, 64), "attn.proj.weight": (64, 64),
          "attn.proj.bias": (64,), "norm2.weight": (64,),
          "norm2.bias": (64,), "mlp.fc1.weight": (256, 64),
          "mlp.fc1.bias": (256,), "mlp.fc2.weight": (64, 256),
          "mlp.fc2.bias": (64,)}


def block_inputs(seed):
    """Seeded block params (LN weights around 1) and x [2, 17, 64]."""
    rng = np.random.default_rng(seed)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in SHAPES.items()}
    params["norm1.weight"] += 1.0
    params["norm2.weight"] += 1.0
    x = rng.standard_normal((2, 17, 64)).astype(np.float32)
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


def test_smem_layout_fits_vit_tiny_and_refuses_vit_s():
    """ViT-tiny/4 (N=65, E=192, Dh=32, hidden 768) fits one CTA; ViT-S/16 at
    224 px (N=197, E=384) does not: its float32 residual alone is 319 KB.
    Buffers are 128-byte aligned and the attention and MLP regions share the
    space after the residual and the LN output."""
    tiny = block_fused.smem_layout(65, 192, 32, 768)
    assert tiny["NP"] == 80 and tiny["SMEM"] <= block_fused.SMEM_LIMIT
    assert all(tiny[k] % 128 == 0 for k in ("XRES", "HLN", "STAGE", "Q", "K",
                                            "V", "O", "P", "DEN", "F1", "G"))
    assert tiny["STAGE"] == tiny["F1"] == tiny["HLN"] + 80 * 200 * 2
    assert tiny["SMEM"] == tiny["DEN"] + 384
    small = block_fused.smem_layout(197, 384, 64, 1536)
    assert small["HLN"] - small["XRES"] == 208 * 388 * 4
    assert small["SMEM"] > block_fused.SMEM_LIMIT
