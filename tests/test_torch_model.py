"""PyTorch port, model: the port's forward against the JAX package's
`vit.apply` on copied params (all six PE modes), against the reference
PyTorch fixtures tests/golden/model_golden_*.npz, and the state_dict key
contract of the nn.Module.

Tolerances: reference attention path 1e-5 (float32 both sides, sums in
another order); kernel path (bf16 products) 2e-3 on logits, as for the
attention kernel alone; golden fixtures 1e-4, as the JAX package's own
golden test; bfloat16 compute 5e-2 on logits of magnitude ~0.5 (bf16
rounds each of ~40 ops to 8 bits, and the two frameworks round at other
places); the streaming route above a lowered threshold 2e-3 on logits (the
port's twin and the JAX kernel round p against the same running max)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
PE_NAMES = ["none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed"]


def small_kw(pe_name, **kw):
    base = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=4, pos_encoding=pe_name, attention_impl="reference")
    base.update(kw)
    return base


def jax_params(kw, seed=0):
    cfg = JaxViTConfig(**kw)
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params, {k: np.asarray(v) for k, v in params.items()}


def port_model(np_params, cfg):
    state = params_from_jax(np_params, cfg)
    canonical = {k: v for k, v in state.items() if k in np_params}
    return vit.VisionTransformer(canonical, cfg), state


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_reference_path_matches_jax_apply(pe_name):
    kw = small_kw(pe_name)
    jcfg, jp, np_params = jax_params(kw)
    model, _ = port_model(np_params, ViTConfig(**kw))
    x = images((3, 32, 32, 3))
    want = np.asarray(jvit.apply(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pe_name", ["polynomial", "rope-mixed"])
def test_kernel_path_matches_jax_flash_at_n65(pe_name):
    """N=65 (patch 4): the kernel path (its plain twin on the CPU) against
    the JAX forward through its Pallas kernel."""
    kw = small_kw(pe_name, patch_size=4)
    jcfg, jp, np_params = jax_params(kw, seed=1)
    tcfg = ViTConfig(**dict(kw, attention_impl="auto"))
    model, _ = port_model(np_params, tcfg)
    x = images((2, 32, 32, 3), seed=1)
    want = np.asarray(jvit.apply(
        jp, jnp.asarray(x), dataclasses.replace(jcfg, attention_impl="flash")))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def lower_streaming_threshold(monkeypatch, value=128):
    """The threshold above which both packages stream, lowered in both so a
    small model takes the route of a long sequence."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", value)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", value)


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_streaming_route_matches_jax_flash_above_threshold(pe_name,
                                                           monkeypatch):
    """N=145 (img 48, patch 4) above a threshold of 128: the streaming
    kernel's twin against the JAX forward through `_stream_kernel`, with the
    polynomial and relative bias generated in the kernel on both sides."""
    lower_streaming_threshold(monkeypatch)
    kw = small_kw(pe_name, img_size=48, patch_size=4, poly_shared_heads=False)
    jcfg, jp, np_params = jax_params(kw, seed=3)
    tcfg = ViTConfig(**dict(kw, attention_impl="auto"))
    model, _ = port_model(np_params, tcfg)
    x = images((2, 48, 48, 3), seed=3)
    want = np.asarray(jvit.apply(
        jp, jnp.asarray(x), dataclasses.replace(jcfg, attention_impl="flash")))
    calls = []
    stream_fwd = tfa.attention_stream_fwd

    def recording(*args):
        calls.append(args[4:])  # bias, cos, sin, poly, rel
        return stream_fwd(*args)

    monkeypatch.setattr(tfa, "attention_stream_fwd", recording)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert len(calls) == tcfg.depth
    bias, _, _, poly, rel = calls[0]
    assert bias is None  # no [H, N, N] tensor in the forward
    assert (poly is not None) == (pe_name == "polynomial")
    assert (rel is not None) == (pe_name == "relative")


@pytest.mark.parametrize("pe_name", ["polynomial", "relative"])
def test_logits_bias_marker_follows_the_threshold(pe_name, monkeypatch):
    from vit_rpe_rope_tpu_torch import pe as pe_registry

    cfg = ViTConfig(**small_kw(pe_name, img_size=48, patch_size=4,
                               attention_impl="auto"))
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    pe_mod = pe_registry.get(pe_name)
    dense = vit._logits_bias(pe_mod, params, cfg)
    assert tuple(dense.shape) == (4, 145, 145)
    lower_streaming_threshold(monkeypatch)
    marker = vit._logits_bias(pe_mod, params, cfg)
    assert isinstance(marker, tuple) and len(marker) == 1
    assert marker[0].shape[0] == 4 and marker[0].dim() == 2
    reference = vit._logits_bias(
        pe_mod, params, dataclasses.replace(cfg, attention_impl="reference"))
    torch.testing.assert_close(reference, dense, rtol=0, atol=0)


@pytest.mark.parametrize("pe_name", ["none", "relative", "rope-mixed"])
def test_bfloat16_compute_matches_jax(pe_name):
    kw = small_kw(pe_name, compute_dtype="bfloat16")
    jcfg, jp, np_params = jax_params(kw, seed=2)
    model, _ = port_model(np_params, ViTConfig(**kw))
    x = images((2, 32, 32, 3), seed=2)
    want = np.asarray(jvit.apply(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_forward_matches_reference_pytorch_golden(pe_name):
    fname = os.path.join(
        GOLDEN_DIR, f"model_golden_{pe_name.replace('-', '_')}.npz")
    state = checkpoint.load_state(fname)
    imgs = state.pop("__images")  # [B, C, H, W] torch layout
    ref_logits = state.pop("__logits")
    # rope-mixed parity requires the reference's (head, position) scramble.
    cfg = ViTConfig(img_size=32, patch_size=4, embed_dim=192, depth=6,
                    num_heads=6, pos_encoding=pe_name,
                    attention_impl="reference",
                    rope_mixed_compat_scramble=(pe_name == "rope-mixed"))
    params, _ = checkpoint.split_state(state, vit.buffers(cfg))
    model = vit.VisionTransformer(params, cfg)
    # The fixture's full reference state_dict loads strictly.
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()}, strict=True)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(imgs, (0, 2, 3, 1))))
    with torch.no_grad():
        got = model(x).numpy()
    np.testing.assert_allclose(got, ref_logits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_state_dict_keys_match_jax_and_reference(pe_name):
    kw = small_kw(pe_name)
    jcfg, _, np_params = jax_params(kw)
    tcfg = ViTConfig(**kw)
    ours = vit.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: v.shape for k, v in np_params.items()}
    assert vit.num_params(ours) == jvit.num_params(np_params)
    assert vit.reference_alias_keys(tcfg) == jvit.reference_alias_keys(jcfg)
    model = vit.VisionTransformer(ours, tcfg)
    want = set(np_params) | set(jvit.buffers(jcfg)) | set(
        jvit.reference_alias_keys(jcfg))
    assert set(model.state_dict()) == want
    # Aliases share storage with the canonical tensor, as in the reference.
    sd = model.state_dict()
    for alias, canonical in vit.reference_alias_keys(tcfg).items():
        assert sd[alias].data_ptr() == sd[canonical].data_ptr()
    assert set(model.params()) == set(ours)


def test_module_forward_is_apply_and_init_is_seeded():
    cfg = ViTConfig(**small_kw("rope-axial"))
    p1 = vit.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    p2 = vit.init_params(torch.Generator().manual_seed(5), cfg, device="cpu")
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    x = torch.from_numpy(images((2, 32, 32, 3)))
    with torch.no_grad():
        torch.testing.assert_close(vit.VisionTransformer(p1, cfg)(x),
                                   vit.apply(p1, x, cfg), rtol=0, atol=0)


def test_unported_attention_impl_raises():
    """An attention_impl no package has raises; "flash_block" (one
    differentiation boundary per block, ops/block_vjp.py) is ported: its
    forward equals the JAX package's flash_block forward at N=65 (the
    kernels' twins against the Pallas kernels in interpret mode, 2e-3 as
    for the "flash" path above) and the port's own "flash" forward."""
    kw = small_kw("rope-axial", patch_size=4, attention_impl="flash_block")
    cfg = ViTConfig(**dict(kw, attention_impl="no_such_impl"))
    params = vit.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="no_such_impl"):
        vit.apply(params, torch.zeros(1, 32, 32, 3), cfg)
    jcfg, jp, np_params = jax_params(kw, seed=2)
    model, _ = port_model(np_params, ViTConfig(**kw))
    x = images((2, 32, 32, 3), seed=2)
    want = np.asarray(jvit.apply(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        flash = vit.apply(model.params(), torch.from_numpy(x),
                          ViTConfig(**dict(kw, attention_impl="flash")))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, flash.numpy(), rtol=1e-5, atol=1e-5)


def test_patchify_matches_jax():
    kw = small_kw("none")
    x = images((2, 32, 32, 3))
    np.testing.assert_array_equal(
        vit.patchify(torch.from_numpy(x), ViTConfig(**kw)).numpy(),
        np.asarray(jvit.patchify(jnp.asarray(x), JaxViTConfig(**kw))))
