"""PyTorch port, the serving slice as a whole: uint8 images -> preprocess ->
model with the attention kernel (its plain twin on the CPU) -> logits,
against the JAX package's Predictor through its Pallas kernel; checkpoint
interop and config inference against the JAX package.

Tolerances: logits 2e-3 (bf16 products in the attention on both sides, as
for the kernel alone); preprocessing 1e-6 (bilinear upsampling in float32
on both sides)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu import serving as jserving
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu.utils import checkpoint as jckpt
from vit_rpe_rope_tpu.viz import introspect as jintro
from vit_rpe_rope_tpu_torch import serving
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.data.datasets import NATIVE_SIZE, NORMALIZATION
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.viz import introspect

PE_NAMES = ["none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed"]
MEAN, STD = NORMALIZATION["cifar10"]


def jax_params(kw, seed=0):
    cfg = JaxViTConfig(**kw)
    params = jvit.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, params


def uint8_images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def compare_predictors(kw, n_images=5, seed=0, size=32):
    jcfg, jp = jax_params(dict(kw, attention_impl="flash"), seed)
    tcfg = ViTConfig(**dict(kw, attention_impl="auto"))
    u8 = uint8_images(n_images, size=size, seed=seed)
    want = jserving.Predictor.from_params(jp, jcfg, MEAN, STD, 32).logits(u8)
    pred = serving.Predictor.from_params(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg, MEAN, STD, 32,
        device="cpu")
    got = pred.logits(u8)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(pred.predict(u8), np.argmax(got, -1))


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_predictor_matches_jax_flash_predictor(pe_name):
    """N=17 (img 32, patch 8, no resize under the CIFAR contract)."""
    compare_predictors(dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                            num_heads=4, pos_encoding=pe_name))


def test_predictor_matches_jax_at_n65():
    compare_predictors(dict(img_size=32, patch_size=4, embed_dim=64, depth=2,
                            num_heads=4, pos_encoding="rope-mixed"), seed=1)


def test_predictor_matches_jax_when_upsampling():
    """img 64, patch 16: the 32 px CIFAR input is resized in the predictor."""
    compare_predictors(dict(img_size=64, patch_size=16, embed_dim=64, depth=2,
                            num_heads=4, pos_encoding="relative"), seed=2)


@pytest.mark.parametrize("pe_name", ["relative", "polynomial", "rope-axial"])
def test_predictor_matches_jax_above_streaming_threshold(pe_name, monkeypatch):
    """N=145 (img 48, patch 4; the 32 px input upsampled) above a threshold
    lowered to 128 in both packages: the streaming route end to end."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 128)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 128)
    compare_predictors(dict(img_size=48, patch_size=4, embed_dim=64, depth=2,
                            num_heads=4, pos_encoding=pe_name), seed=3)


def test_predictor_takes_images_at_the_model_size():
    """Images already at the model's size pass through without a resize
    (the JAX package's preprocess built for that native size is the
    yardstick); larger ones are shrunk with the antialiased resize, as the
    JAX package's preprocess built for their size shrinks them."""
    kw = dict(img_size=64, patch_size=16, embed_dim=64, depth=1, num_heads=4,
              pos_encoding="none")
    jcfg, jp = jax_params(dict(kw, attention_impl="flash"))
    u8 = uint8_images(3, size=64, seed=4)
    want = jserving.Predictor.from_params(jp, jcfg, MEAN, STD, 64).logits(u8)
    pred = serving.Predictor.from_params(
        {k: np.asarray(v) for k, v in jp.items()}, ViTConfig(**kw), MEAN, STD,
        32, device="cpu")
    np.testing.assert_allclose(pred.logits(u8), want, rtol=2e-3, atol=2e-3)
    big = uint8_images(2, size=96, seed=5)
    want = jserving.Predictor.from_params(jp, jcfg, MEAN, STD, 96).logits(big)
    np.testing.assert_allclose(pred.logits(big), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("native,img", [(32, 224), (28, 224), (32, 64),
                                        (32, 32)])
def test_preprocess_matches_jax(native, img):
    chans = 1 if native == 28 else 3
    dataset = "mnist" if native == 28 else "cifar10"
    mean, std = NORMALIZATION[dataset]
    kw = dict(img_size=img, patch_size=16 if img % 16 == 0 else 8,
              in_chans=chans)
    u8 = np.random.default_rng(3).integers(0, 256, (2, native, native, chans),
                                           dtype=np.uint8)
    want = jts.make_preprocess(JaxViTConfig(**kw), mean, std, native)(
        jnp.asarray(u8))
    got = ts.make_preprocess(ViTConfig(**kw), mean, std, native)(
        torch.from_numpy(u8))
    assert tuple(got.shape) == (2, img, img, chans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_downsampling_is_refused():
    """No longer refused: shrinking 32 px CIFAR images to 16 px is the
    antialiased resize of jax.image.resize (its cases at other sizes:
    tests/test_torch_preprocess.py)."""
    u8 = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3),
                                           dtype=np.uint8)
    kw = dict(img_size=16, patch_size=4)
    want = jts.make_preprocess(JaxViTConfig(**kw), MEAN, STD, 32)(
        jnp.asarray(u8))
    got = ts.make_preprocess(ViTConfig(**kw), MEAN, STD, 32)(
        torch.from_numpy(u8))
    assert tuple(got.shape) == (2, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_jax_checkpoints_load_strictly(tmp_path, pe_name):
    """A JAX-written .npz (with alias keys) and the .pth that the JAX
    package exports from it both load strictly into the port's module and
    give the same config as the JAX package infers."""
    kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
              pos_encoding=pe_name, poly_shared_heads=False)
    jcfg, jp = jax_params(kw)
    npz = jckpt.save(str(tmp_path / f"m_{pe_name}.npz"), jp, jvit.buffers(jcfg),
                     aliases=jvit.reference_alias_keys(jcfg))
    pth = jckpt.export_torch(npz)
    for path in (npz, pth):
        state = checkpoint.load_state(path)
        cfg = introspect.infer_vit_config(state, path=path, num_heads=4,
                                          grid_size=4)
        jcfg_inferred = jintro.infer_vit_config(jckpt.load_state(path),
                                                path=path, num_heads=4,
                                                grid_size=4)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg_inferred)
        params, bufs = checkpoint.split_state(state, vit.buffers(cfg))
        assert set(params) == set(jp) and set(bufs) == set(jvit.buffers(jcfg))
        model = vit.VisionTransformer(params, cfg)
        model.load_state_dict({k: torch.from_numpy(np.array(v))
                               for k, v in state.items()}, strict=True)


def test_infer_vit_config_quirks_match_jax(tmp_path):
    for name, kw in (("cifar10_rope-axial_best.npz",
                      dict(pos_encoding="rope-axial", rope_theta=10.0)),
                     ("model.npz", dict(pos_encoding="relative")),
                     ("cifar10_none_best.npz", dict(pos_encoding="none"))):
        jcfg, jp = jax_params(dict(kw, img_size=32, patch_size=4, embed_dim=64,
                                   depth=1, num_heads=4))
        state = {k: np.asarray(v) for k, v in jp.items()}
        state.update({k: np.asarray(v) for k, v in jvit.buffers(jcfg).items()})
        for grid in (None, 6):
            got = introspect.infer_vit_config(state, path=name, num_heads=4,
                                              grid_size=grid)
            want = jintro.infer_vit_config(state, path=name, num_heads=4,
                                           grid_size=grid)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert introspect.grid_from_filename("x/CIFAR10_a.pth", 3) == 8
    assert introspect._method_from_filename("mnist_rope-mixed_best.pth") == \
        "rope-mixed"
    with pytest.raises(ValueError, match="patch_embed"):
        introspect.infer_vit_config({})


def test_port_checkpoint_round_trip_and_serving_state(tmp_path):
    cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=64, depth=2,
                    num_heads=4, pos_encoding="rope-mixed")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    path = checkpoint.save(str(tmp_path / "m.pth"), params, vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    assert path.endswith(".npz")
    # The JAX package reads the port's checkpoint and infers the same model.
    jparams, jcfg, *_ = jserving.load_serving_state(path, grid_size=4)
    got_params, got_cfg, mean, std, native, dataset = \
        serving.load_serving_state(path, grid_size=4)
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(jcfg)
    assert (dataset, native) == ("cifar10", NATIVE_SIZE["cifar10"])
    assert set(got_params) == set(jparams) == set(params)
    for k in params:
        torch.testing.assert_close(got_params[k], params[k], rtol=0, atol=0)
    scrambled = serving.load_serving_state(path, grid_size=4,
                                           rope_mixed_compat_scramble=True)[1]
    assert scrambled.rope_mixed_compat_scramble


def test_predictor_rejects_non_uint8():
    cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=1,
                    num_heads=2, pos_encoding="none")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    pred = serving.Predictor.from_params(params, cfg, MEAN, STD, 32,
                                         device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        pred.logits(np.zeros((1, 32, 32, 3), np.float32))
    assert pred.logits(uint8_images(1)[0]).shape == (1, 10)
