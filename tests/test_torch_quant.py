"""PyTorch port, int8 serving (vit_rpe_rope_tpu_torch/quant.py) against the
JAX package's quant.py on the same seeded numpy inputs, on the CPU.

Tolerances:

* quantize_tensor / quantize_params: the int8 weights and float32 scales
  bit-equal to JAX's on the same float32 weights, for every PE mode's key
  set (the same IEEE divide, round half to even and clip).
* q8_linear, q8_linear_static (float32 and bfloat16 inputs) and
  q8_linear_wo on identical int8 state and inputs: within 1e-6 relative L2
  of JAX's (the int32 sums are exact, the dequantization is JAX's order of
  float32 operations; w8a16's products of bf16 operands are exact in
  float32); and, as the JAX tests hold them, within 0.02 (0.03 static) of
  the float32 product.
* torch._int_mm behind the padding (16 more rows, widths to multiples of
  8): the exact int32 product, at 1 to 37 rows and widths 12, 16, 48, 10.
* apply_q8, 6 PE modes x 3 modes, on qparams carried from JAX by
  qparams_from_jax, both packages on the unfused attention: within 1e-5
  relative L2 of JAX apply_q8 for w8a8 and 2e-3 for the bfloat16 modes
  (tighter than 1e-2 / 2e-2: the bfloat16 GELU is JAX's formula op by op,
  so a few one-ulp flips at most), the same argmax. The port's kernel path
  (attention through the custom ops, their plain twins here) within the
  JAX tests' bounds of the port's own float32 forward: 0.05 (w8a8), 0.08
  (the other two).
* One whole-slice case per mode on the kernel path (the twins through the
  custom ops) against JAX apply_q8 through its Pallas kernels in interpret
  mode: the same bounds as above (bf16 products with the same rounding
  points on both sides), the same argmax; and on the streaming route with
  STREAMING_THRESHOLD lowered to 16 in both packages (N = 17, relative,
  the bias generated from the table, w8a16: bfloat16 q, k, v): 5e-3.
* calibrate_act_scales: within rtol 1e-3 of JAX's scales, in every PE mode
  (both on the unfused attention: float32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu import quant as jquant
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch import quant
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax, \
    qparams_from_jax

TINY = dict(img_size=8, patch_size=4, in_chans=1, embed_dim=32, depth=2,
            num_heads=2)
PE_NAMES = ["none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed"]
# apply_q8 vs JAX apply_q8 (relative L2), per mode.
JAX_TOL = {"w8a8": 1e-5, "w8a8-static": 2e-3, "w8a16": 2e-3}
# apply_q8 vs the float32 forward: the JAX tests' bounds.
F32_TOL = {"w8a8": 0.05, "w8a8-static": 0.08, "w8a16": 0.08}


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and the
    workers of a parallel test run do not compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def host(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def jax_state(pe, impl="reference", seed=0, calib=None, **kw):
    """(JAX cfg, JAX f32 params, JAX qparams) for TINY (or kw) in `pe`: the
    port's seeded init carried to JAX as numpy arrays."""
    cfg = JaxViTConfig(**{**TINY, **kw}, pos_encoding=pe,
                       attention_impl=impl)
    init = vit.init_params(torch.Generator().manual_seed(seed),
                           ViTConfig(**{**TINY, **kw}, pos_encoding=pe),
                           device="cpu")
    params = {k: jnp.asarray(v.numpy()) for k, v in init.items()}
    qparams = jquant.quantize_params(params, cfg, calib_images=calib)
    return cfg, params, qparams


def images(n=8, size=8, chans=1, seed=2):
    return np.random.default_rng(seed).normal(
        0, 1.0, (n, size, size, chans)).astype(np.float32)


def test_quantize_tensor_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    w = (rng.normal(0, 0.3, (16, 64)) *
         rng.uniform(0.01, 3.0, (16, 1))).astype(np.float32)
    w[3] = 0.0  # an all-zero channel takes scale 1
    jw, js = jquant.quantize_tensor(jnp.asarray(w))
    tw, ts_ = quant.quantize_tensor(torch.from_numpy(w))
    assert tw.dtype == torch.int8 and ts_.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    err = np.abs(w - tw.numpy() * ts_.numpy()[:, None])
    assert (err <= ts_.numpy()[:, None] / 2 + 1e-7).all()


@pytest.mark.parametrize("pe", PE_NAMES)
def test_quantize_params_bit_equal_to_jax(pe):
    jcfg, jparams, jq = jax_state(pe, poly_shared_heads=False)
    cfg = ViTConfig(**TINY, pos_encoding=pe, poly_shared_heads=False)
    params = params_from_jax(host(jparams), cfg)
    got = quant.quantize_params(
        {k: v for k, v in params.items() if k in jparams}, cfg)
    assert set(got) == set(jq)
    for key, want in jq.items():
        want = np.asarray(want)
        assert got[key].numpy().dtype == want.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
    assert "patch_embed.weight" not in got and "norm.weight" in got
    assert got["patch_embed.weight:q8"].shape == (32, 16)


def linear_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.0, (4, 7, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (32, 64)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("name,dtype", [
    ("q8_linear", "float32"), ("q8_linear_wo", "float32"),
    ("q8_linear_wo", "bfloat16"), ("q8_linear_static", "float32"),
    ("q8_linear_static", "bfloat16")])
def test_q8_linears_match_jax(name, dtype):
    x, w, b = linear_inputs(1)
    jw, js = jquant.quantize_tensor(jnp.asarray(w))
    tw, ts_ = quant.quantize_tensor(torch.from_numpy(w))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jargs, targs = (jw, js), (tw, ts_)
    if name == "q8_linear_static":
        a = jnp.max(jnp.abs(jnp.asarray(x))) / 127.0  # what calibration gives
        jargs += (a,)
        targs += (torch.from_numpy(np.asarray(a)),)
    want = np.asarray(getattr(jquant, name)(jx, *jargs, jnp.asarray(b))
                      .astype(jnp.float32))
    got_t = getattr(quant, name)(tx, *targs, torch.from_numpy(b))
    assert got_t.dtype == (torch.float32 if name == "q8_linear"
                           else tx.dtype)
    got = got_t.float().numpy()
    assert rel_l2(got, want) <= 1e-6, rel_l2(got, want)
    # ... and as close to the float32 product as the JAX tests hold it
    exact = x @ w.T + b
    assert rel_l2(got, exact) < (0.03 if name == "q8_linear_static"
                                 else 0.02)


@pytest.mark.parametrize("rows", [1, 5, 16, 17, 37])
@pytest.mark.parametrize("k,n", [(16, 10), (48, 10), (12, 24), (64, 32)])
def test_int_mm_padding_is_exact(rows, k, n):
    rng = np.random.default_rng(rows * 100 + k + n)
    x = rng.integers(-127, 128, (rows, k)).astype(np.int8)
    w = rng.integers(-127, 128, (n, k)).astype(np.int8)
    got = quant._int_mm(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and got.shape == (rows, n)
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int64) @ w.astype(np.int64).T)
    # float rows holding the int8 values (the static mode's input) too
    got_f = quant._int_mm(torch.from_numpy(x).float()[None], torch.from_numpy(w))
    np.testing.assert_array_equal(got_f[0].numpy(), got.numpy())
    assert quant.LAUNCHES_INT_MM == 0  # counted on CUDA tensors only


@pytest.mark.parametrize("mode", quant.Q8_MODES)
@pytest.mark.parametrize("pe", PE_NAMES)
def test_apply_q8_matches_jax(pe, mode):
    x = images()
    calib = jnp.asarray(x) if mode == "w8a8-static" else None
    jcfg, jparams, jq = jax_state(pe, calib=calib)
    if mode == "w8a8-static":
        assert "blocks.1.mlp.fc2.weight:act_scale" in jq
    want = np.asarray(jquant.apply_q8(jq, jnp.asarray(x), jcfg, mode=mode))
    cfg = ViTConfig(**TINY, pos_encoding=pe, attention_impl="reference")
    qparams = qparams_from_jax(host(jq), cfg)
    with torch.no_grad():
        got = quant.apply_q8(qparams, torch.from_numpy(x), cfg,
                             mode=mode).numpy()
        kcfg = dataclasses.replace(cfg, attention_impl="auto")
        before = tfa.LAUNCHES
        kernel = quant.apply_q8(qparams, torch.from_numpy(x), kcfg,
                                mode=mode).numpy()
        f32 = vit.apply(params_from_jax(host(jparams), kcfg),
                        torch.from_numpy(x), kcfg).numpy()
    assert tfa.LAUNCHES == before  # the CPU runs the twins
    if mode == "w8a8-static":  # the port's calibration against JAX's
        scales = quant.calibrate_act_scales(
            params_from_jax(host(jparams), cfg), torch.from_numpy(x), cfg)
        assert set(scales) == {k for k in jq if k.endswith(":act_scale")}
        for key, value in scales.items():
            assert value.dtype == torch.float32 and value.shape == ()
            np.testing.assert_allclose(float(value), float(jq[key]),
                                       rtol=1e-3, err_msg=key)
    assert got.dtype == np.float32 and got.shape == (8, 10)
    assert rel_l2(got, want) <= JAX_TOL[mode], (pe, mode, rel_l2(got, want))
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert rel_l2(kernel, f32) < F32_TOL[mode], (pe, mode, rel_l2(kernel, f32))


@pytest.mark.parametrize("mode", quant.Q8_MODES)
def test_apply_q8_kernel_path_matches_jax_pallas(mode):
    """The whole slice per mode: the port's kernel path (the custom ops'
    twins) against JAX apply_q8 through its Pallas kernels in interpret
    mode, rope-mixed."""
    x = images(seed=5)
    calib = jnp.asarray(x) if mode == "w8a8-static" else None
    jcfg, _, jq = jax_state("rope-mixed", impl="flash", seed=3, calib=calib)
    want = np.asarray(jquant.apply_q8(jq, jnp.asarray(x), jcfg, mode=mode))
    cfg = ViTConfig(**TINY, pos_encoding="rope-mixed")
    with torch.no_grad():
        got = quant.apply_q8(qparams_from_jax(host(jq), cfg),
                             torch.from_numpy(x), cfg, mode=mode).numpy()
    assert rel_l2(got, want) <= JAX_TOL[mode], rel_l2(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("pe,mode", [("relative", "w8a16")])
def test_apply_q8_streaming_route_matches_jax(monkeypatch, pe, mode):
    """Above STREAMING_THRESHOLD (lowered to 16 in both packages; N = 17)
    the quantized forward keeps the generated-bias marker: the streaming
    forward's twin (bfloat16 q, k, v in w8a16) against the JAX streaming
    kernel in interpret mode."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 16)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 16)
    kw = dict(img_size=16, patch_size=4)
    x = images(n=4, size=16, seed=7)
    jcfg, _, jq = jax_state(pe, impl="flash", **kw)
    want = np.asarray(jquant.apply_q8(jq, jnp.asarray(x), jcfg, mode=mode))
    cfg = ViTConfig(**{**TINY, **kw}, pos_encoding=pe)
    calls = []
    real = tfa.attention_stream_plain
    monkeypatch.setattr(tfa, "attention_stream_plain",
                        lambda *a, **k: calls.append(a[0].dtype) or real(*a, **k))
    with torch.no_grad():
        got = quant.apply_q8(qparams_from_jax(host(jq), cfg),
                             torch.from_numpy(x), cfg, mode=mode).numpy()
    dtype = torch.float32 if mode == "w8a8" else torch.bfloat16
    assert calls == [dtype] * cfg.depth
    tol = 1e-3 if mode == "w8a8" else 5e-3
    assert rel_l2(got, want) <= tol, rel_l2(got, want)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_calibrate_act_scales_over_a_list_of_batches():
    """A list of batches gives the maxima over all of them (one batch of
    every image), on the kernel path (the twins)."""
    x = images(seed=11)
    cfg = ViTConfig(**TINY, pos_encoding="rope-axial")
    params = vit.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    listed = quant.calibrate_act_scales(
        params, [torch.from_numpy(x[:4]), torch.from_numpy(x[4:])], cfg)
    whole = quant.calibrate_act_scales(params, torch.from_numpy(x), cfg)
    assert set(listed) == set(whole) and len(whole) == 2 + 4 * cfg.depth
    for key in whole:
        np.testing.assert_allclose(float(listed[key]), float(whole[key]),
                                   rtol=1e-6, err_msg=key)


def test_static_calibration_serves_other_batches():
    """Scales calibrated on one batch serve another batch of the same
    distribution (the JAX test's bound, 0.10, on the kernel path)."""
    rng = np.random.default_rng(13)
    calib, x = (rng.normal(0, 1.0, (8, 8, 8, 1)).astype(np.float32)
                for _ in range(2))
    cfg = ViTConfig(**TINY, pos_encoding="rope-axial")
    params = vit.init_params(torch.Generator().manual_seed(3), cfg,
                             device="cpu")
    with torch.no_grad():
        qparams = quant.quantize_params(params, cfg,
                                        calib_images=torch.from_numpy(calib))
        want = vit.apply(params, torch.from_numpy(x), cfg).numpy()
        got = quant.apply_q8(qparams, torch.from_numpy(x), cfg,
                             mode="w8a8-static").numpy()
    assert rel_l2(got, want) < 0.10


def test_static_mode_requires_calibration_and_modes_are_checked():
    cfg = ViTConfig(**TINY, pos_encoding="none")
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    qparams = quant.quantize_params(params, cfg)
    with pytest.raises(ValueError, match="act_scale"):
        quant.apply_q8(qparams, torch.zeros(1, 8, 8, 1), cfg,
                       mode="w8a8-static")
    with pytest.raises(ValueError, match="unknown int8 mode"):
        quant.apply_q8(qparams, torch.zeros(1, 8, 8, 1), cfg, mode="w4a4")


def test_qparams_from_jax_keeps_dtypes():
    x = jnp.asarray(images())
    jcfg, jparams, jq = jax_state("relative", calib=x)
    cfg = ViTConfig(**TINY, pos_encoding="relative")
    got = qparams_from_jax(host(jq), cfg)
    assert set(got) == set(jq)
    for key, want in jq.items():
        want = np.asarray(want)
        assert got[key].numpy().dtype == (np.float32 if want.dtype.kind == "f"
                                          else want.dtype), key
        np.testing.assert_array_equal(got[key].numpy(), want, err_msg=key)
    assert got["head.weight:act_scale"].shape == ()
    assert got["blocks.0.attn.qkv.weight:q8"].dtype == torch.int8
