"""PyTorch port, attention backward: the plain twin of the CUDA backward
kernel against jax.vjp of the JAX package's flash_attention (whose dense
backward is the Pallas `_dense_bwd_kernel`, run in interpret mode on the
CPU) and of its f32 twin flash_attention_hp, the autograd Function against
the twin called directly, and the routing. The kernel itself is tested on
the card by tests/test_torch_kernels_gpu.py.

Tolerances:
* twin (bf16 products) vs JAX flash_attention: 2e-3, abs + rel on dq, dk,
  dv — both round the operands, p and ds to bf16, but one at a rounding
  boundary can round the other way after a last-ulp difference in exp();
  the parameter gradients (dcoeff, dtable, dcos, dsin) sum such terms over
  the batch and the sequence, so 2e-3 of their largest entry;
* twin (f32 products) vs JAX flash_attention_hp: 1e-5, same forms (float32
  sums in another order);
* autograd Function on the CPU vs the twin called directly: exact (the
  Function runs the twin there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import make_inputs
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa

REGIMES = ["none", "poly", "rel", "rope-axial", "rope-mixed"]
SHAPES = [(2, 4, 17, 16), (2, 3, 65, 32)]


def cotangent(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def jax_grads(fn, q, k, v, extra, g):
    """jax.vjp of fn wrt q, k, v and the regime's learnable PE input ->
    list of numpy arrays [dq, dk, dv, (dcoeff | dtable | dcos, dsin)]."""
    scale = q.shape[-1] ** -0.5
    pe = {}
    if "poly" in extra:
        pe["poly"] = jnp.asarray(extra["poly"][0])
    if "rel" in extra:
        pe["rel"] = jnp.asarray(extra["rel"])
    if "freqs_cis" in extra:
        pe["freqs_cis"] = tuple(jnp.asarray(x) for x in extra["freqs_cis"])

    def f(q, k, v, pe):
        kw = dict(pe)
        if "poly" in kw:
            kw["poly"] = (kw["poly"], extra["poly"][1])
        return fn(q, k, v, scale, **kw)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pe)
    dq, dk, dv, dpe = vjp(jnp.asarray(g))
    out = [dq, dk, dv]
    if "poly" in dpe:
        out.append(dpe["poly"])
    if "rel" in dpe:
        out.append(dpe["rel"])
    if "freqs_cis" in dpe and extra["freqs_cis"][0].ndim == 3:
        out.extend(dpe["freqs_cis"])
    return [np.asarray(x) for x in out]


def torch_leaves(q, k, v, extra):
    """Torch q, k, v (+ the learnable PE input) requiring grad, and the
    flash_attention kwargs built on them."""
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kw = {}
    if "poly" in extra:
        coeff = torch.from_numpy(extra["poly"][0]).requires_grad_()
        leaves.append(coeff)
        kw["poly"] = (coeff, extra["poly"][1])
    if "rel" in extra:
        kw["rel"] = torch.from_numpy(extra["rel"]).requires_grad_()
        leaves.append(kw["rel"])
    if "freqs_cis" in extra:
        cos, sin = (torch.from_numpy(x) for x in extra["freqs_cis"])
        if cos.dim() == 3:  # rope-mixed: learnable per-head frequencies
            cos.requires_grad_()
            sin.requires_grad_()
            leaves += [cos, sin]
        kw["freqs_cis"] = (cos, sin)
    return leaves, kw


def assert_grads_close(got, want, tol):
    assert len(got) == len(want)
    for i, (x, y) in enumerate(zip(got, want)):
        x = x.detach().numpy()
        if i < 3:
            np.testing.assert_allclose(x, y, rtol=tol, atol=tol, err_msg=i)
        else:  # parameter gradients: sums over batch and sequence
            np.testing.assert_allclose(
                x, y, rtol=0, atol=tol * max(1.0, float(np.abs(y).max())),
                err_msg=i)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("regime", REGIMES)
def test_twin_grads_match_jax_flash(regime, shape):
    q, k, v, extra = make_inputs(regime, shape, seed=10)
    g = cotangent(shape)
    want = jax_grads(jfa.flash_attention, q, k, v, extra, g)
    leaves, kw = torch_leaves(q, k, v, extra)
    fwd, bwd = tfa.LAUNCHES, tfa.LAUNCHES_BWD
    out = tfa.flash_attention(*leaves[:3], shape[-1] ** -0.5, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert (tfa.LAUNCHES, tfa.LAUNCHES_BWD) == (fwd, bwd)  # CPU: twins only
    assert_grads_close(got, want, 2e-3)


@pytest.mark.parametrize("regime", REGIMES)
def test_twin_f32_products_match_jax_hp(regime):
    """The twin's algorithm with f32 operands against the JAX kernel's f32
    variant: same math, no bf16 rounding."""
    shape = SHAPES[0]
    q, k, v, extra = make_inputs(regime, shape, seed=11)
    g = cotangent(shape, seed=8)
    want = jax_grads(jfa.flash_attention_hp, q, k, v, extra, g)
    leaves, kw = torch_leaves(q, k, v, extra)
    scale = shape[-1] ** -0.5
    bias = tfa._dense_bias(shape[1], shape[2], "cpu", poly=kw.get("poly"),
                           rel=kw.get("rel"))
    cos = sin = None
    if "freqs_cis" in kw:
        cos, sin = tfa._kernel_freqs(kw["freqs_cis"], shape[1], shape[2],
                                     "cpu")
    qt, kt, vt = (x.detach() for x in leaves[:3])
    out = tfa.attention_plain(qt, kt, vt, scale, bias, cos, sin,
                              mm_dtype=torch.float32)
    learn_rot = regime == "rope-mixed"
    dq, dk, dv, dbias, dqr, dkr = tfa.attention_bwd_plain(
        qt, kt, vt, out, torch.from_numpy(g), scale,
        None if bias is None else bias.detach(), cos, sin,
        mm_dtype=torch.float32, want_dbias=bias is not None,
        want_drot=learn_rot)
    got = [dq, dk, dv]
    if bias is not None:  # dbias -> dcoeff / dtable through the generator
        got += torch.autograd.grad(bias, leaves[3:], dbias)
    if learn_rot:
        got += tfa._rot_grads_to_dfreqs(qt, kt, dqr, dkr, kw["freqs_cis"])
    assert_grads_close(got, want, 1e-5)


@pytest.mark.parametrize("regime", ["poly", "rope-mixed"])
def test_autograd_function_on_cpu_is_the_twin(regime):
    shape = SHAPES[1]
    q, k, v, extra = make_inputs(regime, shape, seed=12)
    g = torch.from_numpy(cotangent(shape, seed=9))
    leaves, kw = torch_leaves(q, k, v, extra)
    scale = shape[-1] ** -0.5
    got = torch.autograd.grad(
        tfa.flash_attention(*leaves[:3], scale, **kw), leaves, g)

    bias = tfa._dense_bias(shape[1], shape[2], "cpu", poly=kw.get("poly"))
    cos = sin = None
    if "freqs_cis" in kw:
        cos, sin = tfa._kernel_freqs(kw["freqs_cis"], shape[1], shape[2],
                                     "cpu")
    qt, kt, vt = (x.detach() for x in leaves[:3])
    fixed_bias = None if bias is None else bias.detach()
    out = tfa.attention_plain(qt, kt, vt, scale, fixed_bias, cos, sin)
    dq, dk, dv, dbias, dqr, dkr = tfa.attention_bwd_plain(
        qt, kt, vt, out, g, scale, fixed_bias, cos, sin,
        want_dbias=bias is not None, want_drot=cos is not None)
    want = [dq, dk, dv]
    if bias is not None:
        want += torch.autograd.grad(bias, leaves[3:], dbias)
    if cos is not None:
        want += tfa._rot_grads_to_dfreqs(qt, kt, dqr, dkr, kw["freqs_cis"])
    for x, y in zip(got, want, strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_bwd_wrapper_on_cpu_is_the_twin():
    q, k, v, extra = make_inputs("rel", SHAPES[0], seed=13)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    bias = tfa._dense_bias(4, 17, "cpu", rel=torch.from_numpy(extra["rel"]))
    out = tfa.attention_fwd(q, k, v, 0.25, bias)
    g = torch.from_numpy(cotangent(SHAPES[0]))
    before = tfa.LAUNCHES_BWD
    got = tfa.attention_bwd(q, k, v, out, g, 0.25, bias, want_dbias=True)
    assert tfa.LAUNCHES_BWD == before
    want = tfa.attention_bwd_plain(q, k, v, out, g, 0.25, bias,
                                   want_dbias=True)
    for x, y in zip(got, want):
        if x is None:
            assert y is None
        else:
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("ndim", [2, 3])
def test_rot_grads_to_dfreqs_matches_jax(ndim):
    rng = np.random.default_rng(14)
    b, h, n, d = 3, 2, 10, 8
    q, k, dqr, dkr = (rng.standard_normal((b, h, n, d)).astype(np.float32)
                      for _ in range(4))
    fshape = (n - 1, d // 2) if ndim == 2 else (h, n - 1, d // 2)
    freqs = tuple(rng.standard_normal(fshape).astype(np.float32)
                  for _ in range(2))
    want = jfa._rot_grads_to_dfreqs(*(jnp.asarray(x) for x in (q, k, dqr, dkr)),
                                    tuple(jnp.asarray(x) for x in freqs))
    got = tfa._rot_grads_to_dfreqs(*(torch.from_numpy(x)
                                     for x in (q, k, dqr, dkr)),
                                   tuple(torch.from_numpy(x) for x in freqs))
    for x, y in zip(got, want):
        assert x.shape == y.shape
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("h,n", [(1, 2049), (8, 1500)])
def test_training_on_the_streaming_route_raises(h, n):
    """Training on the streaming route raises nowhere any more (it raised
    for generated polynomial coefficients above STREAMING_THRESHOLD tokens
    until the one-pass backward was ported): above the threshold, and below
    it where the dense tiles do not fit, it trains without a PE and with a
    generated polynomial bias, whose coefficients' gradient agrees with
    autograd through the materialized bias (same kernels' twins for q, k, v;
    2e-3 of the largest entry: float32 sums of ds in another order)."""
    rng = np.random.default_rng(16)
    x = torch.zeros(1, h, n, 16, requires_grad=True)
    out = tfa.flash_attention(x, x, x, 0.25)
    assert type(out.grad_fn).__name__ == "StreamingAttentionFunctionBackward"
    (dx,) = torch.autograd.grad(out.sum(), x)
    assert dx.shape == x.shape and torch.isfinite(dx).all()
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (1, h, n, 16)).astype(np.float32)) for _ in range(4))
    coeff = torch.from_numpy(
        rng.standard_normal((h, 4)).astype(np.float32)
        * 45.0 ** -np.arange(4, dtype=np.float32)).requires_grad_()
    out = tfa.flash_attention(q, k, v, 0.25, poly=(coeff, 45))
    assert type(out.grad_fn).__name__ == "StreamingAttentionFunctionBackward"
    (dcoeff,) = torch.autograd.grad(out, coeff, g)
    bias = tfa._dense_bias(h, n, "cpu", poly=(coeff, 45))
    (want,) = torch.autograd.grad(
        tfa.flash_attention(q, k, v, 0.25, bias=bias), coeff, g)
    assert dcoeff.shape == coeff.shape
    torch.testing.assert_close(dcoeff, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


def test_eval_path_skips_the_autograd_function():
    q, k, v, extra = make_inputs("rope-mixed", SHAPES[0], seed=15)
    leaves, kw = torch_leaves(q, k, v, extra)
    with torch.no_grad():
        out = tfa.flash_attention(*leaves[:3], 0.25, **kw)
    assert out.grad_fn is None
    out = tfa.flash_attention(*leaves[:3], 0.25, **kw)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
