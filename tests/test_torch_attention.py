"""PyTorch port, attention: the plain twin of the CUDA attention kernel
against the JAX package's Pallas kernel (interpret mode on the CPU) and its
f32 twin, the oracle against the JAX oracle, the bias / rope preparation
helpers and routing. The kernel itself is tested on the card by
tests/test_torch_kernels_gpu.py.

Tolerances:
* twin (bf16 products) vs JAX flash_attention: 2e-3 — both round operands
  and p to bf16, but a p at a rounding boundary can round the other way
  after a last-ulp difference in exp();
* twin (f32 products) vs JAX flash_attention_hp, oracle vs oracle: 1e-5
  (float32 sums in another order);
* bf16 inputs: 1e-2, one bf16 ulp at |x| < 2 plus boundary flips.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu.ops import reference_attention as jref
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.ops import reference_attention as tref

REGIMES = ["none", "poly", "rel", "rope-axial", "rope-mixed"]
SHAPES = [(2, 4, 17, 16), (2, 3, 65, 32)]


def make_inputs(regime, shape, seed=0):
    """numpy q, k, v and the regime's PE inputs (as numpy)."""
    assert not os.environ.get("ATTN_TWO_PASS_SOFTMAX")
    rng = np.random.default_rng(seed)
    b, h, n, d = shape
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    extra = {}
    if regime == "poly":
        grid = int(round((n - 1) ** 0.5))
        extra["poly"] = (rng.standard_normal((h, 4)).astype(np.float32) * 0.05,
                         grid)
    elif regime == "rel":
        extra["rel"] = rng.standard_normal((h, 2 * n - 1)).astype(np.float32)
    elif regime.startswith("rope"):
        fshape = (n - 1, d // 2) if regime == "rope-axial" else (h, n - 1, d // 2)
        phase = rng.uniform(0.0, 6.0, fshape).astype(np.float32)
        extra["freqs_cis"] = (np.cos(phase), np.sin(phase))
    return q, k, v, extra


def jax_call(fn, q, k, v, extra, dtype=jnp.float32):
    kw = {}
    if "poly" in extra:
        kw["poly"] = (jnp.asarray(extra["poly"][0]), extra["poly"][1])
    if "rel" in extra:
        kw["rel"] = jnp.asarray(extra["rel"])
    if "freqs_cis" in extra:
        kw["freqs_cis"] = tuple(jnp.asarray(x) for x in extra["freqs_cis"])
    scale = q.shape[-1] ** -0.5
    out = fn(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
             scale, **kw)
    return np.asarray(out.astype(jnp.float32))


def torch_kwargs(extra):
    kw = {}
    if "poly" in extra:
        kw["poly"] = (torch.from_numpy(extra["poly"][0]), extra["poly"][1])
    if "rel" in extra:
        kw["rel"] = torch.from_numpy(extra["rel"])
    if "freqs_cis" in extra:
        kw["freqs_cis"] = tuple(torch.from_numpy(x) for x in extra["freqs_cis"])
    return kw


def twin_args(q, extra):
    """(bias, cos, sin) as flash_attention prepares them for the kernel."""
    return tfa.prepare_pe(q.shape[1], q.shape[2], "cpu",
                          **torch_kwargs(extra))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("regime", REGIMES)
def test_twin_matches_jax_flash(regime, shape):
    q, k, v, extra = make_inputs(regime, shape)
    want = jax_call(jfa.flash_attention, q, k, v, extra)
    before = tfa.LAUNCHES
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), shape[-1] ** -0.5,
                              **torch_kwargs(extra))
    assert tfa.LAUNCHES == before  # CPU tensors never reach the kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("regime", REGIMES)
def test_twin_f32_products_match_jax_hp(regime, shape):
    q, k, v, extra = make_inputs(regime, shape, seed=1)
    want = jax_call(jfa.flash_attention_hp, q, k, v, extra)
    bias, cos, sin = twin_args(q, extra)
    got = tfa.attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), shape[-1] ** -0.5, bias,
                              cos, sin, mm_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("regime", ["none", "rel", "rope-mixed"])
def test_twin_bf16_inputs_match_jax_flash(regime):
    q, k, v, extra = make_inputs(regime, SHAPES[1], seed=2)
    want = jax_call(jfa.flash_attention, q, k, v, extra, dtype=jnp.bfloat16)
    got = tfa.flash_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        SHAPES[1][-1] ** -0.5, **torch_kwargs(extra))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("regime", ["none", "rel", "rope-axial", "rope-mixed"])
def test_oracle_matches_jax_oracle(regime):
    q, k, v, extra = make_inputs(regime, SHAPES[1], seed=3)
    n = q.shape[2]
    jkw, tkw = {}, {}
    if "rel" in extra:
        bias = tfa._rel_bias_cols(torch.from_numpy(extra["rel"]), n, 0, n)
        tkw["bias"], jkw["bias"] = bias, jnp.asarray(bias.numpy())
    if "freqs_cis" in extra:
        tkw["freqs_cis"] = tuple(torch.from_numpy(x) for x in extra["freqs_cis"])
        jkw["freqs_cis"] = tuple(jnp.asarray(x) for x in extra["freqs_cis"])
    scale = q.shape[-1] ** -0.5
    got = tref.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), scale, **tkw)
    want = jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          scale, **jkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_bias_and_rope_prep_match_jax():
    rng = np.random.default_rng(4)
    coeff = rng.standard_normal((3, 4)).astype(np.float32)
    for args in ((5, 0, 26, 3), (7, 3, 9, 3)):
        np.testing.assert_allclose(
            tfa._poly_bias_cols(torch.from_numpy(coeff), 5, args[0], args[1],
                                args[2], args[3], n_valid=20).numpy(),
            np.asarray(jfa._poly_bias_cols(jnp.asarray(coeff), 5, *args,
                                           n_valid=20)), rtol=1e-6, atol=1e-6)
    table = rng.standard_normal((3, 51)).astype(np.float32)
    np.testing.assert_array_equal(
        tfa._rel_bias_cols(torch.from_numpy(table), 9, 4, 30, row_start=2).numpy(),
        np.asarray(jfa._rel_bias_cols(jnp.asarray(table), 9, 4, 30,
                                      row_start=2)))
    for shape in ((16, 8), (3, 16, 8)):
        cos = rng.standard_normal(shape).astype(np.float32)
        sin = rng.standard_normal(shape).astype(np.float32)
        for broadcast in (True, False):
            got = tfa._prep_freqs((torch.from_numpy(cos), torch.from_numpy(sin)),
                                  3, 24, torch.float32, broadcast=broadcast)
            want = jfa._prep_freqs((jnp.asarray(cos), jnp.asarray(sin)), 3, 24,
                                   jnp.float32, broadcast=broadcast)
            for tt, jj in zip(got, want):
                np.testing.assert_array_equal(tt.numpy(), np.asarray(jj))


def test_routing_predicate_matches_jax():
    for h in (1, 4, 6, 12):
        for n in (17, 65, 197, 577, 1025, 2048):
            for has_bias in (False, True):
                assert tfa._dense_attn_fits(h, n, has_bias) == \
                    jfa._dense_attn_fits(h, n, has_bias)
    assert tfa.STREAMING_THRESHOLD == jfa.STREAMING_THRESHOLD


@pytest.mark.parametrize("h,n", [(1, 2049), (8, 1500)])
def test_streaming_route_raises_until_ported(h, n):
    """The streaming route (above the threshold, or where the dense tiles do
    not fit) refuses nothing any more: it refused to train a generated
    relative table above STREAMING_THRESHOLD tokens until the one-pass
    backward was ported. The eval forward runs, and the table trains at both
    lengths: its gradient agrees with autograd through the materialized bias
    (2e-3 of the largest entry: float32 sums of ds in another order)."""
    x = torch.zeros(1, h, n, 16)
    out = tfa.flash_attention(x, x, x, 0.25)
    assert out.shape == x.shape and not out.any()
    rng = np.random.default_rng(17)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (1, h, n, 16)).astype(np.float32)) for _ in range(4))
    table = torch.from_numpy(rng.standard_normal(
        (h, 2 * n - 1)).astype(np.float32)).requires_grad_()
    with torch.no_grad():
        assert tfa.flash_attention(q, k, v, 0.25, rel=table).shape == x.shape
    out = tfa.flash_attention(q, k, v, 0.25, rel=table)
    (dtable,) = torch.autograd.grad(out, table, g)
    bias = tfa._dense_bias(h, n, "cpu", rel=table)
    (want,) = torch.autograd.grad(
        tfa.flash_attention(q, k, v, 0.25, bias=bias), table, g)
    assert dtable.shape == table.shape
    torch.testing.assert_close(dtable, want, rtol=0,
                               atol=2e-3 * float(want.abs().max()))


def test_bias_poly_rel_are_exclusive():
    x = torch.zeros(1, 2, 5, 16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfa.flash_attention(x, x, x, 0.25, bias=torch.zeros(2, 5, 5),
                            rel=torch.zeros(2, 9))


def test_wrapper_on_cpu_is_the_twin():
    q, k, v, extra = make_inputs("rope-mixed", SHAPES[0], seed=5)
    bias, cos, sin = twin_args(q, extra)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    before = tfa.LAUNCHES
    got = tfa.attention_fwd(*args, 0.25, bias, cos, sin)
    assert tfa.LAUNCHES == before
    torch.testing.assert_close(got, tfa.attention_plain(*args, 0.25, bias, cos,
                                                        sin), rtol=0, atol=0)
