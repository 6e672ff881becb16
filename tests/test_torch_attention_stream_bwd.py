"""PyTorch port, streaming attention backward: the plain twin of the CUDA
dq, dk/dv and dbias kernels against the JAX package's separate-pass
backward `_bwd_streaming` (Pallas interpret mode on the CPU, same tile sizes, same
lse), autograd through the port's streaming Function against jax.vjp of
`flash_attention` above a lowered streaming threshold, the twin against the
f32 oracle, and the routing. The kernels are tested on the card by
tests/test_torch_kernels_gpu.py.

Tolerances:
* twin (bf16 products) vs `_bwd_streaming`: 2e-3, abs + rel on dq, dk, dv
  (both round the operands, p and ds to bf16; one at a rounding boundary can
  round the other way after a last-ulp difference in exp()); the batch sums
  (dbias, dcos, dsin) 2e-3 of their largest entry;
* autograd end to end vs jax.vjp: the same numbers. none and rope-axial
  take the one-pass backward in both packages (its twin is held to the JAX
  kernel by tests/test_torch_attention_stream_bwd_fused.py), a materialized
  bias and rope-mixed the separate passes;
* twin (f32 products) vs autograd through the f32 oracle: 1e-4 (float32
  sums over 290 keys in another order);
* the separate passes' prologue twin (operands rounded once) vs the JAX
  package's rotation rounded to bf16: bit for bit; its delta vs the sum
  that the JAX package's `_bwd_streaming` forms: 1e-6 of the largest
  entry (float32 sums of D products in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention_stream import (REGIMES, SHAPE, jax_pe,
                                         stream_inputs, twin_pe)
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.ops import reference_attention as tref

SCALE = SHAPE[-1] ** -0.5


def cotangent(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_close_to_largest(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("regime", REGIMES)
def test_stream_bwd_twin_matches_jax_bwd_streaming(regime):
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=20)
    g = cotangent(SHAPE)
    bias, freqs, kw = jax_pe(extra)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jfa._forward_streaming_impl(
        jq, jk, jv, SCALE, bias, freqs, True, q_tile=128, kv_tile=128,
        want_lse=True, **kw)
    learn = regime == "rope-mixed"
    want = jfa._bwd_streaming(
        SCALE, jq, jk, jv, bias, freqs, out, jg, True, q_tile=128,
        kv_tile=128, want_dbias=bias is not None, want_dfreqs=learn, lse=lse,
        **kw)
    tkw = twin_pe(q, extra)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = tfa.attention_stream_bwd_plain(
        tq, tk, tv, torch.from_numpy(np.array(out)), torch.from_numpy(g),
        torch.from_numpy(np.array(lse)), SCALE, kv_tile=128,
        want_dbias=bias is not None, want_drot=learn, **tkw)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-3,
                                   atol=2e-3)
    assert (got[3] is None) == (want[3] is None)
    if bias is not None:
        assert_close_to_largest(got[3].numpy(), want[3], 2e-3)
    if learn:
        dfreqs = tfa._rot_grads_to_dfreqs(
            tq, tk, got[4], got[5],
            tuple(torch.from_numpy(x) for x in extra["freqs_cis"]))
        for x, y in zip(dfreqs, want[4]):
            assert_close_to_largest(x.numpy(), y, 2e-3)
    else:
        assert got[4] is None and got[5] is None


def both_thresholds(monkeypatch, value=128):
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", value)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", value)


@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed",
                                    "rel-bias", "poly-bias"])
def test_streaming_autograd_matches_jax_custom_vjp(regime, monkeypatch):
    """flash_attention end to end above the (lowered) threshold. rel-bias /
    poly-bias: a materialized bias that requires grad, as the model passes
    relative and polynomial PE up to 2048 tokens."""
    both_thresholds(monkeypatch)
    shape = (2, 3, 145, 16)
    base = {"rel-bias": "rel", "poly-bias": "poly"}.get(regime, regime)
    q, k, v, extra = stream_inputs(base, shape, seed=21)
    if base != regime:  # materialize from the table / the coefficients
        bias = tfa._dense_bias(shape[1], shape[2], "cpu",
                               **{kk: vv for kk, vv in
                                  twin_pe(q, extra).items()
                                  if kk in ("poly", "rel")})
        extra = {"bias": bias.numpy()}
    g = cotangent(shape, seed=8)
    bias, freqs, _ = jax_pe(extra)
    learn = regime == "rope-mixed"

    def f(q, k, v, bias, freqs):
        return jfa.flash_attention(q, k, v, SCALE, bias=bias, freqs_cis=freqs)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
                     freqs)
    dq, dk, dv, dbias, dfreqs = vjp(jnp.asarray(g))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kw = {}
    if "bias" in extra:
        kw["bias"] = torch.from_numpy(extra["bias"]).requires_grad_()
        leaves.append(kw["bias"])
    if "freqs_cis" in extra:
        kw["freqs_cis"] = tuple(torch.from_numpy(x).requires_grad_(learn)
                                for x in extra["freqs_cis"])
        if learn:
            leaves += kw["freqs_cis"]
    counts = (tfa.LAUNCHES_STREAM_FWD, tfa.LAUNCHES_STREAM_DQ,
              tfa.LAUNCHES_STREAM_DKV)
    out = tfa.flash_attention(*leaves[:3], SCALE, **kw)
    assert type(out.grad_fn).__name__ == "StreamingAttentionFunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert counts == (tfa.LAUNCHES_STREAM_FWD, tfa.LAUNCHES_STREAM_DQ,
                      tfa.LAUNCHES_STREAM_DKV)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(f(*map(jnp.asarray, (q, k, v)),
                                            bias, freqs)),
                               rtol=2e-3, atol=2e-3)
    for x, y in zip(got[:3], (dq, dk, dv)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=2e-3,
                                   atol=2e-3)
    if "bias" in extra:
        assert_close_to_largest(got[3].numpy(), dbias, 2e-3)
    if learn:
        for x, y in zip(got[3:], dfreqs):
            assert_close_to_largest(x.numpy(), y, 2e-3)


@pytest.mark.parametrize("regime", ["none", "bias", "rope-mixed"])
def test_stream_twins_f32_match_autograd_of_the_oracle(regime):
    """The two twins with f32 products are a forward and its exact
    derivative: held to torch autograd through the unfused oracle."""
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=22)
    g = torch.from_numpy(cotangent(SHAPE, seed=9))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    okw = {}
    if "bias" in extra:
        okw["bias"] = torch.from_numpy(extra["bias"]).requires_grad_()
        leaves.append(okw["bias"])
    if "freqs_cis" in extra:
        okw["freqs_cis"] = tuple(torch.from_numpy(x).requires_grad_()
                                 for x in extra["freqs_cis"])
        leaves += okw["freqs_cis"]
    ref = tref.attention(*leaves[:3], SCALE, **okw)
    want = torch.autograd.grad(ref, leaves, g)

    tkw = twin_pe(q, extra)
    tq, tk, tv = (x.detach() for x in leaves[:3])
    out, lse = tfa.attention_stream_plain(tq, tk, tv, SCALE, kv_tile=64,
                                          mm_dtype=torch.float32, **tkw)
    torch.testing.assert_close(out, ref.detach(), rtol=1e-5, atol=1e-5)
    got = tfa.attention_stream_bwd_plain(
        tq, tk, tv, out, g, lse, SCALE, kv_tile=64, mm_dtype=torch.float32,
        want_dbias="bias" in extra, want_drot="freqs_cis" in extra, **tkw)
    grads = list(got[:3])
    if "bias" in extra:
        grads.append(got[3])
    if "freqs_cis" in extra:
        grads += tfa._rot_grads_to_dfreqs(
            tq, tk, got[4], got[5],
            tuple(x.detach() for x in okw["freqs_cis"]))
    for x, y in zip(grads, want, strict=True):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)


def test_stream_bwd_wrapper_on_cpu_is_the_twin_and_recomputes_lse():
    q, k, v, extra = stream_inputs("bias", (1, 2, 600, 16), seed=23)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    bias = torch.from_numpy(extra["bias"])
    out, lse = tfa.attention_stream_fwd(q, k, v, 0.25, bias)
    g = torch.from_numpy(cotangent(q.shape))
    counts = (tfa.LAUNCHES_STREAM_DQ, tfa.LAUNCHES_STREAM_DKV,
              tfa.LAUNCHES_STREAM_DBIAS)
    got = tfa.attention_stream_bwd(q, k, v, out, g, lse, 0.25, bias,
                                   want_dbias=True)
    assert counts == (tfa.LAUNCHES_STREAM_DQ, tfa.LAUNCHES_STREAM_DKV,
                      tfa.LAUNCHES_STREAM_DBIAS)
    want = tfa.attention_stream_bwd_plain(q, k, v, out, g, lse, 0.25, bias,
                                          kv_tile=tfa.KV_TILE,
                                          want_dbias=True)
    for x, y in zip(got[:4], want[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # Without the forward's lse the wrapper recomputes it with f32 products;
    # the forward's came from bf16 products, so p moves by ~1e-2 relative.
    redone = tfa.attention_stream_bwd(q, k, v, out, g, None, 0.25, bias,
                                      want_dbias=True)
    for x, y in zip(redone[:3], want[:3]):
        torch.testing.assert_close(x, y, rtol=5e-2, atol=5e-2)
    with pytest.raises(ValueError, match="dbias needs the bias"):
        tfa.attention_stream_bwd(q, k, v, out, g, lse, 0.25, want_dbias=True)


@pytest.mark.parametrize("regime", ["poly", "rel"])
def test_frozen_generated_bias_trains_q_k_v(regime, monkeypatch):
    """Above the threshold a generated bias whose parameters need no
    gradient runs the one-pass backward with the bias generated again; the
    result is the separate passes' on the materialized bias."""
    both_thresholds(monkeypatch)
    shape = (1, 2, 145, 16)
    q, k, v, extra = stream_inputs(regime, shape, seed=24)
    g = torch.from_numpy(cotangent(shape, seed=10))
    kw = {kk: vv for kk, vv in twin_pe(q, extra).items()
          if kk in ("poly", "rel")}
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention(*leaves, 0.25, **kw),
                              leaves, g)
    bias = tfa._dense_bias(shape[1], shape[2], "cpu", **kw)
    want = torch.autograd.grad(tfa.flash_attention(*leaves, 0.25, bias=bias),
                               leaves, g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,budget_slabs,groups", [
    (16, None, 16), (16, 16, 16), (16, 15, 8), (16, 3, 3), (16, 0, 1),
    (9, 8, 5), (7, 2, 2), (1, None, 1), (1, 0, 1)])
def test_dbias_groups_cover_the_batch_within_the_budget(b, budget_slabs,
                                                        groups):
    """The dq kernel's dbias instance writes one float32 [H, N, N] slab of
    ds per group of ceil(B / groups) batches: one group per batch while the
    budget holds B slabs, else no more slabs than it holds (at least one),
    and no group empty."""
    h, n = 6, 577
    budget = None if budget_slabs is None else budget_slabs * h * n * n * 4
    got = tfa.dbias_groups(b, h, n, budget)
    assert got == groups
    per = -(-b // got)
    assert (got - 1) * per < b <= got * per
    if budget is not None:
        assert got == 1 or got * h * n * n * 4 <= budget


@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("n", [17, 290])
def test_prologue_twin_rounds_the_jax_operands_once(regime, n):
    """The separate passes' operands as the JAX kernels form them in every
    tile (`_rotate_bh` of q and k in float32 over `_prep_freqs`' tables, then
    bf16; bf16 v and g), once, in rows padded with zeros to
    stream_bwd_rows(N); delta as the JAX package's `_bwd_streaming` sums
    it."""
    shape = (2, 3, n, 16)
    q, k, v, extra = stream_inputs(regime, shape, seed=30)
    g, out = cotangent(shape, seed=31), cotangent(shape, seed=32)
    args = [torch.from_numpy(x) for x in (q, k, v, out, g)]
    kw = twin_pe(args[0], extra)
    ops, delta = tfa.attention_stream_bwd_prologue(*args, kw["cos"],
                                                   kw["sin"])
    assert ops.shape == (4, 2, 3, tfa.stream_bwd_rows(n), 16)
    assert ops.dtype == torch.bfloat16 and delta.shape == (2, 3, n)
    assert not ops[:, :, :, n:].any()
    _, freqs, _ = jax_pe(extra)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    if freqs is not None:
        cos, sin = jfa._prep_freqs(freqs, 3, n, jnp.float32)
        jq, jk = jfa._rotate_bh(jq, cos, sin), jfa._rotate_bh(jk, cos, sin)
    for got, want in zip(ops[:, :, :, :n], (jq, jk, v, g)):
        want = torch.from_numpy(np.array(
            jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32)))
        assert torch.equal(got.float(), want)
    want_delta = np.asarray(jnp.sum(jnp.asarray(g) * jnp.asarray(out),
                                    axis=-1))
    assert_close_to_largest(delta.numpy(), want_delta, 1e-6)


@pytest.mark.parametrize("n,rows,pitch", [
    (1, 128, 4), (16, 128, 16), (128, 128, 128), (129, 256, 132),
    (577, 640, 580), (2048, 2048, 2048), (4097, 4224, 4100),
    (16385, 16512, 16388)])
def test_separate_pass_rows_and_dbias_pitch(n, rows, pitch):
    """The prologue's scratch rows cover whole 128-row CTAs of both passes
    and the padded bias / dbias slab rows are whole 16-byte pieces, never
    more than one CTA or piece past N."""
    assert tfa.stream_bwd_rows(n) == rows
    assert rows % tfa.STREAM_BWD_ROWS == 0 and 0 <= rows - n < 128
    assert tfa.dbias_pitch(n) == pitch
    assert pitch % 4 == 0 and 0 <= pitch - n < 4


@pytest.mark.parametrize("b,budget_slabs,groups", [
    (16, None, 16), (16, 16, 16), (16, 15, 8), (16, 3, 3), (16, 0, 1),
    (9, 9, 9), (9, 2, 2), (1, 0, 1)])
def test_dbias_groups_at_the_slab_pitch(b, budget_slabs, groups):
    """The separate passes' slabs are [H, N, dbias_pitch(N)]: a budget of
    whole padded slabs holds that many groups (at most one per batch, at
    least one)."""
    h, n = 6, 577
    pitch = tfa.dbias_pitch(n)
    slab = h * n * pitch * 4
    budget = None if budget_slabs is None else budget_slabs * slab
    got = tfa.dbias_groups(b, h, n, budget, pitch)
    assert got == groups
    per = -(-b // got)
    assert (got - 1) * per < b <= got * per
    if budget is not None:
        assert got == 1 or got * slab <= budget


def test_separate_pass_wrapper_on_cpu_launches_no_prologue():
    """On the CPU the separate passes are the twin alone: no kernel count
    moves, the prologue's included."""
    q, k, v, extra = stream_inputs("rope-mixed", (1, 2, 70, 16), seed=33)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = twin_pe(args[0], extra)
    out, lse = tfa.attention_stream_fwd(*args, 0.25, **kw)
    g = torch.from_numpy(cotangent(q.shape, seed=34))
    counts = (tfa.LAUNCHES_STREAM_PROLOGUE, tfa.LAUNCHES_STREAM_DQ,
              tfa.LAUNCHES_STREAM_DKV)
    got = tfa.attention_stream_bwd(*args, out, g, lse, 0.25, want_drot=True,
                                   **kw)
    assert counts == (tfa.LAUNCHES_STREAM_PROLOGUE, tfa.LAUNCHES_STREAM_DQ,
                      tfa.LAUNCHES_STREAM_DKV)
    want = tfa.attention_stream_bwd_plain(*args, out, g, lse, 0.25,
                                          want_drot=True, **kw)
    for x, y in zip(got[:6], want[:6]):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
