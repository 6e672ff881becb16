"""PyTorch port, one-pass streaming attention backward: the plain twin of the
CUDA kernel against the JAX package's `_stream_bwd_fused_kernel` (launched by
`_bwd_streaming_fused` in Pallas interpret mode on the CPU, same tiles, same
lse and delta), segmented against unsegmented, at chunk offsets against
`streaming_chunk_bwd`, the separate-pass coefficient / table gradients
against `_bwd_streaming`, and autograd through `flash_attention(poly= /
rel=)` against jax.vjp above a lowered streaming threshold; the prologue's
twin (the operands rounded once) bit for bit against the JAX rotation
rounded to bf16, on a whole sequence and on a key chunk at offsets; the
scratch layout against the C entry's comment and the key segments against
the slab budget. The kernels are tested on the card by
tests/test_torch_kernels_gpu.py.

Tolerances:
* dq, dk, dv, twin (bf16 products) vs the like-tiled JAX kernel on the same
  lse: 2e-4, abs + rel. Both round the operands, p and ds to bf16 at the same
  points and add the same tiles in the same order, so most entries are equal
  (median error 0) and the rest differ by float32 sums in another order; but
  exp() differs in its last ulp between the two frameworks, and a p or ds at
  a bf16 rounding boundary then rounds the other way: one bf16 ulp (2^-9) of
  one term. Seen: up to 4e-5 of the largest entry;
* dcoeff, dtable vs the JAX kernel: 1e-4 of the gradient's largest entry.
  They are sums of the float32 ds over up to B*N*N elements that nearly
  cancel (sum_j ds_ij = 0 for every row without a mask), added up in another
  order on the two sides, so small entries carry the absolute float32 noise
  of the large ones. Seen: 1.5e-6 of the largest entry;
* autograd end to end vs jax.vjp: 2e-3 (abs + rel; parameter gradients 2e-3
  of the largest entry): each side's backward starts from its own forward's
  lse, and a last-ulp difference there moves every p of the row;
* twin (f32 products) vs autograd through the f32 oracle: 1e-4;
* segmented vs unsegmented, both the twin: 1e-5 of the largest entry
  (float32 partial sums over segments);
* the wrapper on the CPU against the twin at the JAX package's tiles: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention_stream import jax_pe, stream_inputs, twin_pe
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.ops import reference_attention as tref

FUSED_REGIMES = ["none", "rope-axial", "poly", "rel"]
SHAPE = (2, 3, 290, 16)  # N - 1 = 17^2; ragged against every tile size used
SCALE = SHAPE[-1] ** -0.5
TOL = 2e-4
PARAM_TOL = 1e-4
E2E_TOL = 2e-3


def cotangent(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_share(got, want, tol, err_msg=""):
    """|got - want| <= tol * max|want|."""
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=err_msg)


def case(regime, shape, seed, dtype="float32", tiles=(128, 128)):
    """Inputs of one backward on both sides: numpy-seeded q, k, v, g, the
    JAX streaming forward's out and lse, and delta = sum_d g * out."""
    q, k, v, extra = stream_inputs(regime, shape, seed=seed)
    g = cotangent(shape, seed=seed + 1)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    _, freqs, kw = jax_pe(extra)
    out, lse = jfa._forward_streaming_impl(
        jq, jk, jv, shape[-1] ** -0.5, None, freqs, True, q_tile=tiles[0],
        kv_tile=tiles[1], want_lse=True, **kw)
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    tdt = getattr(torch, dtype)
    tensors = [torch.from_numpy(x).to(tdt) for x in (q, k, v, g)]
    tensors += [torch.from_numpy(np.array(lse)),
                torch.from_numpy(np.array(delta))]
    return (jq, jk, jv, jg, lse, delta, freqs, kw), tensors, twin_pe(q, extra)


def compare(got, want, regime):
    for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert (got[3] is None) == (regime != "poly")
    assert (got[4] is None) == (regime != "rel")
    if regime == "poly":
        assert_share(got[3], want[3], PARAM_TOL, "dcoeff")
    if regime == "rel":
        assert_share(got[4], want[4], PARAM_TOL, "dtable")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_twin_matches_jax_fused_kernel(regime, dtype):
    (jq, jk, jv, jg, lse, delta, freqs, kw), tensors, tkw = case(
        regime, SHAPE, 30, dtype)
    want = jfa._bwd_streaming_fused(SCALE, jq, jk, jv, freqs, jg, lse, delta,
                                    True, q_tile=128, kv_tile=128, **kw)
    got = tfa.attention_stream_bwd_fused_plain(*tensors, SCALE, q_tile=128,
                                               kv_tile=128, **tkw)
    compare(got, want, regime)


@pytest.mark.parametrize("n,regime", [(70, "rel"), (129, "poly"),
                                      (200, "rope-axial")])
def test_fused_twin_at_ragged_lengths(n, regime):
    """Sequence lengths that end inside a 64-wide tile, on it and one past
    (n - 1 need not be a square: the polynomial's grid is rounded)."""
    shape = (1, 2, n, 16)
    (jq, jk, jv, jg, lse, delta, freqs, kw), tensors, tkw = case(
        regime, shape, 31, tiles=(64, 128))
    want = jfa._bwd_streaming_fused(0.25, jq, jk, jv, freqs, jg, lse, delta,
                                    True, q_tile=64, kv_tile=128, **kw)
    got = tfa.attention_stream_bwd_fused_plain(*tensors, 0.25, q_tile=64,
                                               kv_tile=128, **tkw)
    compare(got, want, regime)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_segmented_matches_unsegmented(regime, dtype, monkeypatch):
    """Forcing 128-key segments (three, the last ragged) through the wrapper
    reproduces the single sweep: dq and the parameter gradients are summed
    over segments, dk / dv segments written once, rope applied outside the
    sweep. The outputs keep the input dtype's single rounding."""
    _, tensors, tkw = case(regime, SHAPE, 32, dtype)
    tdt = getattr(torch, dtype)
    want = tfa.attention_stream_bwd_fused_plain(*tensors, SCALE,
                                                kv_tile=128, **tkw)
    calls = []
    real = tfa.attention_stream_bwd_fused_plain

    def counting(*args, **kwargs):
        calls.append(args[1].shape[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "attention_stream_bwd_fused_plain", counting)
    monkeypatch.setattr(tfa, "_fused_kv_seg_cols", lambda b, h, n, d: 128)
    got = tfa.attention_stream_bwd_fused(*tensors, SCALE, out_dtype=tdt,
                                         **tkw)
    assert calls == [128, 128, 34]
    for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        assert x.dtype == tdt
        if dtype == "bfloat16":  # one rounding of the float32 result
            y = y.to(tdt)
            mismatch = float((x != y).float().mean())
            assert mismatch < 1e-3, (name, mismatch)
        else:
            assert_share(x, y.numpy(), 1e-5, name)
    if regime == "poly":
        assert_share(got[3], want[3].numpy(), 1e-5, "dcoeff")
    if regime == "rel":
        assert_share(got[4], want[4].numpy(), 1e-5, "dtable")


def test_fused_segmented_matches_jax_segmented(monkeypatch):
    """Both packages' segment loops with forced 128-key segments, relative
    bias."""
    (jq, jk, jv, jg, lse, delta, freqs, kw), tensors, tkw = case(
        "rel", SHAPE, 33)
    monkeypatch.setattr(jfa, "_fused_kv_seg_cols",
                        lambda d_, qt, kvt, fixed_extra=0: 128)
    monkeypatch.setattr(tfa, "_fused_kv_seg_cols", lambda b, h, n, d: 128)
    want = jfa._bwd_streaming_fused(SCALE, jq, jk, jv, freqs, jg, lse, delta,
                                    True, q_tile=128, kv_tile=128, **kw)
    got = tfa.attention_stream_bwd_fused(*tensors, SCALE, **tkw)
    compare(got, want, "rel")


@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_bwd_matches_jax_streaming_chunk_bwd(regime):
    """One (shard, chunk) pair of a ring: query rows [100, 290) against the
    90 keys from global token 130, with the lse and delta of the whole
    row."""
    (jq, jk, jv, jg, lse, delta, _, kw), tensors, tkw = case(regime, SHAPE,
                                                             34)
    row0, col0, n = 100, 130, SHAPE[2]
    rows, cols = slice(row0, n), slice(col0, col0 + 90)
    want = jfa.streaming_chunk_bwd(
        jq[:, :, rows], jk[:, :, cols], jv[:, :, cols], jg[:, :, rows],
        lse[:, :, rows], delta[:, :, rows], SCALE, row0, col0, n,
        interpret=True, **kw)
    q, k, v, g, tlse, tdelta = tensors
    pe = {key: tkw[key] for key in ("poly", "rel") if key in tkw}
    got = tfa.streaming_chunk_bwd(
        q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows],
        tlse[:, :, rows], tdelta[:, :, rows], SCALE, row0, col0, n, **pe)
    assert got[0].shape == (2, 3, n - row0, 16) and got[1].shape == (
        2, 3, 90, 16)
    for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL,
                                   atol=TOL, err_msg=name)
    assert (got[3] is None) == (want[3] is None)
    if want[3] is not None:
        assert got[3].shape == want[3].shape
        assert_share(got[3], want[3], PARAM_TOL, "dparam")


def test_fused_twin_masks_keys_beyond_chunk_cols():
    """A key extent padded beyond its valid width, as the JAX package's
    `_bwd_fused_segmented` hands it over (`chunk_cols`): the padded keys get
    no gradient and give none."""
    (jq, jk, jv, jg, lse, delta, _, kw), tensors, tkw = case("rel", SHAPE,
                                                             35)
    n = SHAPE[2]
    want = jfa._bwd_streaming_fused(
        SCALE, jq, jk, jv, None, jg, lse, delta, True, q_tile=128,
        kv_tile=128, col0=jnp.int32(0), chunk_cols=jnp.int32(200), **kw)
    q, k, v, g, tlse, tdelta = tensors
    got = tfa.attention_stream_bwd_fused_plain(
        q, k, v, g, tlse, tdelta, SCALE, rel=tkw["rel"], q_tile=128,
        kv_tile=128, chunk_cols=200)
    compare(got, want, "rel")
    assert float(got[1][:, :, 200:].abs().max()) == 0.0
    assert float(got[2][:, :, 200:].abs().max()) == 0.0
    assert n > 200


@pytest.mark.parametrize("regime", ["poly", "rel"])
def test_separate_pass_dparam_twin_matches_jax_bwd_streaming(regime):
    """`attention_stream_bwd_plain(want_dparam=True)` against the dcoeff /
    dtable kernels `_bwd_streaming` launches for poly= / rel=."""
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=36)
    g = cotangent(SHAPE, seed=37)
    _, _, kw = jax_pe(extra)
    jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
    out, lse = jfa._forward_streaming_impl(
        jq, jk, jv, SCALE, None, None, True, q_tile=128, kv_tile=128,
        want_lse=True, **kw)
    want = jfa._bwd_streaming(SCALE, jq, jk, jv, None, None, out, jg, True,
                              q_tile=128, kv_tile=128, lse=lse, **kw)
    got = tfa.attention_stream_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(out)), torch.from_numpy(g),
        torch.from_numpy(np.array(lse)), SCALE, kv_tile=128,
        want_dparam=True, **twin_pe(q, extra))
    assert len(got) == 8
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=TOL,
                                   atol=TOL)
    if regime == "poly":
        assert got[7] is None
        assert_share(got[6], want[5], PARAM_TOL, "dcoeff")
    else:
        assert got[6] is None
        assert_share(got[7], want[6], PARAM_TOL, "dtable")
    # and the one-pass twin computes the same sums once
    delta = (torch.from_numpy(g) * torch.from_numpy(np.array(out))).sum(-1)
    fused = tfa.attention_stream_bwd_fused_plain(
        *(torch.from_numpy(x) for x in (q, k, v, g)),
        torch.from_numpy(np.array(lse)), delta, SCALE, q_tile=290,
        kv_tile=128, **twin_pe(q, extra))
    assert_share(fused[3] if regime == "poly" else fused[4],
                 (got[6] if regime == "poly" else got[7]).numpy(), 1e-5)


@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_twin_f32_matches_autograd_of_the_oracle(regime):
    """With float32 products the streaming forward twin and the one-pass
    backward twin are a function and its exact derivative, the coefficients'
    and the table's gradient included: held to torch autograd through the
    unfused oracle on the materialized bias, 1e-4 abs + rel (float32 sums in
    another order), parameter gradients 1e-4 of their largest entry."""
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=41)
    if regime == "poly":
        # Scaled by grid^-k: unscaled, the cubic term reaches 1e3 at distance
        # 32 and saturates the softmax, where the gradient of the oracle
        # itself is float32 noise.
        coeff, grid = extra["poly"]
        extra["poly"] = (coeff * np.float32(grid) ** -np.arange(
            4, dtype=np.float32), grid)
    g = torch.from_numpy(cotangent(SHAPE, seed=42))
    tkw = twin_pe(q, extra)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    okw = {}
    if "freqs_cis" in extra:
        okw["freqs_cis"] = tuple(torch.from_numpy(x)
                                 for x in extra["freqs_cis"])
    if regime == "poly":
        leaves.append(tkw["poly"][0].requires_grad_())
    elif regime == "rel":
        leaves.append(tkw["rel"].requires_grad_())
    if len(leaves) == 4:
        okw["bias"] = tfa._dense_bias(SHAPE[1], SHAPE[2], "cpu",
                                      poly=tkw.get("poly"),
                                      rel=tkw.get("rel"))
    want = torch.autograd.grad(tref.attention(*leaves[:3], SCALE, **okw),
                               leaves, g)
    tq, tk, tv = (x.detach() for x in leaves[:3])
    tkw = {key: (value.detach() if isinstance(value, torch.Tensor) else value)
           for key, value in tkw.items()}
    if regime == "poly":
        tkw["poly"] = (tkw["poly"][0].detach(), tkw["poly"][1])
    out, lse = tfa.attention_stream_plain(tq, tk, tv, SCALE, kv_tile=64,
                                          mm_dtype=torch.float32, **tkw)
    got = tfa.attention_stream_bwd_fused_plain(
        tq, tk, tv, g, lse, (g * out).sum(-1), SCALE, q_tile=64, kv_tile=128,
        mm_dtype=torch.float32, **tkw)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-4)
    if len(leaves) == 4:
        assert_share(got[3] if regime == "poly" else got[4], want[3].numpy(),
                     1e-4, regime)


def both_thresholds(monkeypatch, value=128):
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", value)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", value)


@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_autograd_matches_jax_custom_vjp(regime, monkeypatch):
    """flash_attention end to end above the (lowered) threshold: both
    packages generate the bias in their kernels and take the one-pass
    backward; the coefficients' / the table's gradient comes out of it."""
    both_thresholds(monkeypatch)
    shape = (2, 3, 145, 16)
    q, k, v, extra = stream_inputs(regime, shape, seed=38)
    g = cotangent(shape, seed=39)
    _, freqs, kw = jax_pe(extra)
    param = kw["poly"][0] if regime == "poly" else kw.get("rel")

    def f(q, k, v, param):
        pe = {}
        if regime == "poly":
            pe["poly"] = (param, kw["poly"][1])
        elif regime == "rel":
            pe["rel"] = param
        return jfa.flash_attention(q, k, v, 0.25, freqs_cis=freqs, **pe)

    want_out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            param)
    want = vjp(jnp.asarray(g))

    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tkw = {}
    if "freqs_cis" in extra:
        tkw["freqs_cis"] = tuple(torch.from_numpy(x)
                                 for x in extra["freqs_cis"])
    if regime == "poly":
        leaves.append(torch.from_numpy(extra["poly"][0]).requires_grad_())
        tkw["poly"] = (leaves[3], extra["poly"][1])
    elif regime == "rel":
        leaves.append(torch.from_numpy(extra["rel"]).requires_grad_())
        tkw["rel"] = leaves[3]
    counts = (tfa.LAUNCHES_STREAM_FWD, tfa.LAUNCHES_STREAM_FUSED,
              tfa.LAUNCHES_STREAM_DQ, tfa.LAUNCHES_STREAM_DKV)
    out = tfa.flash_attention(*leaves[:3], 0.25, **tkw)
    assert type(out.grad_fn).__name__ == "StreamingAttentionFunctionBackward"
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert counts == (tfa.LAUNCHES_STREAM_FWD, tfa.LAUNCHES_STREAM_FUSED,
                      tfa.LAUNCHES_STREAM_DQ, tfa.LAUNCHES_STREAM_DKV)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=E2E_TOL, atol=E2E_TOL)
    for x, y in zip(got[:3], want[:3]):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=E2E_TOL,
                                   atol=E2E_TOL)
    if len(leaves) == 4:
        assert got[3].shape == leaves[3].shape
        assert_share(got[3], want[3], E2E_TOL, regime)


def test_fused_wrapper_on_cpu_is_the_twin_at_the_jax_tiles():
    shape = (1, 2, 600, 16)  # three query tiles of 256, two key tiles of 512
    _, tensors, tkw = case("poly", shape, 40, tiles=(256, 512))
    counts = (tfa.LAUNCHES_STREAM_FUSED, tfa.LAUNCHES_STREAM_DCOEFF,
              tfa.LAUNCHES_STREAM_DTABLE)
    got = tfa.attention_stream_bwd_fused(*tensors, 0.25, **tkw)
    assert counts == (tfa.LAUNCHES_STREAM_FUSED, tfa.LAUNCHES_STREAM_DCOEFF,
                      tfa.LAUNCHES_STREAM_DTABLE)  # CPU tensors never launch
    want = tfa.attention_stream_bwd_fused_plain(
        *tensors, 0.25, q_tile=256, kv_tile=jfa.KV_TILE, **tkw)
    for x, y in zip(got[:4], want[:4]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert got[4] is None
    # p = exp(s - lse) needs no running max: other tiles only reorder sums.
    other = tfa.attention_stream_bwd_fused_plain(
        *tensors, 0.25, q_tile=64, kv_tile=64, **tkw)
    for x, y in zip(other[:3], want[:3]):
        assert_share(x, y.numpy(), 1e-5)


def test_fused_wrapper_refuses_what_the_jax_function_refuses():
    x = torch.zeros(1, 2, 40, 16)
    stats = torch.zeros(1, 2, 40)
    with pytest.raises(ValueError, match="covers L=30 tokens < sequence 40"):
        tfa.attention_stream_bwd_fused(x, x, x, x, stats, stats, 0.25,
                                       rel=torch.zeros(2, 59))
    with pytest.raises(ValueError, match="covers L=30"):
        jfa._bwd_streaming_fused(0.25, *(jnp.zeros((1, 2, 40, 16)),) * 3,
                                 None, jnp.zeros((1, 2, 40, 16)),
                                 jnp.zeros((1, 2, 40)), jnp.zeros((1, 2, 40)),
                                 True, rel=jnp.zeros((2, 59)))
    cos = torch.ones(1, 40, 8)
    with pytest.raises(ValueError, match="whole sequences"):
        tfa.attention_stream_bwd_fused(x, x[:, :, :20], x[:, :, :20], x,
                                       stats, stats, 0.25, cos, 0 * cos)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfa.attention_stream_bwd_fused(x, x, x, x, stats, stats, 0.25,
                                       poly=(torch.zeros(2, 3), 6),
                                       rel=torch.zeros(2, 79))


@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("n", [17, 290])
def test_fused_prologue_twin_rounds_the_jax_operands_once(regime, n):
    """The one-pass backward's operands as the JAX kernel forms them in
    every tile (`_rotate_bh` of q and k in float32 over `_prep_freqs'`
    tables, then bf16; bf16 v and g), once, in rows padded with zeros to
    stream_bwd_rows(N); and as the separate passes' prologue forms them."""
    shape = (2, 3, n, 16)
    q, k, v, extra = stream_inputs(regime, shape, seed=50)
    g = cotangent(shape, seed=51)
    args = [torch.from_numpy(x) for x in (q, k, v, g)]
    kw = twin_pe(args[0], extra)
    before = tfa.LAUNCHES_STREAM_FUSED_PROLOGUE
    got = tfa.attention_stream_bwd_fused_prologue(*args, kw["cos"],
                                                  kw["sin"])
    assert tfa.LAUNCHES_STREAM_FUSED_PROLOGUE == before  # the twin on the CPU
    rows = tfa.stream_bwd_rows(n)
    _, freqs, _ = jax_pe(extra)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    if freqs is not None:
        cos, sin = jfa._prep_freqs(freqs, 3, n, jnp.float32)
        jq, jk = jfa._rotate_bh(jq, cos, sin), jfa._rotate_bh(jk, cos, sin)
    for x, want in zip(got, (jq, jk, v, g)):
        assert x.shape == (2, 3, rows, 16) and x.dtype == torch.bfloat16
        assert not x[:, :, n:].any()
        want = torch.from_numpy(np.array(
            jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32)))
        assert torch.equal(x[:, :, :n].float(), want)
    ops, _ = tfa.attention_stream_bwd_prologue(*args[:3], args[3], args[3],
                                               kw["cos"], kw["sin"])
    for x, y in zip(got, ops):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rows,keys", [(190, 90), (17, 129), (1, 1)])
def test_fused_prologue_twin_on_a_key_chunk(rows, keys):
    """On a key chunk at offsets (q rows [100, 100 + rows), keys [130, 130 +
    keys) of a longer sequence; no tables) the prologue only rounds: q, g
    padded to stream_bwd_rows(rows), k, v to stream_bwd_rows(keys), bit for
    bit the JAX kernel's bf16 operands of those rows."""
    q, k, v, _ = stream_inputs("none", (2, 3, 290, 16), seed=52)
    g = cotangent((2, 3, 290, 16), seed=53)
    r, c = slice(100, 100 + rows), slice(130, 130 + keys)
    parts = (q[:, :, r], k[:, :, c], v[:, :, c], g[:, :, r])
    got = tfa.attention_stream_bwd_fused_prologue(
        *(torch.from_numpy(np.ascontiguousarray(x)) for x in parts))
    for x, want, n in zip(got, parts, (rows, keys, keys, rows)):
        assert x.shape == (2, 3, tfa.stream_bwd_rows(n), 16)
        assert not x[:, :, n:].any()
        want = np.array(jnp.asarray(want).astype(jnp.bfloat16).astype(
            jnp.float32))
        assert torch.equal(x[:, :, :n].float(), torch.from_numpy(want))


@pytest.mark.parametrize("b,h,n,nk,d", [
    (4, 4, 4097, 4097, 32), (2, 3, 290, 90, 16), (1, 4, 16384, 66048, 32),
    (16, 6, 577, 577, 64), (1, 1, 1, 1, 16)])
def test_fused_scratch_shapes_agree_with_the_c_entry(b, h, n, nk, d):
    """attn_stream_bwd_fused.cu's entry comment: with NQP, NKP = N, NK
    rounded up to 128, key tiles = ceil(NK / 128) and slabs = ceil(key
    tiles / CLUSTER), the scratch holds f32 dq slabs [slabs, B, H, NQP, D]
    and then the bf16 operands qf [B, H, NQP, D], kf and bf16 v [B, H, NKP,
    D], bf16 g [B, H, NQP, D]; CLUSTER is FUSED_CLUSTER."""
    source = tfa.STREAM_FUSED_SOURCE.read_text()
    assert f"constexpr int CLUSTER = {tfa.FUSED_CLUSTER};" in source
    nqp, nkp = -(-n // 128) * 128, -(-nk // 128) * 128
    slabs = -(-(-(-nk // 128)) // tfa.FUSED_CLUSTER)
    assert tfa.fused_slabs(nk) == slabs
    assert tfa.fused_scratch_shapes(b, h, n, nk, d) == (
        (slabs, b, h, nqp, d), (b * h * (2 * nqp + 2 * nkp) * d,))
    ops = torch.arange(b * h * (2 * nqp + 2 * nkp) * d)
    qf, kf, vb, gb = tfa._fused_operands(ops, b, h, n, nk, d)
    assert qf.shape == gb.shape == (b, h, nqp, d)
    assert kf.shape == vb.shape == (b, h, nkp, d)
    assert int(kf.flatten()[0]) == b * h * nqp * d  # in the C entry's order
    assert int(gb.flatten()[0]) == b * h * (nqp + 2 * nkp) * d


@pytest.mark.parametrize("b,h,n,keys,d,segments", [
    (1, 4, 65537, 65537, 32, {8: 3, 4: 5, 1: 17}),
    (4, 4, 4097, 4097, 32, None), (2, 4, 16385, 16385, 32, None),
    (16, 6, 577, 577, 64, None), (4, 4, 2048, 4608, 32, None),
    (1, 4, 16384, 66048, 32, {8: 1, 4: 2, 1: 5})])
def test_fused_segments_hold_the_slabs_within_the_budget(b, h, n, keys, d,
                                                         segments):
    """One launch's slabs (one f32 [B, H, stream_bwd_rows(N), D] slab per
    cluster) stay within FUSED_SCRATCH_BYTES at the repo's shapes (the
    long-sequence model at N = 4,097 / 16,385, ViT-S/16@384, the bounded
    step's q-chunks of 2,048 and 16,384 rows, the monolithic step at N =
    65,537), a launch takes whole clusters, and the monolithic step at N =
    65,537 and the bounded step's q-chunk there take the segments that the
    cluster size implies."""
    cols = tfa._fused_kv_seg_cols(b, h, n, d)
    cluster_keys = tfa.STREAM_BWD_ROWS * tfa.FUSED_CLUSTER
    assert cols % cluster_keys == 0
    slab = b * h * tfa.stream_bwd_rows(n) * d * 4
    assert tfa.fused_slabs(cols) * slab <= tfa.FUSED_SCRATCH_BYTES
    assert (tfa.fused_slabs(cols) + 1) * slab > tfa.FUSED_SCRATCH_BYTES
    if segments is not None:
        assert -(-keys // cols) == segments[tfa.FUSED_CLUSTER]
        if n == 65537:  # CTAs per launch
            assert tfa.fused_slabs(cols) * tfa.FUSED_CLUSTER * h == {
                8: 992, 4: 496, 1: 124}[tfa.FUSED_CLUSTER]
    else:
        assert keys <= cols  # one launch
