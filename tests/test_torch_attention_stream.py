"""PyTorch port, streaming attention forward: the plain twin of the CUDA
streaming kernel against the JAX package's Pallas `_stream_kernel` (launched
by `_forward_streaming_impl` in interpret mode on the CPU, with the same
tile sizes) and against the f32 kernel variant, the lse recompute, the
generated biases, ragged lengths and the table check. The kernel itself is
tested on the card by tests/test_torch_kernels_gpu.py.

Tolerances:
* twin (bf16 products) vs the JAX kernel, same key tile: out 2e-3 (both
  round operands and p to bf16 against the same running max, but a p at a
  rounding boundary can round the other way after a last-ulp difference in
  exp()), lse 1e-4 (float32 sums in another order);
* bf16 inputs: out 1e-2, one bf16 ulp at |x| < 2 plus boundary flips;
* twin (f32 products) vs JAX flash_attention_hp: 1e-5;
* the forward's prologue twin (keys and values rounded once) vs the JAX
  package's rotation rounded to bf16: bit for bit, and the twin on its
  operands vs the JAX kernel as above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_attention import make_inputs, torch_kwargs
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa

# "bias": a materialized [H, N, N] tensor; "poly" / "rel": generated per tile.
REGIMES = ["none", "bias", "poly", "rel", "rope-axial", "rope-mixed"]
SHAPE = (2, 3, 290, 16)  # N - 1 = 17^2; ragged against every tile size used


def stream_inputs(regime, shape, seed=0):
    """numpy q, k, v and the regime's PE inputs: make_inputs, with "bias" a
    materialized relative bias."""
    q, k, v, extra = make_inputs("rel" if regime == "bias" else regime, shape,
                                 seed)
    if regime == "bias":
        n = shape[2]
        table = torch.from_numpy(extra.pop("rel"))
        extra["bias"] = tfa._rel_bias_cols(table, n, 0, n).numpy()
    return q, k, v, extra


def jax_pe(extra):
    """(bias, freqs_cis, kwargs) of the JAX streaming functions."""
    bias = jnp.asarray(extra["bias"]) if "bias" in extra else None
    freqs = (tuple(jnp.asarray(x) for x in extra["freqs_cis"])
             if "freqs_cis" in extra else None)
    kw = {}
    if "poly" in extra:
        kw["poly"] = (jnp.asarray(extra["poly"][0]), extra["poly"][1])
    if "rel" in extra:
        kw["rel"] = jnp.asarray(extra["rel"])
    return bias, freqs, kw


def twin_pe(q, extra):
    """The twin's keyword arguments: bias / cos / sin / poly / rel."""
    kw = torch_kwargs(extra)
    freqs = kw.pop("freqs_cis", None)
    _, cos, sin = tfa.prepare_pe(q.shape[1], q.shape[2], "cpu",
                                 freqs_cis=freqs)
    if "bias" in extra:
        kw["bias"] = torch.from_numpy(extra["bias"])
    return dict(kw, cos=cos, sin=sin)


def jax_stream(q, k, v, extra, tiles, dtype=jnp.float32,
               mm_dtype=jnp.bfloat16):
    bias, freqs, kw = jax_pe(extra)
    out, lse = jfa._forward_streaming_impl(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        q.shape[-1] ** -0.5, bias, freqs, True, mm_dtype=mm_dtype,
        q_tile=tiles[0], kv_tile=tiles[1], want_lse=True, **kw)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("regime", REGIMES)
def test_stream_twin_matches_jax_stream_kernel(regime, dtype):
    q, k, v, extra = stream_inputs(regime, SHAPE)
    want, want_lse = jax_stream(q, k, v, extra, (128, 128),
                                dtype=getattr(jnp, dtype))
    tdtype = getattr(torch, dtype)
    got, lse = tfa.attention_stream_plain(
        *(torch.from_numpy(x).to(tdtype) for x in (q, k, v)),
        SHAPE[-1] ** -0.5, kv_tile=128, **twin_pe(q, extra))
    assert got.dtype == tdtype and lse.dtype == torch.float32
    tol = 2e-3 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [70, 129, 200])
def test_stream_twin_at_ragged_lengths(n):
    """Sequence lengths that end inside a 64-key tile, on it and one past."""
    shape = (1, 2, n, 16)
    q, k, v, extra = stream_inputs("rope-mixed", shape, seed=1)
    want, want_lse = jax_stream(q, k, v, extra, (64, 64))
    got, lse = tfa.attention_stream_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), 0.25, kv_tile=64,
        **twin_pe(q, extra))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("regime", REGIMES)
def test_stream_twin_f32_products_match_jax_hp(regime):
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=2)
    bias, freqs, kw = jax_pe(extra)
    want = jfa.flash_attention_hp(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 0.25, bias=bias,
                                  freqs_cis=freqs, **kw)
    got, _ = tfa.attention_stream_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), 0.25, kv_tile=64,
        mm_dtype=torch.float32, **twin_pe(q, extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("regime", ["bias", "poly", "rope-mixed"])
def test_streaming_lse_matches_jax(regime):
    q, k, v, extra = stream_inputs(regime, SHAPE, seed=3)
    bias, freqs, kw = jax_pe(extra)
    want = jfa._streaming_lse(jnp.asarray(q), jnp.asarray(k), 0.25, bias,
                              freqs, SHAPE[2], **kw)
    got = tfa.streaming_lse(torch.from_numpy(q), torch.from_numpy(k), 0.25,
                            **twin_pe(q, extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_stream_wrapper_on_cpu_is_the_twin_at_the_jax_tile():
    shape = (1, 2, 600, 16)  # two key tiles of the JAX package's 512
    q, k, v, extra = stream_inputs("rel", shape, seed=4)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = twin_pe(q, extra)
    before = (tfa.LAUNCHES_STREAM_FWD, tfa.LAUNCHES_STREAM_FWD_PROLOGUE)
    got = tfa.attention_stream_fwd(*args, 0.25, **kw)
    # CPU tensors never launch, the prologue included
    assert (tfa.LAUNCHES_STREAM_FWD,
            tfa.LAUNCHES_STREAM_FWD_PROLOGUE) == before
    want = tfa.attention_stream_plain(*args, 0.25, kv_tile=jfa.KV_TILE, **kw)
    assert tfa.KV_TILE == jfa.KV_TILE
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    other = tfa.attention_stream_plain(*args, 0.25, kv_tile=tfa.STREAM_TILE,
                                       **kw)
    # Another key tile rounds p against other running maxima: close, and
    # (with these inputs) not identical.
    torch.testing.assert_close(got[0], other[0], rtol=2e-3, atol=2e-3)
    assert not torch.equal(got[0], other[0])


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_short_relative_table_is_refused(direction):
    """The JAX functions raise when the table covers fewer tokens than the
    sequence (their kernel wraps where their twin clamps); so does the
    port."""
    x = torch.zeros(1, 2, 40, 16)
    table = torch.zeros(2, 2 * 30 - 1)
    with pytest.raises(ValueError, match="covers L=30 tokens < sequence 40"):
        if direction == "forward":
            tfa.attention_stream_fwd(x, x, x, 0.25, rel=table)
        else:
            tfa.attention_stream_bwd(x, x, x, x, x, None, 0.25, rel=table)
    with pytest.raises(ValueError, match="covers L=30"):
        jfa._forward_streaming_impl(jnp.zeros((1, 2, 40, 16)),
                                    jnp.zeros((1, 2, 40, 16)),
                                    jnp.zeros((1, 2, 40, 16)), 0.25, None,
                                    None, True, q_tile=64, kv_tile=64,
                                    rel=jnp.zeros((2, 59)))


@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("n", [17, 290])
def test_fwd_prologue_twin_rounds_the_jax_keys_once(regime, n):
    """The forward's key operands as the JAX kernel forms them in every
    tile (`_rotate_bh` of k in float32 over `_prep_freqs`' tables, then
    bf16; bf16 v), once, in rows padded with zeros to stream_fwd_rows(N);
    and the twin given those operands (k and v already rounded, no tables
    for k: q rotated alike) is the JAX kernel's forward."""
    shape = (2, 3, n, 16)
    q, k, v, extra = stream_inputs(regime, shape, seed=40)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    kw = twin_pe(args[0], extra)
    before = tfa.LAUNCHES_STREAM_FWD_PROLOGUE
    ops = tfa.attention_stream_fwd_prologue(args[1], args[2], kw["cos"],
                                            kw["sin"])
    assert tfa.LAUNCHES_STREAM_FWD_PROLOGUE == before  # the twin on the CPU
    assert ops.shape == (2, 2, 3, tfa.stream_fwd_rows(n), 16)
    assert ops.dtype == torch.bfloat16 and not ops[:, :, :, n:].any()
    _, freqs, _ = jax_pe(extra)
    jq, jk = jnp.asarray(q), jnp.asarray(k)
    if freqs is not None:
        cos, sin = jfa._prep_freqs(freqs, 3, n, jnp.float32)
        jq, jk = jfa._rotate_bh(jq, cos, sin), jfa._rotate_bh(jk, cos, sin)
    for got, want in zip(ops[:, :, :, :n], (jk, v)):
        want = torch.from_numpy(np.array(
            jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32)))
        assert torch.equal(got.float(), want)
    want, want_lse = jax_stream(q, k, v, extra, (64, 64))
    qr = torch.from_numpy(np.array(jq))
    got, lse = tfa.attention_stream_plain(
        qr, ops[0, :, :, :n].float(), ops[1, :, :, :n].float(), 0.25,
        kv_tile=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nk,rows", [(1, 64), (17, 64), (64, 64), (65, 128),
                                     (577, 640), (4097, 4160),
                                     (66048, 66048)])
def test_fwd_prologue_rows(nk, rows):
    """The forward's scratch rows cover the whole 64-key tiles its loop
    reads (the kernel's last tile ends at NK rounded up to 16, within
    them), never a tile more."""
    assert tfa.stream_fwd_rows(nk) == rows
    assert rows % tfa.STREAM_TILE == 0 and 0 <= rows - nk < tfa.STREAM_TILE
    assert tfa._round_up(nk, 16) <= rows


@pytest.mark.parametrize("n,offset", [(5, 0), (8, 0), (17, 0), (64, 0),
                                      (64, 1)])
def test_pitched_bias_lays_rows_at_the_kernels_pitch(n, offset):
    """The streaming kernels' bias layout: the same values at rows
    dbias_pitch(N) floats apart, copied once where the bias does not lie so
    (a ragged N, or a view off the 16-byte grid) and passed through as
    itself where it does; the twin reads the view as the contiguous bias,
    bit for bit, and both as the JAX kernel."""
    rng = np.random.default_rng(n)
    whole = torch.from_numpy(
        rng.standard_normal((3, n, n + offset)).astype(np.float32))
    bias = whole[:, :, offset:]
    got = tfa.pitched_bias(bias)
    pitch = tfa.dbias_pitch(n)
    assert got.shape == bias.shape and torch.equal(got, bias)
    assert got.stride() == (n * pitch, pitch, 1)
    assert tfa._is_pitched(got) and tfa.pitched_bias(got) is got
    assert (got is bias) == (n % 4 == 0 and offset == 0)
    q, k, v, _ = stream_inputs("none", (1, 3, n, 16), seed=n)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    want = tfa.attention_stream_plain(*args, 0.25, bias.contiguous(),
                                      kv_tile=64)
    for x, y in zip(tfa.attention_stream_plain(*args, 0.25, got, kv_tile=64),
                    want):
        assert torch.equal(x, y)
    jax_out, jax_lse = jax_stream(q, k, v, {"bias": bias.numpy()}, (64, 64))
    np.testing.assert_allclose(want[0].numpy(), jax_out, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(want[1].numpy(), jax_lse, rtol=1e-4, atol=1e-4)
