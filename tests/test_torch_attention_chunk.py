"""PyTorch port, the streaming forward on a key chunk at global offsets: the
plain twin of the CUDA kernel's chunk entry (`attention_stream_plain` with
row0 / col0 / n_valid) against the JAX package's `streaming_chunk_fwd` (its
Pallas `_stream_kernel` with an offsets input, in interpret mode on the CPU,
at the same key tile of 128), the wrapper on the CPU, the table check, and
the merge of chunk partials. The kernel is tested on the card by
tests/test_torch_kernels_gpu.py.

The global sequence has N_VALID = 290 tokens (the polynomial's grid is 17),
padded to N_PAD = 384 rows as the bounded train step pads it; the padded
rows hold random values, as LayerNorm'd zero rows would.

Tolerances (as tests/test_torch_attention_stream.py, for the same reasons):
* twin (bf16 products) vs the JAX kernel, same key tile: out 2e-3 (a p at a
  bf16 rounding boundary can round the other way after a last-ulp
  difference in exp()), lse 1e-4 (float32 sums in another order);
* bf16 inputs: out 1e-2 (one bf16 ulp at |x| < 2 plus boundary flips);
* twin with float32 products vs the JAX kernel with float32 products: 1e-5;
* rows of a chunk against the rows of the whole-sequence twin, and chunk
  partials merged against the whole key set: 1e-5 (float32 sums in another
  order);
* the chunk twin on the forward prologue's operands (the chunk's keys and
  values rounded to bf16 once) against the twin on the raw operands: bit
  for bit (bf16 of a bf16 value is itself), and against the JAX function.
Padded query rows (at or beyond N_VALID) are held to being finite only: with
the relative bias their index leaves the table, and the port clamps it where
the JAX kernel wraps it; those rows never reach a loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa

N_VALID, N_PAD, GRID = 290, 384, 17
# (query rows, key columns) of one chunk, global indices.
CASES = {
    "origin": ((0, 290), (0, 290)),
    "rows": ((100, 290), (0, 290)),
    # 300 keys from token 37: key tiles of 128, 128 and a ragged 44
    "rows_cols": ((100, 290), (37, 337)),
    # 84 padded query rows; 94 keys beyond N_VALID, masked
    "padded": ((200, 384), (0, 384)),
}
KV_TILE = 128
TOL = {"float32": 2e-3, "bfloat16": 1e-2}


def inputs(regime, heads=3, d=16, seed=0):
    """numpy q, k, v [2, heads, N_PAD, d] and the regime's generator:
    {"poly": (coeff, GRID)} / {"rel": table [heads, 2 * N_VALID - 1]}."""
    rng = np.random.default_rng(seed)
    shape = (2, heads, N_PAD, d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    extra = {}
    if regime == "poly":
        extra["poly"] = (rng.standard_normal((heads, 4)).astype(np.float32)
                         * 0.05, GRID)
    elif regime == "rel":
        extra["rel"] = rng.standard_normal(
            (heads, 2 * N_VALID - 1)).astype(np.float32)
    return q, k, v, extra


def jax_kw(extra):
    if "poly" in extra:
        return {"poly": (jnp.asarray(extra["poly"][0]), extra["poly"][1])}
    if "rel" in extra:
        return {"rel": jnp.asarray(extra["rel"])}
    return {}


def torch_kw(extra):
    if "poly" in extra:
        return {"poly": (torch.from_numpy(extra["poly"][0]),
                         extra["poly"][1])}
    if "rel" in extra:
        return {"rel": torch.from_numpy(extra["rel"])}
    return {}


def both_chunks(regime, case, dtype="float32", d=16, mm="bfloat16", seed=0):
    """(got out, got lse, want out, want lse, number of valid query rows):
    the twin and the JAX function on one chunk of CASES."""
    (r0, r1), (c0, c1) = CASES[case]
    q, k, v, extra = inputs(regime, d=d, seed=seed)
    q, k, v = q[:, :, r0:r1], k[:, :, c0:c1], v[:, :, c0:c1]
    scale = d ** -0.5
    jdt = getattr(jnp, dtype)
    want, want_lse = jfa.streaming_chunk_fwd(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), scale, r0, c0, N_VALID,
        interpret=True, mm_dtype=getattr(jnp, mm), kv_tile=KV_TILE,
        **jax_kw(extra))
    tdt = getattr(torch, dtype)
    got, lse = tfa.attention_stream_plain(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), scale,
        kv_tile=KV_TILE, mm_dtype=getattr(torch, mm), row0=r0, col0=c0,
        n_valid=N_VALID, **torch_kw(extra))
    assert got.dtype == tdt and lse.dtype == torch.float32
    assert got.shape == q.shape and lse.shape == q.shape[:3]
    valid = max(0, min(r1, N_VALID) - r0)
    return (got.float().numpy(), lse.numpy(),
            np.asarray(want.astype(jnp.float32)), np.asarray(want_lse), valid)


def check(got, lse, want, want_lse, valid, tol, lse_tol=1e-4):
    assert np.isfinite(got).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(got[:, :, :valid], want[:, :, :valid],
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(lse[:, :, :valid], want_lse[:, :, :valid],
                               rtol=lse_tol, atol=lse_tol)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_twin_matches_jax_streaming_chunk_fwd(regime, case):
    check(*both_chunks(regime, case), TOL["float32"])


@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_twin_matches_jax_with_bf16_inputs(regime):
    check(*both_chunks(regime, "rows_cols", dtype="bfloat16", seed=1),
          TOL["bfloat16"])


@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_twin_matches_jax_at_head_dim_32(regime):
    check(*both_chunks(regime, "padded", d=32, seed=2), TOL["float32"])


@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_twin_f32_products_match_jax_f32_products(regime):
    check(*both_chunks(regime, "rows_cols", mm="float32", seed=3), 1e-5,
          lse_tol=1e-5)


@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_rows_against_all_keys_are_the_whole_sequence_rows(regime):
    """A chunk at (r0, 0) against every key computes exactly the rows r0...
    of the whole-sequence forward, at the same key tile."""
    q, k, v, extra = inputs(regime, seed=4)
    q, k, v = (torch.from_numpy(x[:, :, :N_VALID]) for x in (q, k, v))
    whole, whole_lse = tfa.attention_stream_plain(q, k, v, 0.25,
                                                  kv_tile=KV_TILE,
                                                  **torch_kw(extra))
    got, lse = tfa.attention_stream_plain(q[:, :, 120:], k, v, 0.25,
                                          kv_tile=KV_TILE, row0=120,
                                          n_valid=N_VALID, **torch_kw(extra))
    torch.testing.assert_close(got, whole[:, :, 120:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, whole_lse[:, :, 120:], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("regime", ["poly", "rel"])
def test_chunk_partials_merge_to_the_whole_key_set(regime):
    """The (out, lse) of two key chunks, merged with the online-softmax
    identity (the ring's merge), give the forward over all keys: the biases
    are generated at global columns in both chunks. float32 products, so no
    bf16 rounding of p against different running maxima enters."""
    q, k, v, extra = inputs(regime, seed=5)
    q, k, v = (torch.from_numpy(x[:, :, :N_VALID]) for x in (q, k, v))
    f32 = dict(kv_tile=KV_TILE, mm_dtype=torch.float32, n_valid=N_VALID,
               **torch_kw(extra))
    want, want_lse = tfa.attention_stream_plain(q, k, v, 0.25, **f32)
    parts = [tfa.attention_stream_plain(q, k[:, :, c0:c1], v[:, :, c0:c1],
                                        0.25, col0=c0, **f32)
             for c0, c1 in ((0, 150), (150, N_VALID))]
    lse = torch.logaddexp(parts[0][1], parts[1][1])
    out = sum(o * torch.exp(part_lse - lse)[..., None]
              for o, part_lse in parts)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", ["rows_cols", "padded"])
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_on_the_prologue_operands_is_the_chunk(regime, case):
    """The chunk's keys and values as the forward's prologue rounds them
    once per call (no tables on a chunk: rounding only, zero rows past the
    chunk) give the chunk twin's result bit for bit, and the JAX
    function's."""
    (r0, r1), (c0, c1) = CASES[case]
    q, k, v, extra = inputs(regime, seed=7)
    q, k, v = (torch.from_numpy(x) for x in (q[:, :, r0:r1], k[:, :, c0:c1],
                                              v[:, :, c0:c1]))
    ops = tfa.attention_stream_fwd_prologue(k, v)
    nc = c1 - c0
    assert ops.shape == (2, 2, 3, tfa.stream_fwd_rows(nc), 16)
    assert not ops[:, :, :, nc:].any()
    assert torch.equal(ops[0, :, :, :nc], k.to(torch.bfloat16))
    assert torch.equal(ops[1, :, :, :nc], v.to(torch.bfloat16))
    kw = dict(kv_tile=KV_TILE, row0=r0, col0=c0, n_valid=N_VALID,
              **torch_kw(extra))
    got = tfa.attention_stream_plain(q, ops[0, :, :, :nc].float(),
                                     ops[1, :, :, :nc].float(), 0.25, **kw)
    want = tfa.attention_stream_plain(q, k, v, 0.25, **kw)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    jax_out, jax_lse = jfa.streaming_chunk_fwd(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), 0.25, r0, c0, N_VALID,
        interpret=True, kv_tile=KV_TILE, **jax_kw(extra))
    valid = max(0, min(r1, N_VALID) - r0)
    check(got[0].numpy(), got[1].numpy(), np.asarray(jax_out),
          np.asarray(jax_lse), valid, TOL["float32"])


def test_chunk_wrapper_on_cpu_is_the_twin_at_the_jax_tile():
    """On CPU tensors the wrapper is the twin at the JAX package's key tile
    for the chunk, min(512, Nc rounded up to 128), launches nothing, and
    writes into the given out / lse views (rows of longer buffers)."""
    q, k, v, extra = inputs("rel", seed=6)
    q, k, v = (torch.from_numpy(x) for x in (q, k, v))
    kw = torch_kw(extra)
    rows = slice(128, 384)
    out = torch.zeros((2, N_PAD, 3, 16)).transpose(1, 2)
    lse = torch.zeros((2, 3, N_PAD))
    before = (tfa.LAUNCHES_STREAM_CHUNK_FWD, tfa.LAUNCHES_STREAM_FWD_PROLOGUE)
    got = tfa.streaming_chunk_fwd(q[:, :, rows], k[:, :, 37:337],
                                  v[:, :, 37:337], 0.25, 128, 37, N_VALID,
                                  out=out[:, :, rows], lse=lse[:, :, rows],
                                  **kw)
    assert (tfa.LAUNCHES_STREAM_CHUNK_FWD,
            tfa.LAUNCHES_STREAM_FWD_PROLOGUE) == before
    want = tfa.attention_stream_plain(
        q[:, :, rows], k[:, :, 37:337], v[:, :, 37:337], 0.25,
        kv_tile=min(jfa.KV_TILE, 384), row0=128, col0=37, n_valid=N_VALID,
        **kw)
    for x, y, buf in zip(got, want, (out, lse)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
        assert x.data_ptr() == buf[:, :, rows].data_ptr()
    assert float(out[:, :, :128].abs().max()) == 0.0
    assert float(lse[:, :, :128].abs().max()) == 0.0
    # Without views the wrapper allocates its results.
    fresh = tfa.streaming_chunk_fwd(q[:, :, rows], k[:, :, 37:337],
                                    v[:, :, 37:337], 0.25, 128, 37, N_VALID,
                                    **kw)
    for x, y in zip(fresh, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_chunk_functions_refuse_what_the_jax_function_refuses():
    x = torch.zeros(1, 2, 40, 16)
    table = torch.zeros(2, 2 * 30 - 1)
    with pytest.raises(ValueError, match="covers L=30 tokens < sequence 40"):
        tfa.streaming_chunk_fwd(x[:, :, 8:], x, x, 0.25, 8, 0, 40, rel=table)
    with pytest.raises(ValueError, match="covers L=30"):
        jfa.streaming_chunk_fwd(jnp.zeros((1, 2, 32, 16)),
                                jnp.zeros((1, 2, 40, 16)),
                                jnp.zeros((1, 2, 40, 16)), 0.25, 8, 0, 40,
                                rel=jnp.zeros((2, 59)), interpret=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfa.streaming_chunk_fwd(x, x, x, 0.25, 0, 0, 40,
                                poly=(torch.zeros(2, 3), 6),
                                rel=torch.zeros(2, 79))
    cos = torch.ones(1, 40, 8)
    with pytest.raises(ValueError, match="generated biases only"):
        tfa.attention_stream_plain(x[:, :, 8:], x, x, 0.25, cos=cos,
                                   sin=0 * cos, row0=8)
