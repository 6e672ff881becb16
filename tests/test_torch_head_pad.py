"""PyTorch port, head dims the CUDA kernels are not built for and polynomial
degrees above the terms they keep in registers (ops/flash_attention.py).

The wrappers zero-pad D up to the next built head dim (fa.HeadPad), each
half on its own with rope, and cut the results back. On the CPU the
wrappers run the twins, which take any D, so these tests hold the padding
itself: every twin on padded inputs, cut back, against the same twin on
the unpadded inputs, at D = 24, 48 and 96, with and without rope, forward
and backward (dq, dk, dv, the rotated-space dqr / dkr, lse). The kernels
on the card: tests/test_torch_kernels_gpu.py.

The twins multiply in float32 here (mm_dtype): the point is the padding,
not the bf16 rounding, which a last-ulp difference in a float32 sum can flip.
Tolerance 1e-5 abs + rel: zero columns add exact zeros to every product,
but float32 sums of another length are blocked in another order.
"""

import pytest
import torch

from vit_rpe_rope_tpu_torch.ops import flash_attention as fa

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = dict(mm_dtype=torch.float32)
DIMS = [24, 48, 96]


def tensors(d, rope, n=65, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = (2, 3, n, d)
    q, k, v, g = (torch.randn(shape, generator=gen) for _ in range(4))
    cos = sin = None
    if rope:
        phase = 6.0 * torch.rand((3, n - 1, d // 2), generator=gen)
        cos, sin = fa._kernel_freqs((torch.cos(phase), torch.sin(phase)), 3,
                                    n, "cpu")
    return q, k, v, g, cos, sin


def close(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_dense_twins_on_padded_inputs(d, rope):
    q, k, v, g, cos, sin = tensors(d, rope)
    hp = fa.HeadPad.needed(q, cos)
    assert hp.d_pad == {24: 32, 48: 64, 96: 128}[d] and hp.halves == rope
    scale = d ** -0.5
    pq, pk, pv, pg = map(hp.pad, (q, k, v, g))
    pcos, psin = hp.tables(cos, sin)
    out = fa.attention_plain(q, k, v, scale, None, cos, sin, **F32)
    close(hp.unpad(fa.attention_plain(pq, pk, pv, scale, None, pcos, psin,
                                        **F32)),
          out)
    want = fa.attention_bwd_plain(q, k, v, out, g, scale, None, cos, sin,
                                  want_drot=rope, **F32)
    got = fa.attention_bwd_plain(pq, pk, pv, hp.pad(out), pg, scale, None,
                                 pcos, psin, want_drot=rope, **F32)
    for x, y in zip(got, want):
        close(hp.unpad(x), y)


@pytest.mark.parametrize("rope", [False, True])
@pytest.mark.parametrize("d", DIMS)
def test_streaming_twins_on_padded_inputs(d, rope):
    q, k, v, g, cos, sin = tensors(d, rope, seed=1)
    hp = fa.HeadPad.needed(q, cos)
    scale = d ** -0.5
    poly = None if rope else (0.05 * torch.randn(
        (3, 9), generator=torch.Generator().manual_seed(2))
        * 8.0 ** -torch.arange(9.0), 8)
    pq, pk, pv, pg = map(hp.pad, (q, k, v, g))
    pcos, psin = hp.tables(cos, sin)
    out, lse = fa.attention_stream_plain(q, k, v, scale, cos=cos, sin=sin,
                                         poly=poly, kv_tile=32, **F32)
    p_out, p_lse = fa.attention_stream_plain(pq, pk, pv, scale, cos=pcos,
                                             sin=psin, poly=poly, kv_tile=32,
                                             **F32)
    close(hp.unpad(p_out), out)
    close(p_lse, lse)
    want = fa.attention_stream_bwd_plain(q, k, v, out, g, lse, scale, cos=cos,
                                         sin=sin, poly=poly, kv_tile=32,
                                         want_drot=rope,
                                         want_dparam=poly is not None, **F32)
    got = fa.attention_stream_bwd_plain(pq, pk, pv, hp.pad(out), pg, lse,
                                        scale, cos=pcos, sin=psin, poly=poly,
                                        kv_tile=32, want_drot=rope,
                                        want_dparam=poly is not None, **F32)
    for x, y in zip(got[:6], want[:6]):
        close(hp.unpad(x), y)
    close(got[6], want[6])  # dcoeff: the padding leaves it alone
    delta = (g * out).sum(dim=-1)
    want = fa.attention_stream_bwd_fused_plain(q, k, v, g, lse, delta, scale,
                                               cos, sin, poly=poly, **F32)
    got = fa.attention_stream_bwd_fused_plain(pq, pk, pv, pg, lse, delta,
                                              scale, pcos, psin, poly=poly,
                                              **F32)
    for x, y in zip(got[:3], want[:3]):
        close(hp.unpad(x), y)
    close(got[3], want[3])


def test_head_pad_round_trip_and_limits():
    """Padding puts zeros after each half with rope and after the row
    without; unpad inverts it exactly; tables get identity columns; built
    dims need no padding; D above 128 raises."""
    x = torch.arange(2 * 24.0).reshape(2, 24) + 1
    halves = fa.HeadPad(24, halves=True)
    padded = halves.pad(x)
    assert padded.shape == (2, 32)
    assert torch.equal(padded[:, 12:16], torch.zeros(2, 4))
    assert torch.equal(padded[:, 28:], torch.zeros(2, 4))
    assert torch.equal(padded[:, 16:28], x[:, 12:])
    assert torch.equal(halves.unpad(padded), x)
    whole = fa.HeadPad(24, halves=False)
    assert torch.equal(whole.pad(x)[:, 24:], torch.zeros(2, 8))
    assert torch.equal(whole.unpad(whole.pad(x)), x)
    cos, sin = halves.tables(torch.full((3, 12), 0.5),
                             torch.full((3, 12), 0.5))
    assert torch.equal(cos[:, 12:], torch.ones(3, 4))
    assert torch.equal(sin[:, 12:], torch.zeros(3, 4))
    assert halves.pad(None) is None and halves.unpad(None) is None
    assert fa.HeadPad.needed(torch.zeros(1, 1, 2, 64)) is None
    assert fa.HeadPad.needed(torch.zeros(1, 1, 2, 8)).d_pad == 16
    with pytest.raises(ValueError, match="up to 128"):
        fa.HeadPad.needed(torch.zeros(1, 1, 2, 160))


@pytest.mark.parametrize("terms,cols", [(4, 8), (8, 8), (9, 16), (32, 32),
                                        (128, 128)])
def test_polynomial_terms_up_to_the_lanes(terms, cols):
    """The kernels take up to 128 terms (the JAX package's lanes); the
    one-pass backward's per-CTA partial sums come in groups of eight
    (poly_part_cols in csrc/attn_stream.cuh), one row per CTA of 128 keys
    (one for these 100)."""
    q = torch.zeros(2, 3, 100, 32)
    coeff = torch.zeros(3, terms)
    got, _, _ = fa._check_generated(q, (coeff, 9), None)
    assert got.shape == (3, terms)
    dparam, part = fa._dparam_scratch(q, 100, coeff, None)
    assert dparam.shape == (3, terms) and part.shape == (2, 3, 1, cols)


def test_polynomial_terms_above_the_lanes_raise():
    q = torch.zeros(1, 2, 10, 32)
    with pytest.raises(ValueError, match="1..128"):
        fa._check_generated(q, (torch.zeros(2, 129), 3), None)
