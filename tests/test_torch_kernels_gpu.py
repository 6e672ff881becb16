"""PyTorch port, the CUDA kernels on the card: each kernel against its plain
PyTorch twin on the same CUDA tensors (dense and streaming attention,
forward and backward, fused AdamW). Every test here needs a CUDA device and
skips without one (the kernels have no CPU mode; the twins are tested
against the JAX package on the CPU in tests/test_torch_attention.py,
test_torch_attention_bwd.py, test_torch_attention_stream.py,
test_torch_attention_stream_bwd.py, test_torch_attention_stream_bwd_fused.py
and test_torch_fused_adamw.py).

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch:

  python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest

Tolerance, kernel vs twin: 2e-3 for f32 inputs, 1e-2 for bf16 inputs (same
rounding points; f32 sums in another order can round a p or an output at a
bf16 boundary the other way), abs + rel. The batch sums of the backward
(dbias, dcos/dsin) are held to the same numbers relative to their largest
entry, since each adds up B such differences. The streaming kernels are held
to their twins at the kernels' own key tile (fa.STREAM_TILE), which fixes
the running max that p is rounded against; lse to 1e-4 (float32 sums in
another order). The one-pass backward and the dcoeff / dtable passes are
held to their twins as a share of each output's largest entry: p = exp(s -
lse) needs no running max, so the twin's tiles only reorder float32 sums, and
what is left are bf16 roundings of p and ds that flip after a last-ulp
difference (dq, dk, dv: 4e-3 f32 / 1.6e-2 bf16 inputs, as the separate
passes); the parameter gradients, float32 sums of ds that nearly cancel,
1e-3 of their largest entry. AdamW: 1e-6 (the same float32 operations,
rounded op by op on both sides)."""

import dataclasses

import pytest
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.ops import fused_adamw
from vit_rpe_rope_tpu_torch.ops import reference_attention

REGIMES = ["none", "poly", "rel", "rope-axial", "rope-mixed"]
TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def inputs(regime, shape, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for _ in range(3))
    kw = {}
    if regime == "poly":
        kw["poly"] = (0.05 * torch.randn((h, 4), generator=gen).to(device),
                      int(round((n - 1) ** 0.5)))
    elif regime == "rel":
        kw["rel"] = torch.randn((h, 2 * n - 1), generator=gen).to(device)
    elif regime.startswith("rope"):
        fshape = (n - 1, d // 2) if regime == "rope-axial" else (h, n - 1, d // 2)
        phase = 6.0 * torch.rand(fshape, generator=gen).to(device)
        kw["freqs_cis"] = (torch.cos(phase), torch.sin(phase))
    return q, k, v, kw


def run_and_compare(q, k, v, kw, dtype):
    h, n = q.shape[1], q.shape[2]
    scale = q.shape[-1] ** -0.5
    bias, cos, sin = fa.prepare_pe(h, n, q.device, **kw)
    before = fa.LAUNCHES
    got = fa.flash_attention(q, k, v, scale, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.attention_plain(q, k, v, scale, bias, cos, sin)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_matches_twin_at_vit_s_shape(cuda, regime, dtype):
    run_and_compare(*inputs(regime, (4, 6, 197, 64), dtype, cuda), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 17, 16), (3, 6, 65, 32),
                                   (1, 2, 129, 128), (2, 2, 64, 64),
                                   (1, 1, 1, 16)])
def test_kernel_matches_twin_at_other_shapes(cuda, shape):
    regime = "rope-mixed" if shape[2] > 1 else "none"
    run_and_compare(*inputs(regime, shape, torch.float32, cuda, seed=1),
                    torch.float32)


@pytest.mark.gpu
def test_kernel_reads_strided_qkv_views(cuda):
    """q, k, v as the model hands them over: views of one [B, N, 3, H, D]
    product, not contiguous [B, H, N, D] tensors."""
    b, n, h, d = 3, 197, 6, 64
    qkv = torch.randn(b, n, 3, h, d, device=cuda).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    assert not q.is_contiguous()
    run_and_compare(q, k, v, {"rel": torch.randn(h, 2 * n - 1, device=cuda)},
                    torch.float32)
    out = fa.attention_fwd(q, k, v, 0.125)
    assert out.transpose(1, 2).is_contiguous()  # [B, N, H, D] in memory


@pytest.mark.gpu
def test_kernel_wrapper_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(1, 2, 5, 24, device=cuda)  # head dim 24 is not built
    with pytest.raises(ValueError, match="head dims"):
        fa.attention_fwd(x, x, x, 0.2)
    y = torch.zeros(1, 2, 5, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.attention_fwd(y, y, y, 0.25)
    z = torch.zeros(1, 2, 5, 32, device=cuda)[..., ::2]  # last-dim stride 2
    with pytest.raises(ValueError, match="last dim"):
        fa.attention_fwd(z, z, z, 0.25)
    w = torch.zeros(1, 2, 5, 16, device=cuda)
    with pytest.raises(ValueError, match="bias"):
        fa.attention_fwd(w, w, w, 0.25, bias=torch.zeros(2, 5, 5,
                                                         dtype=torch.float64,
                                                         device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("pe_name", ["none", "absolute", "relative",
                                     "polynomial", "rope-axial", "rope-mixed"])
def test_model_kernel_path_matches_reference_path(cuda, pe_name):
    cfg = ViTConfig(img_size=32, patch_size=4, embed_dim=192, depth=2,
                    num_heads=6, pos_encoding=pe_name)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device=cuda)
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)
    before = fa.LAUNCHES
    with torch.inference_mode():
        got = vit.apply(params, x, cfg)
        assert fa.LAUNCHES == before + cfg.depth
        want = vit.apply(params, x, dataclasses.replace(
            cfg, attention_impl="reference"))
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-2)


def close_to_largest(got, want, tol):
    """|got - want| <= tol * max(1, max|want|) — for sums over the batch."""
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol * scale)


def run_bwd_and_compare(q, k, v, kw, dtype, seed=0):
    h, n = q.shape[1], q.shape[2]
    scale = q.shape[-1] ** -0.5
    bias, cos, sin = fa.prepare_pe(h, n, q.device, **kw)
    out = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
    gen = torch.Generator().manual_seed(seed + 11)
    g = torch.randn(q.shape, generator=gen).to(q.device, dtype)
    want_drot = cos is not None
    args = (q, k, v, out, g, scale, bias, cos, sin)
    before = fa.LAUNCHES_BWD
    got = fa.attention_bwd(*args, want_dbias=bias is not None,
                           want_drot=want_drot)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_BWD == before + 1
    want = fa.attention_bwd_plain(*args, want_dbias=bias is not None,
                                  want_drot=want_drot)
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == dtype and x.shape == q.shape
        torch.testing.assert_close(x.float(), y.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
    for x, y in zip(got[3:], want[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            close_to_largest(x, y, TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", REGIMES)
def test_bwd_kernel_matches_twin_at_vit_s_shape(cuda, regime, dtype):
    run_bwd_and_compare(*inputs(regime, (12, 6, 197, 64), dtype, cuda),
                        dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 17, 16), (3, 6, 65, 32),
                                   (1, 2, 129, 128), (9, 2, 64, 64),
                                   (1, 1, 1, 16)])
def test_bwd_kernel_matches_twin_at_other_shapes(cuda, shape):
    regime = "rel" if shape[2] > 1 else "none"
    run_bwd_and_compare(*inputs(regime, shape, torch.float32, cuda, seed=2),
                        torch.float32, seed=2)
    if shape[2] > 1 and shape[3] % 4 == 0:
        run_bwd_and_compare(*inputs("rope-mixed", shape, torch.float32, cuda,
                                    seed=3), torch.float32, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", REGIMES)
def test_kernel_autograd_matches_reference_autograd(cuda, regime):
    """Gradients through the autograd Function (both kernels) against
    autograd through the unfused f32 oracle: bf16 rounding of q, k, g and
    v on one side gives logits a relative error near 2^-8, which the
    softmax carries into every gradient, so 5e-2 of the largest entry.
    The polynomial coefficients are scaled by grid^-k here: at grid 14 the
    degree-3 gradient weighs dbias by distance^3 (up to 17,576), and
    unscaled coefficients saturate the softmax, so bf16 noise in dbias
    would swamp the comparison."""
    q, k, v, kw = inputs(regime, (4, 6, 197, 64), torch.float32, cuda,
                         seed=4)
    n = q.shape[2]
    if "poly" in kw:
        coeff, grid = kw["poly"]
        powers = torch.arange(coeff.shape[1], device=cuda)
        kw["poly"] = (coeff * float(grid) ** -powers.float(), grid)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    if "poly" in kw:
        leaves.append(kw["poly"][0].requires_grad_())
    if "rel" in kw:
        leaves.append(kw["rel"].requires_grad_())
    if regime == "rope-mixed":
        leaves += [t.requires_grad_() for t in kw["freqs_cis"]]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    g = g.to(cuda)
    fwd0, bwd0 = fa.LAUNCHES, fa.LAUNCHES_BWD
    got = torch.autograd.grad(fa.flash_attention(q, k, v, 0.125, **kw),
                              leaves, g)
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == (fwd0 + 1, bwd0 + 1)
    ref_kw = {}
    if "freqs_cis" in kw:
        ref_kw["freqs_cis"] = kw["freqs_cis"]
    else:
        ref_kw["bias"] = fa._dense_bias(q.shape[1], n, cuda,
                                        poly=kw.get("poly"),
                                        rel=kw.get("rel"))
    want = torch.autograd.grad(
        reference_attention.attention(q, k, v, 0.125, **ref_kw), leaves, g)
    for x, y in zip(got, want):
        close_to_largest(x, y, 5e-2)


@pytest.mark.gpu
def test_adamw_kernel_matches_twin(cuda):
    cfg = ViTConfig(img_size=32, patch_size=4, embed_dim=192, depth=2,
                    num_heads=6, pos_encoding="relative")
    gen = torch.Generator().manual_seed(6)
    params = vit.init_params(gen, cfg, device=cuda)
    twin = {k: v.clone() for k, v in params.items()}
    init, update = fused_adamw.make_fused_adamw(
        params, lambda step: 1e-3, weight_decay=0.05)
    tinit, tupdate = fused_adamw.make_fused_adamw(
        twin, lambda step: 1e-3, weight_decay=0.05,
        step=fused_adamw.adamw_plain)
    state, tstate = init(params), tinit(twin)
    before = fused_adamw.LAUNCHES_ADAMW
    for i in range(3):
        grads = {k: torch.randn(v.shape, generator=gen).to(cuda)
                 for k, v in params.items()}
        # a transposed (non-contiguous) grad, as autograd can hand one over
        grads["head.weight"] = grads["head.weight"].t().contiguous().t()
        params, state = update(grads, state, params)
        twin, tstate = tupdate(grads, tstate, twin)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES_ADAMW == before + 3
    assert state[2] == tstate[2] == 3
    for key in params:
        for got, want in ((params[key], twin[key]),
                          (state[0][key], tstate[0][key]),
                          (state[1][key], tstate[1][key])):
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# "bias": a materialized [H, N, N] tensor; "poly" / "rel": generated in the
# kernel from the coefficients / the table.
STREAM_REGIMES = ["none", "bias", "poly", "rel", "rope-axial", "rope-mixed"]


def stream_inputs(regime, shape, dtype, device, seed=0):
    """q, k, v and the streaming wrappers' PE keyword arguments."""
    q, k, v, kw = inputs("rel" if regime == "bias" else regime, shape, dtype,
                         device, seed)
    h, n = shape[1], shape[2]
    _, cos, sin = fa.prepare_pe(h, n, device, freqs_cis=kw.pop("freqs_cis",
                                                               None))
    if regime == "bias":
        kw = {"bias": fa._dense_bias(h, n, device, rel=kw["rel"])}
    if regime == "poly":  # keep the degree-3 term of order 1 at any grid
        coeff, grid = kw["poly"]
        powers = torch.arange(coeff.shape[1], device=device).float()
        kw["poly"] = (coeff * float(grid) ** -powers, grid)
    return q, k, v, dict(kw, cos=cos, sin=sin)


def run_stream_and_compare(regime, shape, dtype, device, seed=0):
    q, k, v, kw = stream_inputs(regime, shape, dtype, device, seed)
    scale = shape[-1] ** -0.5
    counts = (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_DQ,
              fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS)
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert out.transpose(1, 2).is_contiguous()  # [B, N, H, D] in memory
    want_out, want_lse = fa.attention_stream_plain(
        q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)

    gen = torch.Generator().manual_seed(seed + 11)
    g = torch.randn(shape, generator=gen).to(device, dtype)
    want_dbias = kw.get("bias") is not None
    want_drot = regime == "rope-mixed"
    got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                  want_dbias=want_dbias, want_drot=want_drot,
                                  **kw)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_DQ,
            fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1,
        counts[3] + int(want_dbias))
    want = fa.attention_stream_bwd_plain(
        q, k, v, out, g, lse, scale, kv_tile=fa.STREAM_TILE,
        want_dbias=want_dbias, want_drot=want_drot, **kw)
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == dtype and x.shape == q.shape
        torch.testing.assert_close(x.float(), y.float(), rtol=2 * TOL[dtype],
                                   atol=2 * TOL[dtype])
    for x, y in zip(got[3:], want[3:]):
        assert (x is None) == (y is None)
        if x is not None:
            close_to_largest(x, y, 2 * TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", STREAM_REGIMES)
def test_stream_kernels_match_twins_at_vit_s_384_shape(cuda, regime, dtype):
    """Forward (out, lse), then dq, dk, dv (+ dbias, dqr/dkr) from the
    kernel's own out and lse. The backward is held to twice the forward's
    numbers: ds is rounded to bf16 after a subtraction that cancels."""
    run_stream_and_compare(regime, (2, 6, 577, 64), dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 70, 16), (1, 4, 1100, 32),
                                   (1, 2, 129, 128), (9, 2, 64, 64),
                                   (1, 1, 1, 16)])
def test_stream_kernels_match_twins_at_other_shapes(cuda, shape):
    regime = "bias" if shape[2] > 1 else "none"
    run_stream_and_compare(regime, shape, torch.float32, cuda, seed=2)
    if shape[2] > 1:
        run_stream_and_compare("rope-mixed", shape, torch.float32, cuda,
                               seed=3)


@pytest.mark.gpu
def test_stream_kernels_read_strided_qkv_views(cuda):
    b, n, h, d = 2, 577, 6, 64
    qkv = torch.randn(b, n, 3, h, d, device=cuda).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    out, lse = fa.attention_stream_fwd(q, k, v, 0.125)
    want, want_lse = fa.attention_stream_plain(q, k, v, 0.125,
                                               kv_tile=fa.STREAM_TILE)
    torch.testing.assert_close(out, want, rtol=2e-3, atol=2e-3)
    g = torch.randn(b, n, h, d, device=cuda).transpose(1, 2)
    got = fa.attention_stream_bwd(q, k, v, out, g, lse, 0.125)
    want = fa.attention_stream_bwd_plain(q, k, v, out, g, lse, 0.125,
                                         kv_tile=fa.STREAM_TILE)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x, y, rtol=4e-3, atol=4e-3)


def stream_counts():
    return (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_DQ,
            fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS,
            fa.LAUNCHES_STREAM_FUSED, fa.LAUNCHES_STREAM_DCOEFF,
            fa.LAUNCHES_STREAM_DTABLE)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "rel", "poly", "rope-mixed"])
def test_streaming_autograd_matches_reference_autograd(cuda, regime):
    """flash_attention at N=577, H=6 (the dense tiles do not fit, so it
    streams; none, rel= and poly= take the one-pass backward, which also
    sums the table's / the coefficients' gradient; rope-mixed the separate
    passes) against autograd through the unfused f32 oracle: 5e-2 of the
    largest entry, as for the dense kernels."""
    q, k, v, kw = inputs(regime, (2, 6, 577, 64), torch.float32, cuda, seed=4)
    if "poly" in kw:
        coeff, grid = kw["poly"]
        powers = torch.arange(coeff.shape[1], device=cuda)
        kw["poly"] = (coeff * float(grid) ** -powers.float(), grid)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    if "poly" in kw:
        leaves.append(kw["poly"][0].requires_grad_())
    if "rel" in kw:
        leaves.append(kw["rel"].requires_grad_())
    if regime == "rope-mixed":
        leaves += [t.requires_grad_() for t in kw["freqs_cis"]]
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(5))
    g = g.to(cuda)
    counts = stream_counts() + (fa.LAUNCHES, fa.LAUNCHES_BWD)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, 0.125, **kw),
                              leaves, g)
    has_bias = regime in ("rel", "poly")
    separate = int(regime == "rope-mixed")
    assert stream_counts() + (fa.LAUNCHES, fa.LAUNCHES_BWD) == (
        counts[0] + 1, counts[1] + separate, counts[2] + separate, counts[3],
        counts[4] + 1 - separate, counts[5], counts[6], counts[7], counts[8])
    ref_kw = {}
    if "freqs_cis" in kw:
        ref_kw["freqs_cis"] = kw["freqs_cis"]
    elif has_bias:
        ref_kw["bias"] = fa._dense_bias(6, 577, cuda, poly=kw.get("poly"),
                                        rel=kw.get("rel"))
    want = torch.autograd.grad(
        reference_attention.attention(q, k, v, 0.125, **ref_kw), leaves, g)
    for x, y in zip(got, want):
        close_to_largest(x, y, 5e-2)


@pytest.mark.gpu
def test_generated_bias_above_the_threshold(cuda):
    """N=2305 > STREAMING_THRESHOLD: the eval forward generates the bias in
    the kernel and agrees with the materialized one; training the table /
    the coefficients takes the one-pass backward (no dq, dk/dv or dbias
    launch) and agrees with the separate passes on the materialized bias,
    whose dbias goes back through the generator's autograd."""
    shape = (1, 2, 2305, 32)
    for regime in ("poly", "rel"):
        q, k, v, kw = inputs(regime, shape, torch.float32, cuda, seed=6)
        if regime == "poly":  # keep the degree-3 term of order 1 at grid 48
            coeff, grid = kw["poly"]
            powers = torch.arange(coeff.shape[1], device=cuda).float()
            kw["poly"] = (coeff * float(grid) ** -powers, grid)
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, 0.2, **kw)
            bias = fa._dense_bias(2, 2305, cuda, **kw)
            want = fa.flash_attention(q, k, v, 0.2, bias=bias)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        param = kw["poly"][0] if regime == "poly" else kw["rel"]
        leaves = [t.requires_grad_() for t in (q, k, v, param)]
        g = torch.randn(shape, generator=torch.Generator().manual_seed(7))
        g = g.to(cuda)
        counts = stream_counts()
        got = torch.autograd.grad(fa.flash_attention(q, k, v, 0.2, **kw),
                                  leaves, g)
        assert stream_counts() == (counts[0] + 1, counts[1], counts[2],
                                   counts[3], counts[4] + 1, counts[5],
                                   counts[6])
        bias = fa._dense_bias(2, 2305, cuda, **kw)
        want = torch.autograd.grad(fa.flash_attention(q, k, v, 0.2, bias=bias),
                                   leaves, g)
        for x, y in zip(got[:3], want[:3]):
            close_to_largest(x, y, 4e-3)
        close_to_largest(got[3], want[3], 1e-3)


FUSED_REGIMES = ["none", "rope-axial", "poly", "rel"]
FUSED_TOL = {torch.float32: 4e-3, torch.bfloat16: 1.6e-2}
PARAM_TOL = 1e-3


def share_of_largest(got, want, tol):
    """|got - want| <= tol * max|want| (no absolute floor)."""
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))


def fused_inputs(regime, shape, dtype, device, seed):
    """q, k, v, g, the forward kernel's lse, delta and the PE arguments."""
    q, k, v, kw = stream_inputs(regime, shape, dtype, device, seed)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    gen = torch.Generator().manual_seed(seed + 11)
    g = torch.randn(shape, generator=gen).to(device, dtype)
    delta = (g.float() * out.float()).sum(dim=-1)
    return (q, k, v, g, lse, delta, scale), kw


def compare_fused(got, want, regime, dtype):
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == torch.float32 and x.shape == y.shape
        share_of_largest(x, y, FUSED_TOL[dtype])
    assert (got[3] is None) == (regime != "poly")
    assert (got[4] is None) == (regime != "rel")
    for x, y in zip(got[3:], want[3:]):
        if x is not None:
            share_of_largest(x, y, PARAM_TOL)


def run_fused_and_compare(regime, shape, dtype, device, seed=0):
    """The one-pass kernel against its twin, and a second launch against the
    first, bit for bit."""
    args, kw = fused_inputs(regime, shape, dtype, device, seed)
    counts = stream_counts()
    got = fa.attention_stream_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    assert stream_counts() == counts[:4] + (counts[4] + 1,) + counts[5:]
    want = fa.attention_stream_bwd_fused_plain(*args, q_tile=512, kv_tile=256,
                                               **kw)
    compare_fused(got, want, regime, dtype)
    again = fa.attention_stream_bwd_fused(*args, **kw)
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    assert got[0]._base is got[1]._base is got[2]._base  # one dqkv buffer


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_bwd_kernel_matches_twin_at_vit_s_384_shape(cuda, regime,
                                                           dtype):
    run_fused_and_compare(regime, (2, 6, 577, 64), dtype, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 3, 70, 16), (1, 4, 1100, 32),
                                   (1, 2, 129, 128), (9, 2, 64, 64),
                                   (1, 1, 1, 16)])
def test_fused_bwd_kernel_matches_twin_at_other_shapes(cuda, shape):
    run_fused_and_compare("none", shape, torch.float32, cuda, seed=2)
    if shape[2] > 1:
        for regime in ("rope-axial", "poly", "rel"):
            run_fused_and_compare(regime, shape, torch.float32, cuda, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", FUSED_REGIMES)
def test_fused_bwd_kernel_in_forced_segments(cuda, regime, dtype, monkeypatch):
    """256-key segments at N=1100: five launches (the last ragged), rope
    applied outside the sweep, against the unsegmented twin."""
    args, kw = fused_inputs(regime, (1, 4, 1100, 32), dtype, cuda, 4)
    want = fa.attention_stream_bwd_fused_plain(*args, q_tile=512, kv_tile=256,
                                               **kw)
    monkeypatch.setattr(fa, "_fused_kv_seg_cols", lambda b, h, n, d: 256)
    before = fa.LAUNCHES_STREAM_FUSED
    got = fa.attention_stream_bwd_fused(*args, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_STREAM_FUSED == before + 5
    compare_fused(got, want, regime, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_bwd_kernel_at_offsets_matches_twin(cuda, regime):
    """Query rows [300, 1100) against the 333 keys from global token 450 (a
    shorter, ragged key chunk), strided views of the full tensors."""
    (q, k, v, g, lse, delta, scale), kw = fused_inputs(
        regime, (2, 4, 1100, 32), torch.float32, cuda, 5)
    pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
    rows, cols = slice(300, 1100), slice(450, 783)
    args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows],
            lse[:, :, rows], delta[:, :, rows], scale)
    before = fa.LAUNCHES_STREAM_FUSED
    got = fa.streaming_chunk_bwd(*args, 300, 450, 1100, **pe)
    torch.cuda.synchronize()
    assert fa.LAUNCHES_STREAM_FUSED == before + 1
    want = fa.attention_stream_bwd_fused_plain(
        *args, q_tile=512, kv_tile=256, n_valid=1100, row0=300, col0=450,
        **pe)
    assert got[0].shape == (2, 4, 800, 32) and got[1].shape == (2, 4, 333, 32)
    for x, y in zip(got[:3], want[:3]):
        share_of_largest(x, y, FUSED_TOL[torch.float32])
    dparam = want[3] if regime == "poly" else want[4]
    assert (got[3] is None) == (dparam is None)
    if dparam is not None:
        share_of_largest(got[3], dparam, PARAM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["poly", "rel"])
def test_dparam_kernels_match_twin(cuda, regime, dtype):
    """The separate-pass backward with want_dparam: the dq and dk/dv kernels
    and the dcoeff / dtable kernel, each launched once."""
    shape = (2, 6, 577, 64)
    q, k, v, kw = stream_inputs(regime, shape, dtype, cuda, 6)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(17))
    g = g.to(cuda, dtype)
    counts = stream_counts()
    got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                  want_dparam=True, **kw)
    torch.cuda.synchronize()
    poly = int(regime == "poly")
    assert stream_counts() == (counts[0], counts[1] + 1, counts[2] + 1,
                               counts[3], counts[4], counts[5] + poly,
                               counts[6] + 1 - poly)
    want = fa.attention_stream_bwd_plain(
        q, k, v, out, g, lse, scale, kv_tile=fa.STREAM_TILE, want_dparam=True,
        **kw)
    assert len(got) == len(want) == 8
    for x, y in zip(got[6:], want[6:]):
        assert (x is None) == (y is None)
        if x is not None:
            share_of_largest(x, y, PARAM_TOL)
    again = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                    want_dparam=True, **kw)
    assert torch.equal(got[7 - poly], again[7 - poly])
