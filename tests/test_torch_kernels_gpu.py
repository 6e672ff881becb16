"""PyTorch port, the CUDA kernels on the card: each kernel against its plain
PyTorch twin on the same CUDA tensors (dense and streaming attention,
forward and backward, fused AdamW). Every test here needs a CUDA device and
skips without one (the kernels have no CPU mode; the twins are tested
against the JAX package on the CPU in tests/test_torch_attention.py,
test_torch_attention_bwd.py, test_torch_attention_stream.py,
test_torch_attention_stream_bwd.py and test_torch_fused_adamw.py).

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
another order). AdamW: 1e-6 (the same float32 operations, rounded op by op
on both sides)."""

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


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "rel", "poly", "rope-mixed"])
def test_streaming_autograd_matches_reference_autograd(cuda, regime):
    """flash_attention at N=577, H=6 (the dense tiles do not fit, so it
    streams; rel and poly train through a materialized bias and the dbias
    kernel) against autograd through the unfused f32 oracle: 5e-2 of the
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
    counts = (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_DQ,
              fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS, fa.LAUNCHES,
              fa.LAUNCHES_BWD)
    got = torch.autograd.grad(fa.flash_attention(q, k, v, 0.125, **kw),
                              leaves, g)
    has_bias = regime in ("rel", "poly")
    assert (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_DQ,
            fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS, fa.LAUNCHES,
            fa.LAUNCHES_BWD) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 1,
        counts[3] + int(has_bias), counts[4], counts[5])
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
    the kernel and agrees with the materialized one; training the table
    raises and names the kernel that is missing."""
    shape = (1, 2, 2305, 32)
    for regime in ("poly", "rel"):
        q, k, v, kw = inputs(regime, shape, torch.float32, cuda, seed=6)
        with torch.no_grad():
            got = fa.flash_attention(q, k, v, 0.2, **kw)
            bias = fa._dense_bias(2, 2305, cuda, **kw)
            want = fa.flash_attention(q, k, v, 0.2, bias=bias)
        torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
        param = kw["poly"][0] if regime == "poly" else kw["rel"]
        param.requires_grad_()
        with pytest.raises(NotImplementedError,
                           match="_stream_bwd_fused_kernel"):
            fa.flash_attention(q, k, v, 0.2, **kw)
