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
1e-3 of their largest entry; the one-pass backward's prologue to its twin
and to the separate passes' prologue bit for bit, and key chunks that end
inside a cluster of its CTAs to the twin. AdamW: 1e-6 (the same float32 operations, rounded
op by op on both sides, but the twin's float32 sqrt on the CPU is not always
correctly rounded, and on CUDA it divides by a Python scalar as a product with
the reciprocal); bit for bit against fused_adamw.adamw_exact, every operation
correctly rounded. dbias from the dq pass is held to the twin at every batch
size that changes its groups, within and over its byte budget. The chunk
forward (q rows against a key chunk at global offsets) is held to the streaming
forward's numbers, the separate passes' prologue (the operands rounded once)
to its twin bit for bit and delta to 1e-5 of its largest entry, and the
separate passes at ragged N in every regime, dtype and built head dim, every
call launched twice and compared bit for bit, and at (r0, 0) against every key to the whole-sequence
forward's rows bit for bit. The streaming forward (its prologue rounds k and
v once; rows 3 and 4) is held to its twin at the same ragged N, regimes,
dtypes and head dims (and D = 48 through fa.HeadPad), every call launched
twice and compared bit for bit; its prologue to its twin and to the separate
passes' kf bit for bit; the chunk entry at ragged offsets into strided out /
lse views; and the chunk on q, k rotated in PyTorch to the whole-sequence
forward, bit for bit. The dense kernels take two routes, chosen by
fa.dense_resident: resident (one CTA per batch and head) and wide; each is
held to the same twins at N around the resident buckets and past them, every
call launched twice and compared bit for bit, with dbias over a lowered slab
budget. Head dims the kernels are not built for (24, 48,
96) are zero-padded by the wrappers (fa.HeadPad) and held to the twins on the
unpadded tensors with the same numbers. Polynomial degrees 8 and 31 (more terms
than the kernels keep in registers) are held to the twins with each dcoeff term
to 1e-3 of its own largest entry. The fused block forward (row 12) is held to
its twin to 5e-3 of the output's largest entry for f32 inputs and 1e-2 for bf16
(the same rounding points; an LN output, q, k, p, o or GELU output that rounds
to the other bf16 neighbour after a last-ulp difference moves the output by a
fraction of a bf16 ulp of its largest entries); at the plans the wrapper
does not pick itself (every cluster size and tile depth), f32, to 5e-3 of
the largest entry of the block's update (output minus x), as chip_smoke.py
holds its own plans. int8 serving: torch._int_mm behind quant's padding at
the head's shapes bit-equal to the CPU's int32; the serving forward's custom
ops (torch.ops.vit_rpe_rope.*) bit-equal to the wrappers they wrap, counted
as theirs; an artifact exported on the card bit-equal to the live Predictor
at batches 1, 5 and 37. The CUDA graphs of the k-step driver and of k-row
evaluation: bit for bit against the same steps or rows run eagerly, with
dropout, drop-path, the augmentation and attention-prob dropout drawn
inside the graph, under each remat policy too (the recompute's draws from
generators registered with the capture), and on the streaming route at
N = 4,097."""

import dataclasses

import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import block_fused
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
    x = torch.zeros(1, 2, 5, 160, device=cuda)  # above the largest built dim
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


def adamw_leaves(numels, device, seed):
    """p, g, mu, nu lists of float32 leaves of these sizes (mu and nu as a
    few steps leave them: mu signed, nu positive)."""
    gen = torch.Generator().manual_seed(seed)
    p, g, mu, nu = ([torch.randn(n, generator=gen).to(device) for n in numels]
                    for _ in range(4))
    return p, g, [0.1 * m for m in mu], [0.01 * v.square() for v in nu]


ADAMW_HYPER = (1e-3, 0.271, 0.0039, 0.9, 0.999, 1e-8, 0.05)


def adamw_exact(lists, hyper=ADAMW_HYPER):
    """The IEEE op-by-op reference's (p, mu, nu), which the kernel must
    equal bit for bit, and the twin's, on copies."""
    exact = fused_adamw.adamw_exact(*lists, *hyper)
    twin = [[t.clone() for t in group] for group in lists]
    fused_adamw.adamw_plain(*twin, *hyper)
    return exact, (twin[0], twin[2], twin[3])


# One leaf; ViT-S/16's 150 leaves in its sizes' spread; one leaf more than
# one launch takes. Sizes that are not multiples of 4 or of 4,096 send
# chunks through the scalar tail.
ADAMW_CASES = {
    "1 leaf": [4096 * 3 + 5],
    "150 leaves": [int(n) for n in torch.randint(
        1, 600_000, (150,), generator=torch.Generator().manual_seed(30))],
    "MAX_GRADS+1 leaves": [1 + (i * 37) % 9000
                           for i in range(fused_adamw.MAX_GRADS + 1)],
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_kernel_is_the_twin_bit_for_bit(cuda, case):
    numels = ADAMW_CASES[case]
    lists = adamw_leaves(numels, cuda, seed=31)
    want, twin = adamw_exact(lists)
    before = fused_adamw.LAUNCHES_ADAMW
    fused_adamw.adamw_update(*lists, *ADAMW_HYPER)
    torch.cuda.synchronize()
    assert fused_adamw.LAUNCHES_ADAMW == before + len(fused_adamw.build_table(
        [0] * len(numels), [0] * len(numels), [0] * len(numels), numels)[1])
    assert len(numels) <= fused_adamw.MAX_GRADS or \
        fused_adamw.LAUNCHES_ADAMW == before + 2
    for group, exact, plain in zip((lists[0], lists[2], lists[3]), want,
                                   twin):
        for x, y, z in zip(group, exact, plain):
            assert torch.equal(x, y)
            torch.testing.assert_close(x, z, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_adamw_unaligned_leaves_take_the_scalar_path(cuda):
    """Leaves at an odd float offset in their storage (no 16-byte chunk
    alignment) give the same bits as the twin."""
    numels = [4096 + 3, 9, 70001]
    lists = [[t[1:] for t in (torch.randn(n + 1, device=cuda)
                               for n in numels)] for _ in range(4)]
    lists[3] = [t.abs() for t in lists[3]]
    assert all(t.data_ptr() % 16 for t in lists[0])
    want, _ = adamw_exact(lists)
    fused_adamw.adamw_update(*lists, *ADAMW_HYPER)
    for group, exact in zip((lists[0], lists[2], lists[3]), want):
        for x, y in zip(group, exact):
            assert torch.equal(x, y)


class _NoNumpy:
    def __getattr__(self, name):
        raise AssertionError(f"numpy.{name} used on a step")


@pytest.mark.gpu
def test_adamw_steps_reuse_the_device_table(cuda, monkeypatch):
    """Three steps with fresh gradient tensors build the table once and,
    after the first, use no numpy, pin no memory and copy nothing from the
    host (the profiler sees no Memcpy); a step after the parameters are
    swapped for new tensors builds it again. Every step equals the IEEE
    op-by-op reference bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    numels = ADAMW_CASES["150 leaves"]
    params, _, mus, nus = adamw_leaves(numels, cuda, seed=32)
    exact = [[t.clone() for t in group] for group in (params, mus, nus)]
    gen = torch.Generator().manual_seed(33)
    fused_adamw._TABLES.clear()  # earlier tests' storages may lie here too
    builds = fused_adamw.TABLE_BUILDS
    pinned = []

    def step(params, profiled=False):
        grads = [torch.randn(n, generator=gen).to(cuda) for n in numels]
        exact[:] = fused_adamw.adamw_exact(exact[0], grads, exact[1],
                                           exact[2], *ADAMW_HYPER)
        torch.cuda.synchronize()
        if not profiled:
            fused_adamw.adamw_update(params, grads, mus, nus, *ADAMW_HYPER)
            return None
        with monkeypatch.context() as m, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            m.setattr(torch.Tensor, "pin_memory",
                      lambda *a, **k: pinned.append(1))
            m.setattr(fused_adamw, "np", _NoNumpy())
            fused_adamw.adamw_update(params, grads, mus, nus, *ADAMW_HYPER)
            torch.cuda.synchronize()
        return [ev.name for ev in prof.events()]

    step(params)
    assert fused_adamw.TABLE_BUILDS == builds + 1
    for _ in range(2):
        names = step(params, profiled=True)
        assert not [n for n in names if "emcpy" in n], names
        assert sum("adamw_kernel" in n for n in names) == 1
    assert not pinned
    assert fused_adamw.TABLE_BUILDS == builds + 1
    params = [p.clone() for p in params]
    step(params)
    assert fused_adamw.TABLE_BUILDS == builds + 2
    for group, want in zip((params, mus, nus), exact):
        for x, y in zip(group, want):
            assert torch.equal(x, y)


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
    if shape[-1] in fa.HEAD_DIMS:
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


def dbias_case(b, n, dtype, device, seed=40):
    """A materialized relative bias at (b, 6, n, 64): the backward's inputs
    with the forward kernel's out and lse."""
    shape = (b, 6, n, 64)
    q, k, v, kw = stream_inputs("bias", shape, dtype, device, seed)
    out, lse = fa.attention_stream_fwd(q, k, v, 0.125, **kw)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    return (q, k, v, out, g.to(device, dtype), lse, 0.125), kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [577, 300])
@pytest.mark.parametrize("b", [1, 7, 8, 9, 16])
def test_dbias_from_the_dq_pass_matches_twin(cuda, b, n, dtype):
    """dbias from the dq kernel's per-batch ds slabs and the sum kernel
    against the twin (2 x the forward's tolerance of its largest entry, as
    the other batch sums), dq / dk / dv as before, one launch of each pass;
    a second call gives the same bits."""
    args, kw = dbias_case(b, n, dtype, cuda)
    counts = stream_counts()
    got = fa.attention_stream_bwd(*args, want_dbias=True, **kw)
    torch.cuda.synchronize()
    assert stream_counts() == (counts[0], counts[1] + 1, counts[2] + 1,
                               counts[3] + 1) + counts[4:]
    want = fa.attention_stream_bwd_plain(*args, kv_tile=fa.STREAM_TILE,
                                         want_dbias=True, **kw)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x.float(), y.float(), rtol=2 * TOL[dtype],
                                   atol=2 * TOL[dtype])
    assert got[3].shape == (6, n, n) and got[3].dtype == torch.float32
    close_to_largest(got[3], want[3], 2 * TOL[dtype])
    again = fa.attention_stream_bwd(*args, want_dbias=True, **kw)
    for x, y in zip(got[:4], again[:4]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dbias_over_its_byte_budget(cuda, dtype):
    """A budget of 3 slabs at B=16 (3 groups of up to 6 batches, each CTA
    adding its batches in order) and of none (1 group: the same bits as one
    slab per batch); slabs of [H, N, fa.dbias_pitch(N)]; dq, dk and dv do
    not change with the budget."""
    args, kw = dbias_case(16, 577, dtype, cuda, seed=41)
    want = fa.attention_stream_bwd_plain(*args, kv_tile=fa.STREAM_TILE,
                                         want_dbias=True, **kw)
    slab = 6 * 577 * fa.dbias_pitch(577) * 4
    per_batch = fa.attention_stream_bwd(*args, want_dbias=True, **kw)
    assert fa.dbias_groups(16, 6, 577, 3 * slab, fa.dbias_pitch(577)) == 3
    for budget in (3 * slab, 0):
        got = fa.attention_stream_bwd(*args, want_dbias=True,
                                      dbias_budget=budget, **kw)
        close_to_largest(got[3], want[3], 2 * TOL[dtype])
        for x, y in zip(got[:3], per_batch[:3]):
            assert torch.equal(x, y)
    assert torch.equal(got[3], per_batch[3])


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
    if shape[-1] in fa.HEAD_DIMS:
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
@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("n", [17, 290, 4097])
def test_fused_prologue_kernel_is_the_twin_bit_for_bit(cuda, n, regime,
                                                       dtype):
    """The one-pass backward's prologue (q, k rotated op by op in float32,
    every operand rounded to bf16 once, rows zero past N) against its twin,
    and its qf, kf, bf16 v, bf16 g against the separate passes' prologue's,
    bit for bit; and on a key chunk at offsets (no tables: the chunk's keys
    and its own rows only rounded)."""
    shape = (2, 4, n, 32)
    q, k, v, kw = stream_inputs(regime, shape, dtype, cuda, 7)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(8))
    g = g.to(cuda, dtype)
    before = fa.LAUNCHES_STREAM_FUSED_PROLOGUE
    got = fa.attention_stream_bwd_fused_prologue(q, k, v, g, kw["cos"],
                                                 kw["sin"])
    torch.cuda.synchronize()
    assert fa.LAUNCHES_STREAM_FUSED_PROLOGUE == before + 1
    want = fa.attention_stream_bwd_fused_prologue_plain(q, k, v, g, kw["cos"],
                                                        kw["sin"])
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)
    ops, _ = fa.attention_stream_bwd_prologue(q, k, v, g, g, kw["cos"],
                                              kw["sin"])
    for x, y in zip(got, (ops[0], ops[1], ops[2], ops[3])):
        assert torch.equal(x, y)
    rows, cols = slice(n // 3, n), slice(n // 4, n // 4 + n // 2 + 1)
    args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows])
    got = fa.attention_stream_bwd_fused_prologue(*args)
    want = fa.attention_stream_bwd_fused_prologue_plain(*args)
    for x, y in zip(got, want):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
@pytest.mark.parametrize("keys", [1, 128, 129, 1000, 1025])
def test_fused_bwd_kernel_pads_the_last_cluster(cuda, keys, regime):
    """Key chunks of every count against whole clusters of
    fa.FUSED_CLUSTER 128-key CTAs: one key, one CTA, one CTA and a key, a
    cluster short of a CTA, a cluster and a key (the CTAs that pad the grid
    own no keys), rows [0, 700) at offsets (0, 300); launched twice, bit for
    bit."""
    (q, k, v, g, lse, delta, scale), kw = fused_inputs(
        regime, (2, 4, 1400, 32), torch.float32, cuda, 9)
    pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
    rows, cols = slice(0, 700), slice(300, 300 + keys)
    args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows],
            lse[:, :, rows], delta[:, :, rows], scale)
    got = fa.streaming_chunk_bwd(*args, 0, 300, 1400, **pe)
    again = fa.streaming_chunk_bwd(*args, 0, 300, 1400, **pe)
    torch.cuda.synchronize()
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    want = fa.attention_stream_bwd_fused_plain(
        *args, q_tile=512, kv_tile=256, n_valid=1400, row0=0, col0=300, **pe)
    for x, y in zip(got[:3], want[:3]):
        share_of_largest(x, y, FUSED_TOL[torch.float32])
    dparam = want[3] if regime == "poly" else want[4]
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


def chunk_inputs(regime, dtype, device, seed):
    """A sequence of 1100 tokens padded to 1536 rows (the bounded step's
    padding; the padded rows hold random values) with its PE arguments."""
    q, k, v, kw = stream_inputs(regime, (2, 4, 1536, 32), dtype, device, seed)
    return q, k, v, {key: kw[key] for key in ("poly", "rel") if key in kw}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_fwd_kernel_at_offsets_matches_twin(cuda, regime, dtype):
    """Query rows [512, 1536) (436 of them padded rows beyond the 1100 valid
    tokens) against the 1033 keys from global token 300 (a ragged last key
    tile; keys beyond token 1100 masked), read as strided views and written
    into the rows of longer out / lse buffers. The relative index of a
    padded row leaves the table: kernel and twin clamp it alike, so every
    row is compared."""
    q, k, v, pe = chunk_inputs(regime, dtype, cuda, 7)
    rows, cols = slice(512, 1536), slice(300, 1333)
    args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], 32 ** -0.5, 512,
            300, 1100)
    out = torch.zeros((2, 1536, 4, 32), dtype=dtype,
                      device=cuda).transpose(1, 2)
    lse = torch.zeros((2, 4, 1536), device=cuda)
    counts = stream_counts() + (fa.LAUNCHES_STREAM_CHUNK_FWD,)
    got, got_lse = fa.streaming_chunk_fwd(*args, out=out[:, :, rows],
                                          lse=lse[:, :, rows], **pe)
    torch.cuda.synchronize()
    assert stream_counts() + (fa.LAUNCHES_STREAM_CHUNK_FWD,) == (
        counts[:-1] + (counts[-1] + 1,))
    assert got.data_ptr() == out[:, :, 512:].data_ptr()
    assert got_lse.data_ptr() == lse[:, :, 512:].data_ptr()
    assert float(out[:, :, :512].abs().max()) == 0.0
    want, want_lse = fa.attention_stream_plain(
        *args[:4], kv_tile=fa.STREAM_TILE, row0=512, col0=300, n_valid=1100,
        **pe)
    assert torch.isfinite(got.float()).all() and torch.isfinite(got_lse).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)
    fresh, fresh_lse = fa.streaming_chunk_fwd(*args, **pe)
    assert torch.equal(fresh, got) and torch.equal(fresh_lse, got_lse)
    with pytest.raises(ValueError, match="multiply in bfloat16"):
        fa.streaming_chunk_fwd(*args, mm_dtype=torch.float32, **pe)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["none", "poly", "rel"])
def test_chunk_fwd_kernel_against_all_keys_is_the_stream_fwd_rows(cuda, regime,
                                                                  dtype):
    """The chunk entry at (512, 0) against every key of a 1100-token
    sequence computes, bit for bit, rows 512... of the whole-sequence entry
    on the same tensors: one kernel, the same arithmetic per row."""
    q, k, v, pe = chunk_inputs(regime, dtype, cuda, 8)
    q, k, v = (x[:, :, :1100] for x in (q, k, v))
    if regime == "rel":
        pe["rel"] = pe["rel"][:, 1536 - 1100:1536 + 1099]
    whole, whole_lse = fa.attention_stream_fwd(q, k, v, 0.25, **pe)
    got, lse = fa.streaming_chunk_fwd(q[:, :, 512:], k, v, 0.25, 512, 0, 1100,
                                      **pe)
    torch.cuda.synchronize()
    assert torch.equal(got, whole[:, :, 512:])
    assert torch.equal(lse, whole_lse[:, :, 512:])


# ---------------------------------------------------------------------------
# Head dims the kernels are not built for, zero-padded by the wrappers
# ---------------------------------------------------------------------------

PADDED_DIMS = [24, 48, 96]


@pytest.mark.gpu
@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("regime", REGIMES)
def test_dense_kernels_at_padded_head_dims(cuda, regime, d):
    run_and_compare(*inputs(regime, (4, 6, 65, d), torch.float32, cuda,
                            seed=12), torch.float32)
    run_bwd_and_compare(*inputs(regime, (4, 6, 65, d), torch.float32, cuda,
                                seed=13), torch.float32, seed=13)


@pytest.mark.gpu
@pytest.mark.parametrize("d", PADDED_DIMS)
@pytest.mark.parametrize("regime", STREAM_REGIMES)
def test_stream_kernels_at_padded_head_dims(cuda, regime, d):
    run_stream_and_compare(regime, (2, 4, 577, d), torch.float32, cuda,
                           seed=14)
    if regime in FUSED_REGIMES:
        run_fused_and_compare(regime, (2, 4, 577, d), torch.float32, cuda,
                              seed=15)


@pytest.mark.gpu
@pytest.mark.parametrize("d", PADDED_DIMS)
def test_chunk_kernels_at_padded_head_dims(cuda, d):
    """The chunk forward writes into rows of longer out / lse buffers, and
    the chunk backward, at a padded head dim."""
    q, k, v, pe = stream_inputs("poly", (2, 4, 1536, d), torch.float32, cuda,
                                16)
    pe = {"poly": pe["poly"]}
    rows, cols = slice(512, 1536), slice(300, 1333)
    args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], d ** -0.5, 512, 300,
            1100)
    out = torch.zeros((2, 1536, 4, d), device=cuda).transpose(1, 2)
    lse = torch.zeros((2, 4, 1536), device=cuda)
    got, got_lse = fa.streaming_chunk_fwd(*args, out=out[:, :, rows],
                                          lse=lse[:, :, rows], **pe)
    assert got.data_ptr() == out[:, :, 512:].data_ptr()
    want, want_lse = fa.attention_stream_plain(
        *args[:4], kv_tile=fa.STREAM_TILE, row0=512, col0=300, n_valid=1100,
        **pe)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    g = g.to(cuda)
    delta = (g * got).sum(dim=-1)
    bwd = (args[0], args[1], args[2], g, got_lse, delta, args[3])
    got_b = fa.streaming_chunk_bwd(*bwd, 512, 300, 1100, **pe)
    want_b = fa.attention_stream_bwd_fused_plain(
        *bwd, q_tile=512, kv_tile=256, n_valid=1100, row0=512, col0=300, **pe)
    for x, y in zip(got_b[:3], want_b[:3]):
        assert x.shape == y.shape
        share_of_largest(x, y, FUSED_TOL[torch.float32])
    share_of_largest(got_b[3], want_b[3], PARAM_TOL)


# ---------------------------------------------------------------------------
# Polynomial degrees above the eight terms kept in registers
# ---------------------------------------------------------------------------

def high_degree_inputs(degree, shape, device, seed):
    """q, k, v and a polynomial bias of the given degree whose k-th
    coefficient is scaled by (2 grid)^-k, so that every term stays below
    one and float32 holds dist^31 (at grid 8 the distance is at most 14)."""
    gen = torch.Generator().manual_seed(seed)
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen).to(device) for _ in range(3))
    grid = int(round((n - 1) ** 0.5))
    powers = torch.arange(degree + 1).float()
    coeff = 0.5 * torch.randn((h, degree + 1), generator=gen) \
        * float(2 * grid) ** -powers
    return q, k, v, (coeff.to(device), grid)


def per_term(got, want):
    """dcoeff [H, terms]: each term to PARAM_TOL of its own largest entry
    (the terms differ by orders of magnitude)."""
    for m in range(want.shape[1]):
        share_of_largest(got[:, m], want[:, m], PARAM_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("degree,shape", [(8, (2, 6, 577, 64)),
                                          (31, (2, 4, 65, 32))])
def test_stream_kernels_at_high_poly_degree(cuda, degree, shape):
    """The forward, the separate passes with the dcoeff kernel, and the
    one-pass backward (launched twice, bit-identical) at 9 and 32 terms."""
    q, k, v, poly = high_degree_inputs(degree, shape, cuda, 18)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, poly=poly)
    want_out, want_lse = fa.attention_stream_plain(
        q, k, v, scale, poly=poly, kv_tile=fa.STREAM_TILE)
    torch.testing.assert_close(out, want_out, rtol=2e-3, atol=2e-3)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(19))
    g = g.to(cuda)
    counts = stream_counts()
    got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale, poly=poly,
                                  want_dparam=True)
    torch.cuda.synchronize()
    assert stream_counts()[5] == counts[5] + 1
    want = fa.attention_stream_bwd_plain(q, k, v, out, g, lse, scale,
                                         poly=poly, kv_tile=fa.STREAM_TILE,
                                         want_dparam=True)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x, y, rtol=4e-3, atol=4e-3)
    assert got[6].shape == (shape[1], degree + 1)
    per_term(got[6], want[6])
    delta = (g * out).sum(dim=-1)
    args = (q, k, v, g, lse, delta, scale)
    fused = fa.attention_stream_bwd_fused(*args, poly=poly)
    want_f = fa.attention_stream_bwd_fused_plain(*args, poly=poly,
                                                 q_tile=512, kv_tile=256)
    for x, y in zip(fused[:3], want_f[:3]):
        share_of_largest(x, y, FUSED_TOL[torch.float32])
    per_term(fused[3], want_f[3])
    again = fa.attention_stream_bwd_fused(*args, poly=poly)
    for x, y in zip(fused[:4], again[:4]):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The separate passes (rows 6 and 7): prologue, dq, dk/dv, dbias
# ---------------------------------------------------------------------------

# Lengths that end inside a 16-key block, on one, one past a 64-row tile,
# inside a 128-row CTA, ViT-S/16@384's and the long-sequence model's.
SEPARATE_NS = [17, 65, 300, 577, 1100, 4097]
# "poly9": ten terms, more than the kernels keep in registers (MORE).
SEPARATE_REGIMES = STREAM_REGIMES + ["poly9"]


def separate_counts():
    return (fa.LAUNCHES_STREAM_PROLOGUE, fa.LAUNCHES_STREAM_DQ,
            fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS)


def separate_inputs(regime, shape, dtype, device, seed):
    """q, k, v and the streaming wrappers' PE keyword arguments for one of
    SEPARATE_REGIMES ("poly9": ten polynomial terms, no rope tables)."""
    if regime == "poly9":
        q, k, v, poly = high_degree_inputs(9, shape, device, seed)
        q, k, v = (t.to(dtype) for t in (q, k, v))
        return q, k, v, {"poly": poly, "cos": None, "sin": None}
    return stream_inputs(regime, shape, dtype, device, seed)


def run_separate_passes(regime, shape, dtype, device, seed=0,
                        dbias_budget=None):
    """The separate-pass backward (with dbias for a materialized bias and
    dqr / dkr for rope-mixed) launched twice, bit-identical, with exact
    launch counts, against the twin at the kernels' key tile; returns the
    kernels' outputs."""
    q, k, v, kw = separate_inputs(regime, shape, dtype, device, seed)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 11))
    g = g.to(device, dtype)
    opts = dict(kw, want_dbias=kw.get("bias") is not None,
                want_drot=regime == "rope-mixed")
    counts = separate_counts()
    got, again = (fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                          dbias_budget=dbias_budget, **opts)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert separate_counts() == (counts[0] + 2, counts[1] + 2, counts[2] + 2,
                                 counts[3] + 2 * int(opts["want_dbias"]))
    for x, y in zip(got, again):
        assert (x is None and y is None) or torch.equal(x, y)
    want = fa.attention_stream_bwd_plain(q, k, v, out, g, lse, scale,
                                         kv_tile=fa.STREAM_TILE, **opts)
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == dtype and x.shape == q.shape
        torch.testing.assert_close(x.float(), y.float(), rtol=2 * TOL[dtype],
                                   atol=2 * TOL[dtype])
    for x, y in zip(got[3:6], want[3:6]):
        assert (x is None) == (y is None)
        if x is not None:
            close_to_largest(x, y, 2 * TOL[dtype])
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", SEPARATE_REGIMES)
@pytest.mark.parametrize("n", SEPARATE_NS)
def test_separate_passes_match_twin_at_ragged_n(cuda, n, regime, dtype, d):
    """Every regime (a materialized bias with dbias, generated polynomial
    biases of 4 and 10 terms, the relative table, rope-axial, rope-mixed
    with dqr / dkr), both dtypes, every built head dim, at lengths ragged
    against the 16-row blocks, 64-row tiles and 128-row CTAs; the forward
    and the twin as test_stream_kernels_match_twins_at_vit_s_384_shape."""
    run_separate_passes(regime, (2 if n <= 1100 else 1, 2, n, d), dtype, cuda,
                        seed=n + d)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [300, 577])
def test_separate_dbias_within_and_over_a_lowered_budget(cuda, n, dtype):
    """dbias at B=9 with one padded slab per batch, two groups (of 5 and 4
    batches, each CTA adding its batches in order) and one group (the same
    bits as one slab per batch); dq, dk and dv do not change with the
    budget."""
    shape = (9, 6, n, 64)
    slab = 6 * n * fa.dbias_pitch(n) * 4
    per_batch = run_separate_passes("bias", shape, dtype, cuda, seed=5)
    for budget, groups in ((9 * slab, 9), (2 * slab, 2), (0, 1)):
        assert fa.dbias_groups(9, 6, n, budget, fa.dbias_pitch(n)) == groups
        got = run_separate_passes("bias", shape, dtype, cuda, seed=5,
                                  dbias_budget=budget)
        for x, y in zip(got[:3], per_batch[:3]):
            assert torch.equal(x, y)
    assert torch.equal(got[3], per_batch[3])


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(17, 16), (577, 64), (1100, 128),
                                 (4097, 32)])
def test_prologue_matches_its_twin(cuda, n, d, dtype, regime):
    """The operands rounded once (q, k, v from strided views of one qkv
    buffer, as the models hand them over): bit for bit, zero rows past N;
    delta to 1e-5 of its largest entry (float32 sums in another order); one
    launch."""
    b, h = 2, 2
    _, _, _, kw = stream_inputs(regime, (b, h, n, d), dtype, cuda, seed=n)
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(cuda, dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    out, g = (torch.randn(b, h, n, d, generator=gen).to(cuda, dtype)
              for _ in range(2))
    before = fa.LAUNCHES_STREAM_PROLOGUE
    ops, delta = fa.attention_stream_bwd_prologue(q, k, v, out, g, kw["cos"],
                                                  kw["sin"])
    torch.cuda.synchronize()
    assert fa.LAUNCHES_STREAM_PROLOGUE == before + 1
    want_ops, want_delta = fa.attention_stream_bwd_prologue_plain(
        q, k, v, out, g, kw["cos"], kw["sin"])
    assert ops.shape == (4, b, h, fa.stream_bwd_rows(n), d)
    assert torch.equal(ops, want_ops)
    close_to_largest(delta, want_delta, 1e-5)


# ---------------------------------------------------------------------------
# The streaming forward (rows 3 and 4): its prologue, the whole sequence,
# the chunk
# ---------------------------------------------------------------------------

def fwd_counts():
    return (fa.LAUNCHES_STREAM_FWD_PROLOGUE, fa.LAUNCHES_STREAM_FWD,
            fa.LAUNCHES_STREAM_CHUNK_FWD)


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS + (48,))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", SEPARATE_REGIMES)
@pytest.mark.parametrize("n", SEPARATE_NS)
def test_stream_fwd_matches_twin_at_ragged_n(cuda, n, regime, dtype, d):
    """The whole-sequence forward in every regime (a materialized bias,
    generated polynomial biases of 4 and 10 terms, the relative table,
    rope-axial, rope-mixed), both dtypes, every built head dim and D = 48
    through fa.HeadPad, at lengths ragged against the 16-key blocks, 64-key
    tiles and 128-row CTAs: launched twice, bit-identical, one prologue
    before each launch; against the twin at the kernels' key tile; at a
    built head dim the prologue's operands bit for bit against its twin."""
    shape = (2 if n <= 1100 else 1, 2, n, d)
    q, k, v, kw = separate_inputs(regime, shape, dtype, cuda, seed=n + d + 1)
    scale = d ** -0.5
    counts = fwd_counts()
    (out, lse), (again, again_lse) = [
        fa.attention_stream_fwd(q, k, v, scale, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert fwd_counts() == (counts[0] + 2, counts[1] + 2, counts[2])
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    assert out.dtype == dtype and out.shape == q.shape
    want, want_lse = fa.attention_stream_plain(q, k, v, scale,
                                               kv_tile=fa.STREAM_TILE, **kw)
    torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    if d in fa.HEAD_DIMS:
        ops = fa.attention_stream_fwd_prologue(k, v, kw["cos"], kw["sin"])
        assert ops.shape == (2,) + shape[:2] + (fa.stream_fwd_rows(n), d)
        assert torch.equal(ops, fa.attention_stream_fwd_prologue_plain(
            k, v, kw["cos"], kw["sin"]))


@pytest.mark.gpu
@pytest.mark.parametrize("regime", ["none", "rope-axial", "rope-mixed"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(17, 16), (577, 64), (1100, 128),
                                 (4097, 32)])
def test_fwd_prologue_is_the_separate_passes_kf(cuda, n, d, dtype, regime):
    """The forward's prologue on strided views of one qkv buffer (as the
    models hand k and v over) writes the separate passes' kf and bf16 v bit
    for bit, zero rows past N; one launch each."""
    b, h = 2, 2
    _, _, _, kw = stream_inputs(regime, (b, h, n, d), dtype, cuda, seed=n)
    gen = torch.Generator().manual_seed(d)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(cuda, dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    out, g = (torch.randn(b, h, n, d, generator=gen).to(cuda, dtype)
              for _ in range(2))
    counts = fwd_counts()
    ops = fa.attention_stream_fwd_prologue(k, v, kw["cos"], kw["sin"])
    bwd_ops, _ = fa.attention_stream_bwd_prologue(q, k, v, out, g, kw["cos"],
                                                  kw["sin"])
    torch.cuda.synchronize()
    assert fwd_counts() == (counts[0] + 1,) + counts[1:]
    assert not ops[:, :, :, n:].any()
    assert torch.equal(ops[:, :, :, :n], bwd_ops[1:3, :, :, :n])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [577, 300])
def test_streaming_function_pads_the_bias_once(cuda, n, monkeypatch):
    """StreamingAttentionFunction copies a bias whose rows are not whole
    16-byte pieces once, in its forward, and its backward reads that copy;
    out and every gradient equal the wrappers' on the contiguous bias, bit
    for bit."""
    copies = []
    pitched = fa.pitched_bias

    def counting(bias):
        got = pitched(bias)
        if got is not bias:
            copies.append(tuple(got.shape))
        return got

    monkeypatch.setattr(fa, "pitched_bias", counting)
    shape = (2, 6, n, 64)
    q, k, v, kw = stream_inputs("bias", shape, torch.float32, cuda, seed=n)
    bias = kw["bias"]
    leaves = [t.requires_grad_() for t in (q, k, v, bias)]
    g = torch.randn(shape, generator=torch.Generator().manual_seed(6))
    g = g.to(cuda)
    out = fa.StreamingAttentionFunction.apply(q, k, v, bias, None, None, None,
                                              None, 0, 0.125)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert copies == ([(6, n, n)] if n % 4 else [])
    q, k, v, bias = (t.detach() for t in leaves)
    want, lse = fa.attention_stream_fwd(q, k, v, 0.125, bias)
    assert torch.equal(out, want)
    want = fa.attention_stream_bwd(q, k, v, want, g, lse, 0.125, bias,
                                   want_dbias=True)
    for x, y in zip(got, want[:4]):
        assert torch.equal(x, y)


# Chunk geometries: (query rows, keys) as global [start, end) of a sequence
# padded to 1536 rows, and the valid tokens. "inner": rows past n_valid and
# keys past it (the chunk's valid keys fewer than its keys, in a ragged last
# tile); "first": the first rows against the first keys, all valid; "tail":
# the last rows against a key chunk with 12 valid keys of 448.
CHUNK_GEOMETRIES = {"inner": ((512, 1536), (300, 1333), 1100),
                    "first": ((0, 200), (0, 577), 577),
                    "tail": ((1024, 1536), (1088, 1536), 1100)}


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["none", "poly", "poly9", "rel"])
@pytest.mark.parametrize("geometry", list(CHUNK_GEOMETRIES))
def test_chunk_fwd_matches_twin_at_ragged_offsets(cuda, geometry, regime,
                                                 dtype, d):
    """The chunk entry at global offsets, from strided views into the rows
    of longer out / lse buffers and again into fresh ones, bit-identical,
    one prologue before each launch; against the twin at the kernels' key
    tile, every row (the padded ones too: kernel and twin clamp the
    relative index alike)."""
    (r0, r1), (c0, c1), n_valid = CHUNK_GEOMETRIES[geometry]
    q, k, v, kw = separate_inputs(regime, (2, 4, 1536, d), dtype, cuda,
                                  seed=r0 + c0 + d)
    pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
    args = (q[:, :, r0:r1], k[:, :, c0:c1], v[:, :, c0:c1], d ** -0.5, r0,
            c0, n_valid)
    out = torch.zeros((2, 1536, 4, d), dtype=dtype, device=cuda)
    out = out.transpose(1, 2)
    lse = torch.zeros((2, 4, 1536), device=cuda)
    counts = fwd_counts()
    got, got_lse = fa.streaming_chunk_fwd(*args, out=out[:, :, r0:r1],
                                          lse=lse[:, :, r0:r1], **pe)
    fresh, fresh_lse = fa.streaming_chunk_fwd(*args, **pe)
    torch.cuda.synchronize()
    assert fwd_counts() == (counts[0] + 2, counts[1], counts[2] + 2)
    assert got.data_ptr() == out[:, :, r0:].data_ptr()
    assert torch.equal(fresh, got) and torch.equal(fresh_lse, got_lse)
    assert not out[:, :, :r0].any() and not out[:, :, r1:].any()
    want, want_lse = fa.attention_stream_plain(
        *args[:4], kv_tile=fa.STREAM_TILE, row0=r0, col0=c0, n_valid=n_valid,
        **pe)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(got_lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_fwd_writes_through_an_unaligned_out_view(cuda, dtype):
    """An out view whose rows the kernel's 16-byte stores cannot reach (a
    row pitch of D + 2 elements) is written through a copy: the same bits
    as into a fresh tensor, the pad columns untouched."""
    q, k, v, pe = chunk_inputs("rel", dtype, cuda, 9)
    args = (q[:, :, 512:], k[:, :, 300:1333], v[:, :, 300:1333], 32 ** -0.5,
            512, 300, 1100)
    buf = torch.full((2, 4, 1024, 34), 7.0, dtype=dtype, device=cuda)
    got, lse = fa.streaming_chunk_fwd(*args, out=buf[..., :32], **pe)
    want, want_lse = fa.streaming_chunk_fwd(*args, **pe)
    torch.cuda.synchronize()
    assert got.data_ptr() == buf.data_ptr()
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert bool((buf[..., 32:] == 7.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("n", [577, 1100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["rope-axial", "rope-mixed"])
def test_chunk_fwd_on_rotated_qk_is_the_stream_fwd(cuda, regime, dtype, n, d):
    """q and k rotated in PyTorch (float32, op by op, as train/bounded.py
    rotates them) and rounded to the input dtype, then the chunk entry
    against every key, give the whole-sequence forward that rotates in its
    kernel and prologue, bit for bit."""
    q, k, v, kw = stream_inputs(regime, (2, 4, n, d), dtype, cuda, seed=n + d)
    cos, sin = kw["cos"][None], kw["sin"][None]
    whole, whole_lse = fa.attention_stream_fwd(q, k, v, d ** -0.5, **kw)
    rq, rk = (fa._rotate(x.float(), cos, sin).to(dtype) for x in (q, k))
    got, lse = fa.streaming_chunk_fwd(rq, rk, v, d ** -0.5, 0, 0, n)
    torch.cuda.synchronize()
    assert torch.equal(got, whole) and torch.equal(lse, whole_lse)


# ---------------------------------------------------------------------------
# The fused block forward (row 12)
# ---------------------------------------------------------------------------

def block_case(b, img, patch, e, heads, pe, dtype, device, seed):
    cfg = ViTConfig(img_size=img, patch_size=patch, embed_dim=e, depth=1,
                    num_heads=heads, pos_encoding=pe)
    params = vit.init_params(torch.Generator().manual_seed(seed), cfg,
                             device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    bp = {nm: params[f"blocks.0.{nm}"]
          + 0.05 * torch.randn(params[f"blocks.0.{nm}"].shape,
                               generator=gen).to(device)
          for nm in vit.BLOCK_PARAM_NAMES}
    x = torch.randn((b, cfg.seq_len, e), generator=gen).to(device, dtype)
    freqs = (pe_registry.get(pe).freqs_cis({}, cfg, device=device)
             if pe == "rope-axial" else None)
    return cfg, bp, x, freqs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pe", ["none", "rope-axial"])
@pytest.mark.parametrize("shape", [(16, 32, 4, 192, 6), (2, 16, 4, 64, 2)])
def test_block_fused_kernel_matches_twin(cuda, shape, pe, dtype):
    """ViT-tiny/4 (N=65, E=192, 6 heads of 32) and the CPU tests' shape
    (N=17, E=64, 2 heads): one launch, bit-identical when launched again."""
    cfg, bp, x, freqs = block_case(*shape, pe, dtype, cuda, seed=20)
    before = block_fused.LAUNCHES_BLOCK_FUSED
    got = block_fused.block_forward(x, bp, cfg, freqs_cis=freqs)
    torch.cuda.synchronize()
    assert block_fused.LAUNCHES_BLOCK_FUSED == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = block_fused.block_forward_plain(x, bp, cfg, freqs)
    tol = 5e-3 if dtype == torch.float32 else 1e-2
    share_of_largest(got, want, tol)
    again = block_fused.block_forward(x, bp, cfg, freqs_cis=freqs,
                                      batch_tile=1)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pe", ["none", "rope-axial"])
def test_block_fused_kernel_matches_twin_at_vit_s(cuda, pe, dtype):
    """ViT-S/16 at 224 px (N=197, E=384, 6 heads of 64, hidden 1536), batch
    64: more than one CTA's shared memory holds, so the image runs on a
    cluster (block_fused.block_plan); one launch of the kernel and one of
    the weight prologue, bit-identical when launched again."""
    cfg, bp, x, freqs = block_case(64, 224, 16, 384, 6, pe, dtype, cuda,
                                   seed=21)
    assert block_fused.block_plan(197, 384, 64, 1536)["CLUSTER"] > 1
    before = (block_fused.LAUNCHES_BLOCK_FUSED,
              block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE)
    got = block_fused.block_forward(x, bp, cfg, freqs_cis=freqs)
    torch.cuda.synchronize()
    assert (block_fused.LAUNCHES_BLOCK_FUSED,
            block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE) == (before[0] + 1,
                                                           before[1] + 1)
    assert got.dtype == dtype and got.shape == x.shape
    want = block_fused.block_forward_plain(x, bp, cfg, freqs)
    share_of_largest(got, want, 5e-3 if dtype == torch.float32 else 1e-2)
    assert torch.equal(got, block_fused.block_forward(x, bp, cfg,
                                                      freqs_cis=freqs))


BLOCK_CLUSTER_CASES = [
    (shape, n, size)
    for shape, n in (((16, 32, 4, 192, 6), 65), ((8, 224, 16, 384, 6), 197),
                     ((2, 16, 4, 64, 2), 17))
    for size in block_fused.cluster_sizes(n, shape[3], shape[3] // shape[4],
                                          4 * shape[3])]
BLOCK_FUSED_TOL = 5e-3  # chip_smoke.py's, as a share of the block's update


def within_update_share(got, want, x, tol):
    """max |got - want| <= tol * max |want - x| for float32 outputs: the
    error as a share of the block's update (chip_smoke.update_share), which
    the residual x in the output would hide under its own size."""
    assert bool(torch.isfinite(got).all())
    err = float((got - want).abs().max())
    assert err <= tol * float((want - x).abs().max()), err


def forced_plan(cfg, **kw):
    return block_fused.block_plan(cfg.seq_len, cfg.embed_dim, cfg.head_dim,
                                  cfg.mlp_hidden_dim, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["none", "rope-axial"])
@pytest.mark.parametrize("shape,n,size", BLOCK_CLUSTER_CASES)
def test_block_fused_kernel_every_cluster_size(cuda, shape, n, size, pe):
    """Every cluster size block_plan can take for ViT-tiny/4, ViT-S/16@224
    and the CPU tests' shape, f32, launched with that plan: the kernel
    against the twin as a share of the update, launched twice,
    bit-identical."""
    cfg, bp, x, freqs = block_case(*shape, pe, torch.float32, cuda, seed=24)
    assert cfg.seq_len == n
    plan = forced_plan(cfg, cluster=size)
    got = block_fused._launch(x, bp, cfg, freqs, plan)
    want = block_fused.block_forward_plain(x, bp, cfg, freqs)
    within_update_share(got, want, x, BLOCK_FUSED_TOL)
    assert torch.equal(got, block_fused._launch(x, bp, cfg, freqs, plan))


@pytest.mark.gpu
@pytest.mark.parametrize("kt", [64, 128])
def test_block_fused_kernel_every_tile_depth(cuda, kt):
    """ViT-S/16@224 in clusters of 13 (both tile depths fit), rope-axial,
    f32: the kernel against the twin as a share of the update."""
    cfg, bp, x, freqs = block_case(8, 224, 16, 384, 6, "rope-axial",
                                   torch.float32, cuda, seed=26)
    got = block_fused._launch(x, bp, cfg, freqs,
                              forced_plan(cfg, cluster=13, kt=kt))
    within_update_share(got, block_fused.block_forward_plain(x, bp, cfg,
                                                             freqs),
                        x, BLOCK_FUSED_TOL)


@pytest.mark.gpu
def test_block_fused_kernel_refuses_what_it_cannot_hold(cuda):
    """ViT-S/16 at 384 px (N=577): the scores of a row tile against more
    than 208 keys do not fit in a warp's registers; a width whose rows do
    not fit in 227 KB a CTA in any cluster (E=1024 at N=197) is refused by
    the plan, both before anything is launched."""
    cfg, bp, x, _ = block_case(2, 384, 16, 384, 6, "none", torch.float32,
                               cuda, seed=23)
    before = block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE
    with pytest.raises(ValueError, match="at most 208 tokens"):
        block_fused.block_forward(x, bp, cfg)
    with pytest.raises(ValueError, match="232448 bytes"):
        block_fused.block_plan(197, 1024, 64, 4096)
    assert block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE == before


@pytest.mark.gpu
@pytest.mark.parametrize("kt", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_fused_prologue_is_its_twin(cuda, dtype, kt):
    """The weight prologue lays the four matrices out in the ring's tiles,
    rounded to bf16, bit for bit as block_weights_bf16_plain (from f32 and
    from bf16 weights), at ViT-S/16's widths."""
    _, bp, _, _ = block_case(2, 224, 16, 384, 6, "none", torch.float32,
                             cuda, seed=25)
    bp = {k: v.to(dtype) for k, v in bp.items()}
    got = block_fused.block_weights_bf16(bp, cuda, 64, kt)
    assert torch.equal(got, block_fused.block_weights_bf16_plain(bp, 64, kt))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_fused_kernel_rotates_by_head_0_with_per_head_tables(cuda,
                                                                   dtype):
    """rope-mixed's [H, S, D/2] tables at ViT-tiny/4, perturbed so that the
    heads' tables differ: the kernel rotates every head by head 0's table,
    as the JAX block_forward does, and matches the twin."""
    cfg, bp, x, _ = block_case(16, 32, 4, 192, 6, "rope-mixed", dtype, cuda,
                               seed=22)
    params = pe_registry.get("rope-mixed").init_params(
        torch.Generator().manual_seed(0), cfg)
    freqs = pe_registry.get("rope-mixed").freqs_cis(params, cfg,
                                                     device=cuda)
    assert freqs[0].dim() == 3 and not torch.equal(freqs[0][0], freqs[0][1])
    got = block_fused.block_forward(x, bp, cfg, freqs_cis=freqs)
    want = block_fused.block_forward_plain(x, bp, cfg,
                                           (freqs[0][0], freqs[1][0]))
    share_of_largest(got, want, 5e-3 if dtype == torch.float32 else 1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["none", "absolute", "rope-axial",
                                "rope-mixed"])
@pytest.mark.parametrize("threshold", [None, 64])
def test_flash_block_grads_match_flash_on_the_card(cuda, pe, threshold,
                                                   monkeypatch):
    """attention_impl="flash_block" against "flash" on the kernels: every
    gradient within 2e-3 relative (norm of the difference over the norm),
    the JAX package's bound; with a threshold of 64 the N=65 model takes the
    streaming kernels (the one-pass backward, or the separate passes for
    rope-mixed)."""
    if threshold is not None:
        monkeypatch.setattr(fa, "STREAMING_THRESHOLD", threshold)
    grads = {}
    for impl in ("flash", "flash_block"):
        cfg = ViTConfig(img_size=32, patch_size=4, embed_dim=192, depth=2,
                        num_heads=6, pos_encoding=pe, attention_impl=impl)
        params = vit.init_params(torch.Generator().manual_seed(23), cfg,
                                 device=cuda)
        params = {k: v.requires_grad_() for k, v in params.items()}
        x = torch.randn((8, 32, 32, 3),
                        generator=torch.Generator().manual_seed(24)).to(cuda)
        y = torch.arange(8, device=cuda) % 10
        loss = torch.nn.functional.cross_entropy(vit.apply(params, x, cfg), y)
        grads[impl] = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    for key, want in grads["flash"].items():
        got = grads["flash_block"][key]
        rel = float((got - want).norm() / want.norm().clamp(min=1e-12))
        assert rel < 2e-3, (key, rel)


# ---------------------------------------------------------------------------
# The dense kernels' two routes: resident (one CTA per batch and head, N up
# to 16 * fa.RESIDENT_MAX_BLOCKS) and wide (the other dense shapes)
# ---------------------------------------------------------------------------

ROUTE_NS = [1, 16, 17, 50, 65, 80, 197, 16 * fa.RESIDENT_MAX_BLOCKS,
            16 * fa.RESIDENT_MAX_BLOCKS + 1]


def route_counts():
    return (fa.LAUNCHES_RESIDENT, fa.LAUNCHES_WIDE, fa.LAUNCHES_BWD_RESIDENT,
            fa.LAUNCHES_BWD_WIDE)


def run_route_case(regime, shape, dtype, device, seed, dbias_budget=None):
    """Forward and backward against the twins, each launched twice and
    bit-identical, on the route dense_resident names; returns the route."""
    q, k, v, kw = inputs(regime, shape, dtype, device, seed=seed)
    b, h, n, d = shape
    bias, cos, sin = fa.prepare_pe(h, n, device, **kw)
    resident = fa.dense_resident(h, n, d, bias is not None)
    scale = d ** -0.5
    before = route_counts()
    out = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
    out2 = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to(device, dtype)
    args = (q, k, v, out, g, scale, bias, cos, sin)
    kw_bwd = dict(want_dbias=bias is not None, want_drot=cos is not None)
    got = fa.attention_bwd(*args, dbias_budget=dbias_budget, **kw_bwd)
    again = fa.attention_bwd(*args, dbias_budget=dbias_budget, **kw_bwd)
    torch.cuda.synchronize()
    after = route_counts()
    want_out = fa.attention_plain(q, k, v, scale, bias, cos, sin)
    torch.testing.assert_close(out.float(), want_out.float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(out, out2)
    want = fa.attention_bwd_plain(*args, **kw_bwd)
    for i, (x, y, z) in enumerate(zip(got, again, want)):
        assert (x is None) == (z is None)
        if x is None:
            continue
        assert torch.equal(x, y)
        if i < 3:  # dq, dk, dv
            torch.testing.assert_close(x.float(), z.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype])
        else:
            close_to_largest(x, z, TOL[dtype])
    grown = [a - c for a, c in zip(after, before)]
    assert grown == ([2, 0, 2, 0] if resident else [0, 2, 0, 2])
    return "resident" if resident else "wide"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n", ROUTE_NS)
def test_dense_routes_match_twins(cuda, n, d, dtype, b):
    """Every regime (rel with dbias) at each N around the resident route's
    buckets (5 and 13 blocks of 16 rows) and one past it."""
    regimes = REGIMES if n > 1 else ["none", "rel"]
    routes = {run_route_case(regime, (b, 2, n, d), dtype, cuda, seed=60 + i)
              for i, regime in enumerate(regimes)}
    assert routes == {"resident" if n <= 16 * fa.RESIDENT_MAX_BLOCKS
                      else "wide"}


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65, 197])
def test_resident_kernels_read_strided_qkv_views(cuda, n):
    """q, k, v as views of one [B, N, 3, H, D] product, forward and
    backward on the resident route."""
    b, h, d = 3, 6, 64
    gen = torch.Generator().manual_seed(70)
    qkv = torch.randn(b, n, 3, h, d, generator=gen).to(cuda)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    assert not q.is_contiguous() and fa.dense_resident(h, n, d, True)
    bias = fa._dense_bias(h, n, cuda, rel=torch.randn(
        h, 2 * n - 1, generator=gen).to(cuda))
    before = route_counts()
    out = fa.attention_fwd(q, k, v, 0.125, bias)
    g = torch.randn(b, h, n, d, generator=gen).to(cuda)
    got = fa.attention_bwd(q, k, v, out, g, 0.125, bias, want_dbias=True)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(route_counts(), before)] == [1, 0, 1, 0]
    torch.testing.assert_close(out, fa.attention_plain(q, k, v, 0.125, bias),
                               rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    want = fa.attention_bwd_plain(q, k, v, out, g, 0.125, bias,
                                  want_dbias=True)
    for x, y in zip(got[:3], want[:3]):
        torch.testing.assert_close(x, y, rtol=TOL[torch.float32],
                                   atol=TOL[torch.float32])
    close_to_largest(got[3], want[3], TOL[torch.float32])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,slabs", [(9, 2), (9, 1), (7, 3)])
def test_resident_dbias_over_a_lowered_slab_budget(cuda, b, slabs, dtype):
    """Fewer slabs than batches: CTAs take runs of batches, adding each
    batch's ds into their slab in order."""
    h, n, d = 2, 65, 32
    budget = slabs * h * n * fa._round_up(n, 4) * 4
    assert fa.dbias_groups(b, h, n, budget, fa._round_up(n, 4)) <= slabs
    run_route_case("rel", (b, h, n, d), dtype, cuda, seed=80,
                   dbias_budget=budget)


@pytest.mark.gpu
@pytest.mark.parametrize("live", [1.0, 0.0])
@pytest.mark.parametrize("case", ["1 leaf", "MAX_GRADS+1 leaves"])
def test_adamw_table_entry_is_exact_bit_for_bit(cuda, case, live):
    """The device-table entry reads (lr, c1, c2, live) from device memory:
    live, it equals adamw_exact bit for bit, as the by-value entry does;
    not live, it leaves p, mu and nu as they were. Its launches count in
    LAUNCHES_ADAMW_TABLE."""
    numels = ADAMW_CASES[case]
    lists = adamw_leaves(numels, cuda, seed=33)
    want, _ = adamw_exact(lists)
    if not live:
        want = [[t.clone() for t in lists[i]] for i in (0, 2, 3)]
    lr, c1, c2 = ADAMW_HYPER[:3]
    rows = fused_adamw.hyper_rows([(0.0, 1.0, 1.0, 0.0), (lr, c1, c2, live)],
                                  cuda)
    before = (fused_adamw.LAUNCHES_ADAMW, fused_adamw.LAUNCHES_ADAMW_TABLE)
    fused_adamw.adamw_update_table(*lists, rows[1], *ADAMW_HYPER[3:])
    torch.cuda.synchronize()
    n_launches = len(fused_adamw.build_table(
        [0] * len(numels), [0] * len(numels), [0] * len(numels), numels)[1])
    assert (fused_adamw.LAUNCHES_ADAMW,
            fused_adamw.LAUNCHES_ADAMW_TABLE) == (before[0],
                                                  before[1] + n_launches)
    for group, exact in zip((lists[0], lists[2], lists[3]), want):
        for x, y in zip(group, exact):
            assert torch.equal(x, y)


def graph_run(k, accum, steps, device, graphed, pe="rope-mixed", batch=32,
              augment=False, **model):
    """`steps` optimizer steps of ViT-tiny/4 (depth cut to 2; `model`
    overrides its fields) at batch `batch` through make_train_multi_step,
    on the CUDA graph or (graphed False) eagerly under the NaN sanitizer's
    flag; returns the params, the AdamW state, the metrics, the launch
    counts and the driver."""
    from vit_rpe_rope_tpu_torch.configs import TrainConfig
    from vit_rpe_rope_tpu_torch.data import datasets
    from vit_rpe_rope_tpu_torch.ops import launches
    from vit_rpe_rope_tpu_torch.train import train_step as ts
    from vit_rpe_rope_tpu_torch.utils import nan_check

    cfg = ViTConfig(**{"depth": 2, "pos_encoding": pe, **model})
    bundle = datasets.synthetic("cifar10",  # the last batch partial
                                n_train=batch * steps * accum - batch // 8
                                - 1, n_test=8, seed=3)
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 32,
                             augment=augment)
    params = vit.init_params(torch.Generator().manual_seed(3), cfg,
                             device=device)
    for v in params.values():
        v.requires_grad_(True)
    init, update = ts.make_optimizer(TrainConfig(dataset="cifar10"), steps,
                                     params)
    state = init(params)
    fn = ts.make_train_multi_step(cfg, update, pre, k, accum=accum, seed=5)
    idx = ts.pad_epoch_indices(ts.epoch_indices(
        len(bundle.train_y), batch, True, seed=3), k * accum).to(device)
    x, y = ts.epoch_order_data(torch.from_numpy(bundle.train_x).to(device),
                               torch.from_numpy(bundle.train_y).to(device),
                               idx)
    metrics = []
    before = launches.counts()
    nan_check.ACTIVE = not graphed  # the driver's reason to run eagerly
    try:
        for row in range(0, idx.shape[0], k * accum):
            params, state, m = fn(params, state, row, x, y, idx, epoch=2)
            metrics.append(m)
    finally:
        nan_check.ACTIVE = False
    torch.cuda.synchronize()
    return params, state, torch.cat(metrics), launches.since(before), fn


def assert_runs_equal(eager, graph, steps):
    """Params, moments, AdamW count and metrics of two graph_run results,
    bit for bit."""
    assert graph[4].capture_seconds is not None
    assert eager[4].capture_seconds is None
    assert eager[1][2] == graph[1][2] == steps
    assert torch.equal(eager[2], graph[2])
    for key in eager[0]:
        assert torch.equal(eager[0][key], graph[0][key]), key
        assert torch.equal(eager[1][0][key], graph[1][0][key]), key
        assert torch.equal(eager[1][1][key], graph[1][1][key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("k,accum,steps", [(4, 1, 8), (3, 1, 4), (2, 2, 4)])
def test_graph_driver_is_the_eager_driver_bit_for_bit(cuda, k, accum, steps):
    """The k steps replayed from one CUDA graph equal the same k steps run
    eagerly, bit for bit (params, moments, count, metrics; padded steps
    where k does not divide the steps); the counts add each replay's
    launches: the graph run launches the attention kernels and the AdamW
    table entry once per captured step and replay, plus the one warm-up
    step."""
    eager = graph_run(k, accum, steps, cuda, graphed=False)
    graph = graph_run(k, accum, steps, cuda, graphed=True)
    assert_runs_equal(eager, graph, steps)
    dispatches = -(-steps // k)
    name = "vit_rpe_rope_tpu_torch.ops.flash_attention"
    adamw = "vit_rpe_rope_tpu_torch.ops.fused_adamw"
    depth = 2
    # both drivers run every step of a dispatch, padded ones too
    assert eager[3][name, "LAUNCHES"] == depth * dispatches * k * accum
    assert graph[3][name, "LAUNCHES"] == depth * (dispatches * k + 1) * accum
    assert graph[3][name, "LAUNCHES_BWD"] == graph[3][name, "LAUNCHES"]
    assert eager[3][adamw, "LAUNCHES_ADAMW"] == steps
    assert (adamw, "LAUNCHES_ADAMW") not in graph[3]
    assert graph[3][adamw, "LAUNCHES_ADAMW_TABLE"] == dispatches * k + 1


@pytest.mark.gpu
@pytest.mark.parametrize("k,accum,steps,model", [
    (4, 1, 8, dict(drop_rate=0.1, drop_path_rate=0.1)),
    (3, 1, 4, dict(drop_rate=0.1, drop_path_rate=0.1)),
    (2, 2, 4, dict(drop_rate=0.1, drop_path_rate=0.1)),
    (2, 1, 4, dict(attn_drop_rate=0.1))])
def test_graph_driver_draws_the_eager_draws(cuda, k, accum, steps, model):
    """Steps that draw (dropout, drop-path and the augmentation; attention
    -prob dropout on the unfused attention) captured with the graph's own
    generators, re-seeded per replay from row_seeds, equal the eager
    steps on step_generators' fresh generators bit for bit, and differ
    from the same steps without draws (the draws reach the update)."""
    eager = graph_run(k, accum, steps, cuda, graphed=False, augment=True,
                      **model)
    graph = graph_run(k, accum, steps, cuda, graphed=True, augment=True,
                      **model)
    assert_runs_equal(eager, graph, steps)
    plain = graph_run(k, accum, steps, cuda, graphed=True)
    assert not torch.equal(plain[2], graph[2])


@pytest.mark.gpu
@pytest.mark.parametrize("rates", [
    dict(drop_rate=0.1, drop_path_rate=0.1),
    dict(drop_rate=0.1, drop_path_rate=0.1, attn_drop_rate=0.1)])
@pytest.mark.parametrize("policy", ["full", "dots", "softmax"])
@pytest.mark.parametrize("k,accum,steps", [(4, 1, 8), (2, 2, 4)])
def test_graph_driver_draws_the_eager_draws_under_remat(cuda, k, accum,
                                                        steps, policy, rates):
    """Remat steps that draw, captured: the recompute of "full" and "dots"
    draws the forward's masks again from generators of its own registered
    with the capture (models.vit.GraphDraws), "softmax" recomputes nothing
    but the unfused attention's probabilities; the graph equals the eager
    steps bit for bit, and these equal the steps without remat. On the
    kernels (no attention-prob dropout) the train steps launch the
    attention forward twice a block under "full" and "dots", once under
    "softmax"."""
    remat = dict(remat=True, remat_policy=policy, **rates)
    eager = graph_run(k, accum, steps, cuda, graphed=False, **remat)
    graph = graph_run(k, accum, steps, cuda, graphed=True, **remat)
    assert_runs_equal(eager, graph, steps)
    plain = graph_run(k, accum, steps, cuda, graphed=False, **rates)
    assert torch.equal(plain[2], graph[2])
    for key in plain[0]:
        assert torch.equal(plain[0][key], graph[0][key]), key
    if "attn_drop_rate" not in rates:
        name = "vit_rpe_rope_tpu_torch.ops.flash_attention"
        rows = (-(-steps // k) * k + 1) * accum
        times = 1 if policy == "softmax" else 2
        assert graph[3][name, "LAUNCHES"] == times * 2 * rows
        assert graph[3][name, "LAUNCHES_BWD"] == 2 * rows


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_step_that_draws_is_captured(cuda, policy, capsys):
    """The k-step driver captures remat steps that draw (dropout,
    drop-path, the augmentation) without raising and without the eager
    notice; a capture that fails would raise."""
    graph = graph_run(2, 1, 2, cuda, graphed=True, augment=True, remat=True,
                      remat_policy=policy, drop_rate=0.1, drop_path_rate=0.1)
    assert graph[4].capture_seconds is not None
    assert "eagerly" not in capsys.readouterr().out
    assert all(torch.isfinite(graph[2]).reshape(-1))


@pytest.mark.gpu
@pytest.mark.parametrize("pe", ["rope-mixed", "relative"])
def test_streaming_graph_driver_is_the_eager_driver(cuda, pe):
    """The long-sequence model (N = 4,097, depth 2, batch 4) on the
    streaming route, two steps a dispatch over four: the graph (its
    scratch allocated under capture, from the graph's pool) equals the
    eager steps bit for bit, and counts each streaming kernel once per
    captured step and replay plus the warm-up step: rope-mixed the
    separate passes, relative (a generated bias above 2,048 tokens) the
    one-pass backward, each with its prologue."""
    model = dict(img_size=256, patch_size=4, embed_dim=128, num_heads=4)
    eager = graph_run(2, 1, 4, cuda, graphed=False, pe=pe, batch=4, **model)
    graph = graph_run(2, 1, 4, cuda, graphed=True, pe=pe, batch=4, **model)
    assert_runs_equal(eager, graph, 4)
    name = "vit_rpe_rope_tpu_torch.ops.flash_attention"
    launched = {key[1]: n for key, n in graph[3].items() if key[0] == name}
    kernels = (["LAUNCHES_STREAM_PROLOGUE", "LAUNCHES_STREAM_DQ",
                "LAUNCHES_STREAM_DKV"] if pe == "rope-mixed" else
               ["LAUNCHES_STREAM_FUSED", "LAUNCHES_STREAM_FUSED_PROLOGUE"])
    for kernel in ["LAUNCHES_STREAM_FWD", "LAUNCHES_STREAM_FWD_PROLOGUE",
                   *kernels]:
        assert launched[kernel] == 2 * 5, kernel


def eval_run(k, device, graphed, rows=10, batch=32):
    """Evaluation of ViT-tiny/4 (depth 2, rope-mixed) over `rows` index
    rows of `batch` (the last partial) padded to a multiple of k, k rows a
    call, on the CUDA graph or (graphed False) eagerly under the NaN
    sanitizer's flag; returns the metrics rows, the launch counts and the
    step."""
    from vit_rpe_rope_tpu_torch.data import datasets
    from vit_rpe_rope_tpu_torch.ops import launches
    from vit_rpe_rope_tpu_torch.train import train_step as ts
    from vit_rpe_rope_tpu_torch.utils import nan_check

    cfg = ViTConfig(depth=2, pos_encoding="rope-mixed")
    bundle = datasets.synthetic("cifar10", n_train=8,
                                n_test=rows * batch - 7, seed=4)
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 32)
    params = vit.init_params(torch.Generator().manual_seed(4), cfg,
                             device=device)
    step = ts.make_eval_step(cfg, pre, k=k)
    idx = ts.pad_epoch_indices(ts.epoch_indices(len(bundle.test_y), batch,
                                                False), k).to(device)
    x = torch.from_numpy(bundle.test_x).to(device)
    y = torch.from_numpy(bundle.test_y).to(device)
    before = launches.counts()
    nan_check.ACTIVE = not graphed
    try:
        out = torch.cat([step(params, row, x, y, idx).reshape(-1, 3)
                         for row in range(0, idx.shape[0], k)])
    finally:
        nan_check.ACTIVE = False
    torch.cuda.synchronize()
    return out, launches.since(before), step


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 4])
def test_eval_graph_is_the_per_row_evaluation(cuda, k):
    """k evaluation rows replayed from one CUDA graph equal the k = 1
    calls bit for bit (and the eager k rows), padded rows at count 0; the
    graph counts each captured forward per replay, plus one warm-up
    forward."""
    one = eval_run(1, cuda, graphed=True)
    eager = eval_run(k, cuda, graphed=False)
    graph = eval_run(k, cuda, graphed=True)
    n = -(-10 // k) * k
    assert graph[0].shape == (n, 3)
    assert torch.equal(graph[0][:10], one[0])
    assert torch.equal(graph[0], eager[0])
    assert (graph[0][10:] == 0).all()
    assert graph[2].capture_seconds is not None
    assert eager[2].capture_seconds is None
    name = "vit_rpe_rope_tpu_torch.ops.flash_attention"
    assert one[1][name, "LAUNCHES"] == 2 * 10
    assert graph[1][name, "LAUNCHES"] == 2 * (n + 1)


@pytest.mark.gpu
def test_graph_capture_failure_raises(cuda, monkeypatch):
    """A step that cannot be captured (here: one that reads a value on the
    host) makes the driver raise; it never falls back to eager steps."""
    from vit_rpe_rope_tpu_torch.train import train_step as ts

    real = ts._grads_and_metrics

    def syncing(*args, **kwargs):
        grads, metrics = real(*args, **kwargs)
        float(metrics[0])  # a host read: illegal while capturing
        return grads, metrics

    monkeypatch.setattr(ts, "_grads_and_metrics", syncing)
    with pytest.raises(RuntimeError, match="CUDA graph"):
        graph_run(2, 1, 2, cuda, graphed=True)


# ---------------------------------------------------------------------------
# int8 serving and serving artifacts: torch._int_mm behind quant's padding,
# the serving forward's custom ops, an artifact exported on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 2, 5, 8, 15, 16])
@pytest.mark.parametrize("k", [16, 48])
def test_int_mm_padded_shapes_match_the_cpu(cuda, rows, k):
    """quant._int_mm at the head's shape (10 classes) and small batches,
    which torch._int_mm on CUDA takes only zero-padded: the card's int32
    product bit-equal to the CPU's, counted once."""
    from vit_rpe_rope_tpu_torch import quant

    gen = torch.Generator().manual_seed(rows * 100 + k)
    x = torch.randint(-127, 128, (rows, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (10, k), generator=gen, dtype=torch.int8)
    before = quant.LAUNCHES_INT_MM
    got = quant._int_mm(x.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert quant.LAUNCHES_INT_MM == before + 1
    assert got.dtype == torch.int32 and got.shape == (rows, 10)
    assert torch.equal(got.cpu(), quant._int_mm(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", REGIMES)
def test_dense_custom_op_is_its_wrapper(cuda, regime, dtype):
    """torch.ops.vit_rpe_rope.attn_fwd on CUDA tensors (strided q, k, v as a
    block makes them) is attention_fwd bit for bit, counted as one launch,
    laid out as its fake tensor says."""
    b, h, n, d = 4, 6, 197, 64
    q, k, v, kw = inputs(regime, (b, h, n, d), dtype, cuda, seed=21)
    q, k, v = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous() \
        .permute(2, 0, 3, 1, 4).unbind(0)  # views of one [B, N, 3, H, D]
    bias, cos, sin = fa.prepare_pe(h, n, cuda, **kw)
    before = fa.LAUNCHES
    got = torch.ops.vit_rpe_rope.attn_fwd(q, k, v, d ** -0.5, bias, cos, sin)
    want = fa.attention_fwd(q, k, v, d ** -0.5, bias, cos, sin)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    assert got.stride() == (n * h * d, d, h * d, 1)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("regime", ["none", "bias", "poly", "rel",
                                    "rope-axial", "rope-mixed"])
def test_streaming_custom_op_is_its_wrapper(cuda, regime, dtype):
    """torch.ops.vit_rpe_rope.attn_stream_fwd is attention_stream_fwd bit
    for bit (out and lse), one forward and one prologue launch."""
    b, h, n, d = 2, 4, 577, 32
    q, k, v, kw = inputs("rel" if regime == "bias" else regime,
                         (b, h, n, d), dtype, cuda, seed=22)
    bias, cos, sin = fa.prepare_pe(h, n, cuda,
                                   freqs_cis=kw.get("freqs_cis"))
    coeff, grid, table = None, 0, None
    if regime == "bias":
        bias = fa._dense_bias(h, n, cuda, rel=kw["rel"])
    elif regime == "poly":
        coeff, grid = kw["poly"]
    elif regime == "rel":
        table = kw["rel"]
    before = (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_FWD_PROLOGUE)
    out, lse = torch.ops.vit_rpe_rope.attn_stream_fwd(
        q, k, v, d ** -0.5, bias, cos, sin, coeff, grid, table)
    want, want_lse = fa.attention_stream_fwd(
        q, k, v, d ** -0.5, bias, cos, sin,
        (coeff, grid) if coeff is not None else None, table)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_STREAM_FWD, fa.LAUNCHES_STREAM_FWD_PROLOGUE) == (
        before[0] + 2, before[1] + 2)
    assert out.stride() == (n * h * d, d, h * d, 1)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, "w8a8"])
def test_artifact_exported_on_the_card_replays_bit_equal(cuda, tmp_path,
                                                         int8):
    """A ViT-tiny/4-like model (depth 2) exported on the card, saved and
    loaded: bit-equal to the live Predictor at batches 1, 5 and 37, the
    dense kernel launched once a block per replay."""
    from vit_rpe_rope_tpu_torch import serving

    cfg = ViTConfig(img_size=32, patch_size=4, embed_dim=192, depth=2,
                    num_heads=6, pos_encoding="rope-mixed")
    params = vit.init_params(torch.Generator().manual_seed(23), cfg,
                             device="cpu")
    live = serving.Predictor.from_params(params, cfg, 0.5, 0.25, 32,
                                         device=cuda, int8=int8)
    path = serving.save_artifact(
        str(tmp_path / "m"), serving.export_model(params, cfg, 0.5, 0.25, 32,
                                                  int8=int8, device=cuda))
    served = serving.Predictor.from_artifact(path, device=cuda)
    with pytest.raises(ValueError, match="exported for cuda"):
        serving.Predictor.from_artifact(path, device="cpu")
    images = torch.randint(0, 256, (37, 32, 32, 3),
                           generator=torch.Generator().manual_seed(24),
                           dtype=torch.uint8).numpy()
    for b in (1, 5, 37):
        before = fa.LAUNCHES
        got = served.logits(images[:b])
        assert fa.LAUNCHES == before + cfg.depth
        assert np.array_equal(got, live.logits(images[:b])), b
