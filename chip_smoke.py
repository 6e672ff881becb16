#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vit_rpe_rope_tpu_torch).

  python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
exits nonzero without a card, or when any phase fails. Phases:

1. the card (nvidia-smi name and power limit), versions, the build of the
   three kernels (attn_fwd.cu, attn_bwd.cu, adamw.cu; one nvcc each, in
   parallel);
2. the attention kernel against its plain PyTorch twin on the card, in five
   PE regimes (none, poly bias, rel bias, rope-axial, rope-mixed), f32 and
   bf16 inputs, at the ViT-S/16@224 shape (N=197, D=64) and the
   ViT-tiny/4 CIFAR shape (N=65, D=32);
3. the serving path at full width: a seeded ViT-S/16@224 rope-mixed
   checkpoint through the predict CLI (256 uint8 32x32 images, batch 64),
   counting the kernel's launches; logits against the unfused reference on
   the card; then the ViT-tiny/4 CIFAR config in all six PE modes;
4. HTTP: the serve CLI's server on an ephemeral port, three requests;
5. times on the card (CUDA events, medians): the kernel, its twin, the
   PyTorch SDPA call as a yardstick, serving images/s, and a
   torch.profiler breakdown of the ViT-S forward by kernel;
6. the attention backward kernel against its twin (dq, dk, dv, dbias,
   dcos/dsin) in the five regimes, f32 and bf16, at B=64 N=197 D=64 and
   B=128 N=65 D=32; autograd through both kernels against autograd
   through the unfused f32 oracle;
7. the fused AdamW kernel against its twin: 3 steps on the ViT-S/16
   params;
8. training at full width through the train CLI (ViT-tiny/4 CIFAR
   defaults, synthetic CIFAR-10, one epoch) in rope-mixed and relative,
   counting every kernel's launches; the best checkpoint served by the
   Predictor reproduces the CSV's test accuracy;
9. five train steps on the kernel path against the plain path (unfused
   attention + the AdamW twin) from one init on the same batches;
10. times: a ViT-S/16@224 rope-mixed f32 train step at batch 64 with a
   profiler breakdown, and the backward and AdamW kernels against their
   twins, their bounds and a PyTorch call as a yardstick.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
BF16_TENSOR_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core peak
PE_NAMES = ("none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed")
REGIMES = ("none", "poly", "rel", "rope-axial", "rope-mixed")
# Kernel vs twin (same rounding points; f32 sums in another order, so a p or
# an output at a bf16 rounding boundary may round the other way):
KERNEL_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
# Kernel path vs the unfused f32 reference, on logits (bf16 products in
# every attention, through every block).
LOGITS_TOL = 2e-2
# Backward kernel vs twin, abs + rel on dq/dk/dv: one bf16 ulp of ds
# (2^-9 at |ds| ~ 0.5, reached with a strong bias) times scale*|k| <= 0.5
# is 1e-3 per term whose rounding flips after a last-ulp f32 difference,
# and a row can hold a few; bf16 inputs add one output ulp. The batch sums
# (dbias, dcos/dsin) are held to the same numbers times their largest entry.
BWD_TOL = {torch.float32: 4e-3, torch.bfloat16: 2e-2}
# Autograd through the kernels vs through the unfused f32 oracle, relative
# to each gradient's largest entry: bf16 rounding of q, k, g and v gives
# logits and gv a relative error near 2^-8, which the softmax and the
# products carry into every gradient (the twin on the CPU already reaches
# 1.6e-2 at B=64 with a unit-variance relative bias).
AUTOGRAD_TOL = 5e-2
# AdamW kernel vs twin: the same float32 operations rounded op by op.
ADAMW_TOL = 1e-6
# Per-step train losses, kernel path vs plain path: bf16 products in the
# attention on one side, and AdamW turns near-zero gradient differences
# into +-lr parameter differences that the loss then carries.
TRAIN_LOSS_TOL = 2e-2
# What one epoch of the train CLI must reach, per PE mode. rope-mixed
# solves the position-coded synthetic task within an epoch. The 1-D
# relative bias learns it slowly (VALIDATION.md: 17.9% after two epochs in
# the JAX package): its epoch-mean train loss still holds the first steps'
# losses above ln 10, so it is held to its end-of-epoch test loss and to
# an accuracy above chance instead.
LEARN_BAR = {"rope-mixed": {"train_loss": math.log(10), "test_acc": 90.0},
             "relative": {"test_loss": math.log(10), "test_acc": 12.0}}
VIT_S = dict(img_size=224, patch_size=16, embed_dim=384, depth=12,
             num_heads=6)


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name, seconds):
    log(name)
    t0 = time.perf_counter()
    yield
    seconds[name.split()[0]] = time.perf_counter() - t0
    log(f"    ({seconds[name.split()[0]]:.1f} s)")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def median_ms(fn, iters=20, reps=7, warmup=5):
    """Median over reps of the mean time of `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def attn_inputs(regime, shape, dtype, seed, device):
    """q, k, v and flash_attention PE kwargs, from a CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    b, h, n, d = shape
    q, k, v = (torch.randn(shape, generator=gen).to(device, dtype)
               for _ in range(3))
    kw = {}
    if regime == "poly":
        grid = int(round((n - 1) ** 0.5))
        kw["poly"] = (0.05 * torch.randn((h, 4), generator=gen).to(device), grid)
    elif regime == "rel":
        kw["rel"] = torch.randn((h, 2 * n - 1), generator=gen).to(device)
    elif regime.startswith("rope"):
        fshape = (n - 1, d // 2) if regime == "rope-axial" else (h, n - 1, d // 2)
        phase = 6.0 * torch.rand(fshape, generator=gen).to(device)
        kw["freqs_cis"] = (torch.cos(phase), torch.sin(phase))
    return q, k, v, kw


def check_kernel_vs_twin(fa, device):
    """Phase 2. Returns the worst max |kernel - twin| at the slice shape."""
    worst_slice = 0.0
    for shape in ((8, 6, 197, 64), (8, 6, 65, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            for i, regime in enumerate(REGIMES):
                q, k, v, kw = attn_inputs(regime, shape, dtype, 100 + i, device)
                bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
                scale = shape[-1] ** -0.5
                got = fa.flash_attention(q, k, v, scale, **kw)
                torch.cuda.synchronize()
                want = fa.attention_plain(q, k, v, scale, bias, cos, sin)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                tol = KERNEL_TOL[dtype]
                ok = bool((err <= tol + tol * want.float().abs()).all())
                max_err = float(err.max())
                log(f"kernel vs twin  N={shape[2]} D={shape[3]} "
                    f"{str(dtype)[6:]:8s} {regime:10s} max_abs_err="
                    f"{max_err:.3e} tol={tol:g}(abs+rel) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError(f"kernel disagrees with its twin: "
                                         f"{regime} {shape} {dtype}")
                if shape[2] == 197 and dtype == torch.float32:
                    worst_slice = max(worst_slice, max_err)
    return worst_slice


def batched_logits(predictor, images, bs=64):
    return np.concatenate([predictor.logits(images[s:s + bs])
                           for s in range(0, len(images), bs)])


def serve_through_cli(tmp, cfg, name, images, grid_size, modules):
    """Write a seeded checkpoint, classify `images` through the predict CLI
    with the kernel launch count reset just before and read just after.
    Returns (ckpt, predictions, launches, seconds)."""
    fa, vit, checkpoint, predict = modules
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ckpt = checkpoint.save(os.path.join(tmp, name), params, vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    inputs = os.path.join(tmp, name + ".input.npz")
    labels = np.random.default_rng(1).integers(0, 10, len(images))
    np.savez(inputs, images=images, labels=labels)
    argv = [ckpt, "--input", inputs, "--batch_size", "64"]
    if grid_size is not None:
        argv += ["--grid_size", str(grid_size)]
    torch.cuda.synchronize()
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    preds = predict.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return ckpt, preds, fa.LAUNCHES, seconds


def compare_with_reference(serving, ckpt, grid_size, images, preds):
    """Kernel-path logits: finite, equal to the CLI's predictions, and
    within LOGITS_TOL of the unfused reference path on the card."""
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        ckpt, grid_size=grid_size)
    kernel = serving.Predictor.from_params(params, cfg, mean, std, native)
    reference = serving.Predictor.from_params(
        params, dataclasses.replace(cfg, attention_impl="reference"), mean,
        std, native)
    got = batched_logits(kernel, images)
    want = batched_logits(reference, images)
    if got.shape != (len(images), cfg.num_classes) or not np.isfinite(got).all():
        raise AssertionError(f"bad logits: shape {got.shape}")
    if not np.array_equal(np.argmax(got, -1), preds):
        raise AssertionError("CLI predictions differ from the Predictor's")
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    agree = float((np.argmax(want, -1) == preds).mean())
    log(f"  logits vs reference: max_abs_err={err:.3e} (|logits| <= "
        f"{scale:.3f}, tol {LOGITS_TOL:g}), argmax agreement {agree:.4f}")
    if err > LOGITS_TOL * max(1.0, scale):
        raise AssertionError("kernel path disagrees with the reference path")
    return kernel, reference


def check_http(serve, predictor, images):
    """Phase 4: three POSTs (batch 1, 16, 64) against the Predictor."""
    server = serve.make_server(predictor, "127.0.0.1", 0, 1024)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            log(f"  GET /health -> {json.loads(r.read())}")
        for bs in (1, 16, 64):
            batch = images[:bs]
            buf = io.BytesIO()
            np.savez(buf, images=batch)
            req = urllib.request.Request(url + "/predict", data=buf.getvalue(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())["predictions"]
            want = predictor.predict(batch).tolist()
            log(f"  POST /predict batch {bs}: {'match' if got == want else 'MISMATCH'}")
            if got != want:
                raise AssertionError(f"HTTP predictions differ at batch {bs}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("server thread did not stop")


def attention_bound_ms(shape, dtype, bias, cos):
    """Least time for the kernel's work: each input read once and the
    output written once over the memory rate, against the two products at
    the bf16 tensor-core peak (the kernel's operands are bf16)."""
    b, h, n, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 4 * b * h * n * d * elem
    if bias is not None:
        nbytes += bias.numel() * 4
    if cos is not None:
        nbytes += 2 * cos.numel() * 4
    flops = 4 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_attention(fa, device):
    """Phase 5a: the kernel at the serving slice shape (B=64, H=6, N=197,
    D=64) against its twin and against PyTorch SDPA on pre-rotated q/k."""
    import torch.nn.functional as F

    rows = {}
    shape = (64, 6, 197, 64)
    scale = shape[-1] ** -0.5
    for label, regime, dtype in (("rope-mixed f32", "rope-mixed", torch.float32),
                                 ("rope-mixed bf16", "rope-mixed", torch.bfloat16),
                                 ("rel-bias f32", "rel", torch.float32)):
        q, k, v, kw = attn_inputs(regime, shape, dtype, 7, device)
        bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
        qr, kr = q, k
        if cos is not None:
            qr = fa._rotate(q.float(), cos[None], sin[None]).to(dtype)
            kr = fa._rotate(k.float(), cos[None], sin[None]).to(dtype)
        mask = None if bias is None else bias.to(dtype)[None]
        kernel_ms = median_ms(lambda: fa.attention_fwd(q, k, v, scale, bias,
                                                       cos, sin))
        plain_ms = median_ms(lambda: fa.attention_plain(q, k, v, scale, bias,
                                                        cos, sin))
        library_ms = median_ms(lambda: F.scaled_dot_product_attention(
            qr, kr, v, attn_mask=mask, scale=scale))
        bound_ms, bound_by = attention_bound_ms(shape, dtype, bias, cos)
        rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        log(f"  attention {label:16s} kernel {kernel_ms:.4f} ms  twin "
            f"{plain_ms:.4f} ms  sdpa {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    return rows


def time_serving(kernel, reference, images):
    """Phase 5b: ViT-S/16@224 serving at batch 64 — Predictor.logits end to
    end (host copies included), and the device forward alone."""
    batch = images[:64]
    out = {}
    for label, pred in (("kernel", kernel), ("reference", reference)):
        for _ in range(3):
            pred.logits(batch)
        n_calls = 10
        t0 = time.perf_counter()
        for _ in range(n_calls):
            pred.logits(batch)
        dt = time.perf_counter() - t0
        params = pred.model.params()
        u8 = torch.from_numpy(batch).to(pred.device)
        with torch.inference_mode():
            fwd_ms = median_ms(lambda: pred._infer(params, u8), iters=5,
                               reps=5, warmup=2)
        out[label] = dict(img_per_s=64 * n_calls / dt, forward_ms=fwd_ms)
        log(f"  serving ViT-S/16@224 bs64 ({label} attention): "
            f"{64 * n_calls / dt:.1f} img/s end to end, device forward "
            f"{fwd_ms:.3f} ms/batch ({64e3 / fwd_ms:.1f} img/s)")
    return out


def profile_forward(predictor, images, n_iter=3):
    """Phase 5c: torch.profiler over n_iter device forwards at batch 64 —
    device time by kernel name, and the device's busy share of the wall
    time of the window. Returns {} when the profiler sees no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = predictor.model.params()
    u8 = torch.from_numpy(images[:64]).to(predictor.device)
    with torch.inference_mode():
        predictor._infer(params, u8)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_iter):
                predictor._infer(params, u8)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3 / n_iter)
    if not by_name:
        log("  profiler: no device time seen (not measured)")
        return {}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile: device busy {busy:.3f} ms per forward of "
        f"{wall_ms / n_iter:.3f} ms wall ({100 * busy * n_iter / wall_ms:.1f}%"
        f" busy, profiler on)")
    for name, ms in top:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    return {"busy_ms": busy, "wall_ms": wall_ms / n_iter,
            "top": [[name, ms] for name, ms in top]}


def worst_err(got, want, tol, scale_to_largest=False):
    """max |got - want| and whether it is within tol (abs + rel, or times
    the largest |want| for the batch sums)."""
    err = (got.float() - want.float()).abs()
    if scale_to_largest:
        ok = bool((err <= tol * max(1.0, float(want.abs().max()))).all())
    else:
        ok = bool((err <= tol + tol * want.float().abs()).all())
    return float(err.max()), ok and bool(torch.isfinite(got).all())


def bwd_case(fa, regime, shape, dtype, seed, device):
    """The backward kernel and its twin on one case. Returns
    {output: (max_abs_err, ok)}."""
    q, k, v, kw = attn_inputs(regime, shape, dtype, seed, device)
    bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
    scale = shape[-1] ** -0.5
    out = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
    gen = torch.Generator().manual_seed(seed + 1)
    g = torch.randn(shape, generator=gen).to(device, dtype)
    want_drot = regime == "rope-mixed"
    args = (q, k, v, out, g, scale, bias, cos, sin)
    got = fa.attention_bwd(*args, want_dbias=bias is not None,
                           want_drot=want_drot)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(*args, want_dbias=bias is not None,
                                  want_drot=want_drot)
    tol = BWD_TOL[dtype]
    res = {name: worst_err(x, y, tol)
           for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3])}
    if bias is not None:
        res["dbias"] = worst_err(got[3], want[3], tol, scale_to_largest=True)
    if want_drot:
        for name, x, y in zip(
                ("dcos", "dsin"),
                fa._rot_grads_to_dfreqs(q, k, got[4], got[5], kw["freqs_cis"]),
                fa._rot_grads_to_dfreqs(q, k, want[4], want[5],
                                        kw["freqs_cis"])):
            res[name] = worst_err(x, y, tol, scale_to_largest=True)
    return res


def check_bwd_vs_twin(fa, device):
    """Phase 6a. Returns the worst dq/dk/dv error at the slice shape, f32."""
    worst_slice = 0.0
    for shape in ((64, 6, 197, 64), (128, 6, 65, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            for i, regime in enumerate(REGIMES):
                res = bwd_case(fa, regime, shape, dtype, 200 + i, device)
                ok = all(r[1] for r in res.values())
                log(f"bwd vs twin  N={shape[2]} D={shape[3]} "
                    f"{str(dtype)[6:]:8s} {regime:10s} "
                    + " ".join(f"{k}={v[0]:.2e}" for k, v in res.items())
                    + f" tol={BWD_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"backward kernel disagrees with its "
                                         f"twin: {regime} {shape} {dtype}")
                if shape[2] == 197 and dtype == torch.float32:
                    worst_slice = max(worst_slice, res["dq"][0], res["dk"][0],
                                      res["dv"][0])
    return worst_slice


def check_autograd_vs_oracle(fa, reference_attention, device):
    """Phase 6b: gradients of q, k, v and the PE parameters through the
    autograd Function (forward and backward kernels) against autograd
    through the unfused f32 oracle, at the slice shape. Polynomial
    coefficients are scaled by grid^-k: unscaled ones saturate the softmax
    at grid 14 and the degree-3 gradient weighs dbias by distance^3."""
    shape = (64, 6, 197, 64)
    for i, regime in enumerate(REGIMES):
        q, k, v, kw = attn_inputs(regime, shape, torch.float32, 300 + i,
                                  device)
        if "poly" in kw:
            coeff, grid = kw["poly"]
            powers = torch.arange(coeff.shape[1], device=device).float()
            kw["poly"] = (coeff * float(grid) ** -powers, grid)
        leaves = [t.requires_grad_() for t in (q, k, v)]
        if "poly" in kw:
            leaves.append(kw["poly"][0].requires_grad_())
        if "rel" in kw:
            leaves.append(kw["rel"].requires_grad_())
        if regime == "rope-mixed":
            leaves += [t.requires_grad_() for t in kw["freqs_cis"]]
        g = torch.randn(shape, generator=torch.Generator().manual_seed(9))
        g = g.to(device)
        got = torch.autograd.grad(fa.flash_attention(q, k, v, 0.125, **kw),
                                  leaves, g)
        ref_kw = ({"freqs_cis": kw["freqs_cis"]} if "freqs_cis" in kw else
                  {"bias": fa._dense_bias(shape[1], shape[2], device,
                                          poly=kw.get("poly"),
                                          rel=kw.get("rel"))})
        want = torch.autograd.grad(reference_attention.attention(
            q, k, v, 0.125, **ref_kw), leaves, g)
        errs = [worst_err(x, y, AUTOGRAD_TOL, scale_to_largest=True)
                for x, y in zip(got, want)]
        ok = all(e[1] for e in errs)
        log(f"  autograd kernels vs f32 oracle {regime:10s} "
            + " ".join(f"{e[0]:.2e}" for e in errs)
            + f" (tol {AUTOGRAD_TOL:g} x largest) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel gradients disagree with the "
                                 f"oracle's: {regime}")


def check_adamw(fused_adamw, vit, cfg, device):
    """Phase 7: 3 AdamW steps on the ViT-S params, kernel vs twin. Returns
    the worst error over params and moments."""
    gen = torch.Generator().manual_seed(21)
    params = vit.init_params(gen, cfg, device=device)
    twin = {k: v.clone() for k, v in params.items()}
    schedule = lambda step: 1e-3 * (0.9 ** step)  # noqa: E731
    init, update = fused_adamw.make_fused_adamw(params, schedule,
                                                weight_decay=0.05)
    tinit, tupdate = fused_adamw.make_fused_adamw(
        twin, schedule, weight_decay=0.05, step=fused_adamw.adamw_plain)
    state, tstate = init(params), tinit(twin)
    fused_adamw.LAUNCHES_ADAMW = 0
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=gen).to(device)
                 for k, v in params.items()}
        params, state = update(grads, state, params)
        twin, tstate = tupdate(grads, tstate, twin)
    torch.cuda.synchronize()
    launches = fused_adamw.LAUNCHES_ADAMW
    worst, ok = 0.0, True
    for key in params:
        for x, y in ((params[key], twin[key]), (state[0][key], tstate[0][key]),
                     (state[1][key], tstate[1][key])):
            err, good = worst_err(x, y, ADAMW_TOL)
            worst, ok = max(worst, err), ok and good
    log(f"  AdamW kernel vs twin: {vit.num_params(params):,} params, 3 steps,"
        f" wd 0.05: max_abs_err={worst:.3e} (tol {ADAMW_TOL:g} abs+rel), "
        f"launches {launches} {'ok' if ok and launches == 3 else 'FAIL'}")
    if not ok or launches != 3:
        raise AssertionError("AdamW kernel disagrees with its twin")
    return worst


def reset_counts(fa, fused_adamw):
    fa.LAUNCHES = fa.LAUNCHES_BWD = fused_adamw.LAUNCHES_ADAMW = 0


def read_counts(fa, fused_adamw):
    torch.cuda.synchronize()
    return {"attn_fwd": fa.LAUNCHES, "attn_bwd": fa.LAUNCHES_BWD,
            "adamw": fused_adamw.LAUNCHES_ADAMW}


def train_through_cli(pe_name, modules):
    """Phase 8 for one PE mode: the train CLI at its defaults on synthetic
    CIFAR-10 for one epoch (run in a scratch directory, so the default
    logs/ and checkpoints/ land there), with every count reset just before
    and read just after; then the best checkpoint through the Predictor."""
    fa, fused_adamw, train_cli, serving, datasets = modules
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts(fa, fused_adamw)
            t0 = time.perf_counter()
            summary = train_cli.main(["--dataset", "cifar10", "--synthetic",
                                      "--epochs", "1", "--pos_encoding",
                                      pe_name])
            counts = read_counts(fa, fused_adamw)
            seconds = time.perf_counter() - t0
            with open(summary["log_file"]) as f:
                rows = [line.strip().split(",") for line in f]
            ckpt = os.path.abspath(summary["ckpt_path"])
            params, cfg, mean, std, native, _ = serving.load_serving_state(ckpt)
            predictor = serving.Predictor.from_params(params, cfg, mean, std,
                                                      native)
            test = datasets.synthetic("cifar10", seed=0)
            fa.LAUNCHES = 0
            preds = np.concatenate([predictor.predict(test.test_x[s:s + 128])
                                    for s in range(0, len(test.test_y), 128)])
            serve_fwd = read_counts(fa, fused_adamw)["attn_fwd"]
        finally:
            os.chdir(cwd)
    header = ["epoch", "train_loss", "train_acc", "test_loss", "test_acc",
              "best_acc"]
    row = dict(zip(header, rows[1])) if len(rows) > 1 else {}
    served_acc = 100.0 * float((preds == test.test_y).mean())
    steps, evals = 12800 // 128, 2560 // 128
    expected = {"attn_fwd": 6 * (steps + evals), "attn_bwd": 6 * steps,
                "adamw": steps}
    log(f"  train CLI {pe_name}: {seconds:.1f} s, CSV {rows[0]} + "
        f"{len(rows) - 1} row(s): {row}")
    log(f"    launches {counts} (expected {expected}); the Predictor on the "
        f"best checkpoint: {len(preds)} test images, accuracy "
        f"{served_acc:.4f}% ({serve_fwd} more attn_fwd launches, expected "
        f"{6 * evals})")
    if rows[0] != header or len(rows) != 2:
        raise AssertionError(f"bad CSV: {rows}")
    test_acc = float(row["test_acc"])
    for key, bar in LEARN_BAR[pe_name].items():
        value = float(row[key])
        if not (value > bar if key == "test_acc" else value < bar):
            raise AssertionError(f"{pe_name} did not learn: {key} {value} "
                                 f"(bar {bar})")
    if abs(served_acc - test_acc) > 1e-9:
        raise AssertionError(f"served accuracy {served_acc} != CSV test_acc "
                             f"{test_acc}")
    if counts != expected or serve_fwd != 6 * evals:
        raise AssertionError(f"launch counts {counts}/{serve_fwd} differ "
                             f"from {expected}/{6 * evals}")
    return dict(seconds=seconds, csv=row, launches=counts,
                served_acc=served_acc,
                images_per_s=summary["history"][0]["images_per_sec"])


def check_kernel_vs_plain_training(vit, ts, fused_adamw, datasets, cfg,
                                   device):
    """Phase 9: five train steps from one init on the same batches, kernels
    vs the plain path (unfused f32 attention + the AdamW twin)."""
    bundle = datasets.synthetic("cifar10", n_train=640, n_test=10, seed=3)
    data_x = torch.from_numpy(bundle.train_x).to(device)
    data_y = torch.from_numpy(bundle.train_y).to(device)
    idx = ts.epoch_indices(640, 128, True, seed=3).to(device)
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 32)
    init = vit.init_params(torch.Generator().manual_seed(4), cfg,
                           device=device)
    losses = {}
    for label, c, step in (
            ("kernels", cfg, fused_adamw.adamw_update),
            ("plain", dataclasses.replace(cfg, attention_impl="reference"),
             fused_adamw.adamw_plain)):
        params = {k: v.clone().requires_grad_() for k, v in init.items()}
        tinit, update = fused_adamw.make_fused_adamw(
            params, lambda s: 1e-3, weight_decay=0.01, step=step)
        state = tinit(params)
        train_step = ts.make_train_step(c, update, pre)
        out = []
        for row in range(5):
            params, state, m = train_step(params, state, row, data_x, data_y,
                                          idx)
            out.append(float(m[0]))
        losses[label] = out
    diffs = [abs(a - b) for a, b in zip(losses["kernels"], losses["plain"])]
    ok = max(diffs) <= TRAIN_LOSS_TOL
    log(f"  5 steps {cfg.pos_encoding}: kernels {losses['kernels']}")
    log(f"                      plain   {losses['plain']}")
    log(f"  max |diff| {max(diffs):.3e} (tol {TRAIN_LOSS_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path and plain path train apart")
    return losses


def attention_bwd_bound_ms(shape, dtype, bias, cos, want_drot):
    """Least time for the backward's work: q, k, v, g, out read once, dq,
    dk, dv written once (plus the bias and dbias, the rope tables, and
    dqr/dkr when present) over the memory rate, against five products of
    2*N*N*D per (batch, head) at the bf16 tensor-core peak."""
    b, h, n, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = 8 * b * h * n * d * elem
    if bias is not None:
        nbytes += 2 * bias.numel() * 4
    if cos is not None:
        nbytes += 2 * cos.numel() * 4
    if want_drot:
        nbytes += 2 * b * h * n * d * 4
    flops = 5 * 2 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_attention_bwd(fa, device):
    """Phase 10b: the backward kernel at the ViT-S training shape against
    its twin and against SDPA's backward on pre-rotated q/k (forward +
    backward minus forward)."""
    import torch.nn.functional as F

    rows = {}
    shape = (64, 6, 197, 64)
    scale = shape[-1] ** -0.5
    for label, regime in (("rope-mixed f32", "rope-mixed"),
                          ("rel-bias f32", "rel")):
        q, k, v, kw = attn_inputs(regime, shape, torch.float32, 8, device)
        bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
        out = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
        g = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        g = g.to(device)
        want_drot = regime == "rope-mixed"
        args = (q, k, v, out, g, scale, bias, cos, sin)
        kernel_ms = median_ms(lambda: fa.attention_bwd(
            *args, want_dbias=bias is not None, want_drot=want_drot))
        plain_ms = median_ms(lambda: fa.attention_bwd_plain(
            *args, want_dbias=bias is not None, want_drot=want_drot))
        qr, kr = q, k
        if cos is not None:
            qr = fa._rotate(q, cos[None], sin[None])
            kr = fa._rotate(k, cos[None], sin[None])
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (qr, kr, v))
        mask = None if bias is None else bias.detach()[None].clone()
        if mask is not None:
            mask.requires_grad_()

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                               scale=scale)

        def sdpa_fwd_bwd():
            o = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                               scale=scale)
            o.backward(g)

        library_ms = median_ms(sdpa_fwd_bwd) - median_ms(sdpa_fwd)
        bound_ms, bound_by = attention_bwd_bound_ms(shape, torch.float32,
                                                    bias, cos, want_drot)
        rows[label] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
        log(f"  attention bwd {label:15s} kernel {kernel_ms:.4f} ms  twin "
            f"{plain_ms:.4f} ms  sdpa bwd {library_ms:.4f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by})")
    return rows


def time_adamw(fused_adamw, vit, cfg, device):
    """Phase 10c: one AdamW step over the ViT-S params: the kernel, its
    twin, and torch.optim.AdamW(fused=True) as a yardstick."""
    gen = torch.Generator().manual_seed(22)
    params = vit.init_params(gen, cfg, device=device)
    grads = {k: torch.randn(v.shape, generator=gen).to(device)
             for k, v in params.items()}
    keys = list(params)
    lists = ([params[k] for k in keys], [grads[k] for k in keys],
             [torch.zeros_like(params[k]) for k in keys],
             [torch.zeros_like(params[k]) for k in keys])
    hyper = (1e-3, 0.1, 0.001, 0.9, 0.999, 1e-8, 0.01)
    kernel_ms = median_ms(lambda: fused_adamw.adamw_update(*lists, *hyper))
    plain_ms = median_ms(lambda: fused_adamw.adamw_plain(*lists, *hyper),
                         iters=5)
    torch_params = [torch.nn.Parameter(params[k].clone()) for k in keys]
    for p, k in zip(torch_params, keys):
        p.grad = grads[k]
    opt = torch.optim.AdamW(torch_params, lr=1e-3, weight_decay=0.01,
                            fused=True)
    library_ms = median_ms(opt.step)
    n = vit.num_params(params)
    bound_ms = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    log(f"  AdamW step, {n:,} params: kernel {kernel_ms:.4f} ms  twin "
        f"{plain_ms:.4f} ms  torch fused AdamW {library_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms (bytes)")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes", num_params=n)


def vit_s_train_step(vit, ts, tcfg, mean, std, cfg, device):
    """A ViT-S/16@224 train step at batch 64 (uint8 32x32 inputs upsampled
    on the device, as for serving): a closure that runs one step."""
    params = {k: v.requires_grad_() for k, v in vit.init_params(
        torch.Generator().manual_seed(5), cfg, device=device).items()}
    init, update = ts.make_optimizer(tcfg, 100, params)
    images = np.random.default_rng(5).integers(0, 256, (64, 32, 32, 3),
                                               dtype=np.uint8)
    data_x = torch.from_numpy(images).to(device)
    data_y = torch.from_numpy(np.arange(64, dtype=np.int32) % 10).to(device)
    step = ts.make_train_step(cfg, update, ts.make_preprocess(cfg, mean, std,
                                                              32))
    idx = torch.arange(64, device=device)[None]
    state = [params, init(params)]

    def run():
        state[0], state[1], m = step(state[0], state[1], 0, data_x, data_y,
                                     idx)
        return m

    return run


def time_train_step(run, fa, fused_adamw, n_steps=10):
    """Phase 10a: wall time and device time of ViT-S train steps, and the
    launches of one step."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    reset_counts(fa, fused_adamw)
    run()
    per_step = read_counts(fa, fused_adamw)
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_steps):
        run()
    end.record()
    end.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    device_ms = start.elapsed_time(end) / n_steps
    log(f"  ViT-S/16@224 rope-mixed f32 train step, batch 64: "
        f"{wall_ms:.2f} ms wall ({64e3 / wall_ms:.1f} img/s), "
        f"{device_ms:.2f} ms between device events; launches per step "
        f"{per_step}")
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                img_per_s=64e3 / wall_ms, launches_per_step=per_step)


def profile_train_step(run, n_iter=2):
    """Phase 10a': torch.profiler over n_iter train steps: device time by
    kernel name and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3 / n_iter)
    if not by_name:
        log("  profiler: no device time seen (not measured)")
        return {}
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"  profile: device busy {busy:.3f} ms per train step of "
        f"{wall_ms / n_iter:.3f} ms wall ({100 * busy * n_iter / wall_ms:.1f}%"
        f" busy, profiler on)")
    for name, ms in top:
        log(f"    {ms:8.3f} ms {100 * ms / busy:5.1f}%  {name[:90]}")
    return {"busy_ms": busy, "wall_ms": wall_ms / n_iter,
            "top": [[name, ms] for name, ms in top]}


def kernel_line(name, source, replaces, launches, max_abs_err, times):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"], "library_ms": times["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from vit_rpe_rope_tpu_torch import serving
    from vit_rpe_rope_tpu_torch.cli import predict, serve
    from vit_rpe_rope_tpu_torch.cli import train as train_cli
    from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
    from vit_rpe_rope_tpu_torch.data import datasets
    from vit_rpe_rope_tpu_torch.models import vit
    from vit_rpe_rope_tpu_torch.ops import cuda_build
    from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
    from vit_rpe_rope_tpu_torch.ops import fused_adamw, reference_attention
    from vit_rpe_rope_tpu_torch.train import train_step as ts
    from vit_rpe_rope_tpu_torch.utils import checkpoint
    from vit_rpe_rope_tpu_torch.utils.device import resolve_device

    device = resolve_device()
    card = card_line()
    seconds = {}
    with phase("[1] card, versions, kernel build", seconds):
        log(f"    card: {card}")
        log(f"    torch {torch.__version__} cuda {torch.version.cuda} "
            f"device {torch.cuda.get_device_name(0)}")
        sources = (fa.SOURCE, fa.BWD_SOURCE, fused_adamw.SOURCE)
        for lib_path in cuda_build.build_all(sources):
            log(f"    built {lib_path.name}")
            log_path = lib_path.with_suffix(".log")
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("    ptxas: " + line.strip())
        fa._library(), fa._bwd_library(), fused_adamw._library()

    with phase("[2] kernel vs plain twin on the card", seconds):
        max_abs_err = check_kernel_vs_twin(fa, device)

    vit_s = ViTConfig(**VIT_S, pos_encoding="rope-mixed")
    with phase("[3] serving ViT-S/16@224 rope-mixed through the predict CLI",
               seconds):
        modules = (fa, vit, checkpoint, predict)
        images = np.random.default_rng(0).integers(
            0, 256, (256, 32, 32, 3), dtype=np.uint8)
        with tempfile.TemporaryDirectory() as tmp:
            ckpt, preds, serve_launches, secs = serve_through_cli(
                tmp, vit_s, "vit_s16_rope-mixed.npz", images, 14, modules)
            log(f"  predict CLI: {len(preds)} images in {secs:.2f} s, kernel "
                f"launches {serve_launches} (expected {vit_s.depth} blocks x "
                f"4 batches)")
            if serve_launches != vit_s.depth * 4:
                raise AssertionError(f"expected {vit_s.depth * 4} launches, "
                                     f"got {serve_launches}")
            kernel, reference = compare_with_reference(serving, ckpt, 14,
                                                       images, preds)
            for pe_name in PE_NAMES:
                tiny = ViTConfig(pos_encoding=pe_name)  # ViT-tiny/4 CIFAR
                t_ckpt, t_preds, t_launches, _ = serve_through_cli(
                    tmp, tiny, f"vit_tiny4_{pe_name}.npz", images[:64], None,
                    modules)
                log(f"  ViT-tiny/4 {pe_name}: kernel launches {t_launches} "
                    f"(expected {tiny.depth})")
                if t_launches != tiny.depth:
                    raise AssertionError(f"{pe_name}: expected {tiny.depth} "
                                         f"launches, got {t_launches}")
                compare_with_reference(serving, t_ckpt, None, images[:64],
                                       t_preds)

    with phase("[4] HTTP server", seconds):
        check_http(serve, kernel, images)

    with phase("[5] serving times on the card", seconds):
        attn = time_attention(fa, device)
        serve_times = time_serving(kernel, reference, images)
        serve_trace = profile_forward(kernel, images)
    del kernel, reference

    with phase("[6] backward kernel vs twin, autograd vs the f32 oracle",
               seconds):
        bwd_err = check_bwd_vs_twin(fa, device)
        check_autograd_vs_oracle(fa, reference_attention, device)

    with phase("[7] AdamW kernel vs twin on the ViT-S/16 params", seconds):
        adamw_err = check_adamw(fused_adamw, vit, vit_s, device)

    with phase("[8] training at full width through the train CLI", seconds):
        train_modules = (fa, fused_adamw, train_cli, serving, datasets)
        training = {pe_name: train_through_cli(pe_name, train_modules)
                    for pe_name in ("rope-mixed", "relative")}

    with phase("[9] kernel path vs plain path, 5 train steps", seconds):
        tiny = ViTConfig(pos_encoding="rope-mixed")
        paths = check_kernel_vs_plain_training(vit, ts, fused_adamw,
                                               datasets, tiny, device)

    with phase("[10] training times on the card", seconds):
        mean, std = datasets.NORMALIZATION["cifar10"]
        run = vit_s_train_step(vit, ts, TrainConfig(dataset="cifar10"), mean,
                               std, vit_s, device)
        step_times = time_train_step(run, fa, fused_adamw)
        train_trace = profile_train_step(run)
        del run
        bwd = time_attention_bwd(fa, device)
        adamw = time_adamw(fused_adamw, vit, vit_s, device)

    summary = {"card": card, "attention": attn, "serving": serve_times,
               "serving_profile": serve_trace, "training": training,
               "kernel_vs_plain_losses": paths, "train_step": step_times,
               "train_profile": train_trace, "attention_bwd": bwd,
               "adamw": adamw, "phase_seconds": seconds}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)

    # Launches: the main path of this slice, the train CLI (rope-mixed).
    launches = training["rope-mixed"]["launches"]
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    log(f"card: {card}")
    log(json.dumps({"kernels": [
        kernel_line("attn_fwd", "vit_rpe_rope_tpu_torch/ops/csrc/attn_fwd.cu",
                    "vit_rpe_rope_tpu/ops/flash_attention.py:70",
                    launches["attn_fwd"], max_abs_err, attn["rope-mixed f32"]),
        kernel_line("attn_bwd", "vit_rpe_rope_tpu_torch/ops/csrc/attn_bwd.cu",
                    "vit_rpe_rope_tpu/ops/flash_attention.py:130",
                    launches["attn_bwd"], bwd_err, bwd["rope-mixed f32"]),
        kernel_line("adamw", "vit_rpe_rope_tpu_torch/ops/csrc/adamw.cu",
                    "vit_rpe_rope_tpu/ops/fused_adamw.py:51",
                    launches["adamw"], adamw_err, adamw),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
