#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vit_rpe_rope_tpu_torch).

  python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
exits nonzero without a card, or when any phase fails. Phases:

1. the card (nvidia-smi name and power limit), versions, the build of the
   kernels (attn_fwd.cu, attn_bwd.cu, attn_stream_fwd.cu,
   attn_stream_bwd.cu, adamw.cu; one nvcc each, in parallel);
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
   twins, their bounds and a PyTorch call as a yardstick;
11. the streaming kernels (forward with lse; dq, dk/dv, dbias) against
   their twins at the twins' own key tile, in six regimes (none,
   materialized bias, generated polynomial and relative bias, rope-axial,
   rope-mixed), f32 and bf16, at the long-sequence shape (B=4, H=4,
   N=4097, D=32) and the ViT-S/16@384 shape (B=8, H=6, N=577, D=64), and
   with a bias at that model's training batch (B=16: two batch groups and
   the dbias sum kernel); the forward and the rope-mixed backward at B=2,
   H=4, N=16385, D=32; limits as a share of each output's largest entry;
12. serving on the streaming route: the long-sequence model (patch 4,
   embed 128, depth 2, 4 heads, 256 px, batch 4) through the predict CLI
   and the Predictor in all six PE modes, logits against the unfused f32
   reference, exact launch counts; ViT-S/16@384 rope-mixed through the
   Predictor at batch 64;
13. training on the streaming route, five steps each, kernel path against
   plain path on the same batches with exact launch counts: the
   long-sequence model in rope-mixed at N=4097, ViT-S/16@384 in relative
   (materialized bias, dbias kernel); an eval step in polynomial at N=4097
   (generated bias), whose train step must raise; then both models through
   the train CLI for one epoch of synthetic CIFAR-10 (ViT-S/16@384 at
   depth 3), counting every kernel's launches, the best checkpoint served
   by the Predictor;
14. times: each streaming kernel (the backward kernels by the profiler's
   device time), its twin, its bound and SDPA as the yardstick (its
   backward once, against the whole backward wrapper) at the two shapes, at N=2048 with a bias (the dbias kernel's
   largest case) and at N=16385; train steps of the
   long-sequence model at N=4097 and N=16385 and of ViT-S/16@384; a
   profiler breakdown of the N=4097 step.

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
VIT_S_384 = dict(VIT_S, img_size=384)  # N=577: the dense tiles do not fit
# The JAX package's long-sequence model (scripts/bench_longseq.py): N=4097
# at 256 px (batch 4), N=16385 at 512 px (batch 2).
LONGSEQ = dict(img_size=256, patch_size=4, embed_dim=128, depth=2, num_heads=4)
# "bias": a materialized [H, N, N] tensor; "poly" / "rel": generated in the
# kernel from the coefficients / the table.
STREAM_REGIMES = ("none", "bias", "poly", "rel", "rope-axial", "rope-mixed")
# Streaming forward lse, kernel vs twin at the same key tile, absolute:
# float32 sums and exp/log in another order. One key of 4097 dropped from a
# row moves its lse by 2.4e-4, one of 16385 by 6e-5.
LSE_TOL = 2e-5
# Streaming kernels vs twins at the same key tile, as a share of the
# output's largest entry (at N=4097 an entry of out is a mean over
# thousands of keys, near 0.03, so an absolute limit would say nothing).
# Same rounding points; float32 sums in another order flip a bf16 rounding
# of p or ds here and there, and bf16 outputs add one ulp (2^-8) of the
# entry. Backward: p = exp(s - lse) is not renormalized, so a last-ulp
# difference in lse moves every p of the row. Largest shares seen on an
# H100, f32 / bf16 inputs: forward 4.6e-4 / 4.4e-3, backward 1.7e-3 / 3.0e-3;
# lse 1.9e-6.
STREAM_TOL = {torch.float32: 1e-3, torch.bfloat16: 8e-3}
STREAM_BWD_TOL = {torch.float32: 4e-3, torch.bfloat16: 1.6e-2}


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


def serve_through_cli(tmp, cfg, name, images, grid_size, modules,
                      batch_size=64, num_heads=6):
    """Write a seeded checkpoint, classify `images` through the predict CLI
    with the forward kernels' launch counts reset just before and read just
    after. Returns (ckpt, predictions, {kernel: launches}, seconds)."""
    fa, vit, checkpoint, predict = modules
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ckpt = checkpoint.save(os.path.join(tmp, name), params, vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    inputs = os.path.join(tmp, name + ".input.npz")
    labels = np.random.default_rng(1).integers(0, 10, len(images))
    np.savez(inputs, images=images, labels=labels)
    argv = [ckpt, "--input", inputs, "--batch_size", str(batch_size),
            "--num_heads", str(num_heads)]
    if grid_size is not None:
        argv += ["--grid_size", str(grid_size)]
    torch.cuda.synchronize()
    fa.LAUNCHES = fa.LAUNCHES_STREAM_FWD = 0
    t0 = time.perf_counter()
    preds = predict.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"attn_fwd": fa.LAUNCHES,
              "attn_stream_fwd": fa.LAUNCHES_STREAM_FWD}
    return ckpt, preds, counts, seconds


def compare_with_reference(serving, ckpt, grid_size, images, preds, bs=64,
                           num_heads=6):
    """Kernel-path logits: finite, equal to the CLI's predictions, and
    within LOGITS_TOL of the unfused reference path on the card."""
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        ckpt, grid_size=grid_size, num_heads=num_heads)
    kernel = serving.Predictor.from_params(params, cfg, mean, std, native)
    reference = serving.Predictor.from_params(
        params, dataclasses.replace(cfg, attention_impl="reference"), mean,
        std, native)
    got = batched_logits(kernel, images, bs)
    want = batched_logits(reference, images, bs)
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


def share_err(got, want, tol):
    """max |got - want|, whether it is within tol times the largest |want|
    (no absolute floor), and that share."""
    err = float((got.float() - want.float()).abs().max())
    share = err / float(want.float().abs().max())
    return err, share <= tol and bool(torch.isfinite(got).all()), share


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
    fa.LAUNCHES_STREAM_FWD = fa.LAUNCHES_STREAM_DQ = 0
    fa.LAUNCHES_STREAM_DKV = fa.LAUNCHES_STREAM_DBIAS = 0


def read_counts(fa, fused_adamw):
    """Launches since reset_counts; the streaming kernels only where one
    was launched (the dense paths' expectations name the dense kernels)."""
    torch.cuda.synchronize()
    counts = {"attn_fwd": fa.LAUNCHES, "attn_bwd": fa.LAUNCHES_BWD,
              "adamw": fused_adamw.LAUNCHES_ADAMW}
    stream = {"attn_stream_fwd": fa.LAUNCHES_STREAM_FWD,
              "attn_stream_bwd_dq": fa.LAUNCHES_STREAM_DQ,
              "attn_stream_bwd_dkv": fa.LAUNCHES_STREAM_DKV,
              "attn_stream_bwd_dbias": fa.LAUNCHES_STREAM_DBIAS}
    counts.update({k: v for k, v in stream.items() if v})
    return counts


def train_through_cli(pe_name, modules, model=None, batch=128):
    """Phases 8 and 13 for one PE mode: the train CLI on synthetic CIFAR-10
    for one epoch (run in a scratch directory, so the default logs/ and
    checkpoints/ land there), with every count reset just before and read
    just after; then the best checkpoint through the Predictor. `model` is
    None for the CLI's defaults (ViT-tiny/4, dense kernels, held to
    LEARN_BAR) or the ViTConfig fields of a model on the streaming route."""
    fa, fused_adamw, train_cli, serving, datasets = modules
    argv = ["--dataset", "cifar10", "--synthetic", "--epochs", "1",
            "--pos_encoding", pe_name, "--batch_size", str(batch)]
    for key, value in (model or {}).items():
        argv += [f"--{key}", str(value)]
    depth = model["depth"] if model else 6
    grid = model["img_size"] // model["patch_size"] if model else None
    heads = model["num_heads"] if model else 6
    serve_bs = 128 if model is None else 64
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts(fa, fused_adamw)
            t0 = time.perf_counter()
            summary = train_cli.main(argv)
            counts = read_counts(fa, fused_adamw)
            seconds = time.perf_counter() - t0
            with open(summary["log_file"]) as f:
                rows = [line.strip().split(",") for line in f]
            ckpt = os.path.abspath(summary["ckpt_path"])
            params, cfg, mean, std, native, _ = serving.load_serving_state(
                ckpt, grid_size=grid, num_heads=heads)
            predictor = serving.Predictor.from_params(params, cfg, mean, std,
                                                      native)
            test = datasets.synthetic("cifar10", seed=0)
            reset_counts(fa, fused_adamw)
            preds = np.concatenate(
                [predictor.predict(test.test_x[s:s + serve_bs])
                 for s in range(0, len(test.test_y), serve_bs)])
            serve_counts = read_counts(fa, fused_adamw)
        finally:
            os.chdir(cwd)
    header = ["epoch", "train_loss", "train_acc", "test_loss", "test_acc",
              "best_acc"]
    row = dict(zip(header, rows[1])) if len(rows) > 1 else {}
    served_acc = 100.0 * float((preds == test.test_y).mean())
    steps, evals = 12800 // batch, 2560 // batch
    fwd = "attn_fwd" if model is None else "attn_stream_fwd"
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": steps,
                fwd: depth * (steps + evals)}
    if model is None:
        expected["attn_bwd"] = depth * steps
    else:
        expected["attn_stream_bwd_dq"] = depth * steps
        expected["attn_stream_bwd_dkv"] = depth * steps
        if pe_name in ("relative", "polynomial"):
            expected["attn_stream_bwd_dbias"] = depth * steps
    serve_expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 0,
                      fwd: depth * (2560 // serve_bs)}
    log(f"  train CLI {pe_name} {model or 'defaults'}: {seconds:.1f} s, CSV "
        f"{rows[0]} + {len(rows) - 1} row(s): {row}")
    log(f"    launches {counts} (expected {expected}); the Predictor on the "
        f"best checkpoint: {len(preds)} test images, accuracy "
        f"{served_acc:.4f}%, launches {serve_counts} (expected "
        f"{serve_expected})")
    if rows[0] != header or len(rows) != 2:
        raise AssertionError(f"bad CSV: {rows}")
    if not all(math.isfinite(float(row[key])) for key in header):
        raise AssertionError(f"{pe_name}: the CSV row is not finite: {row}")
    test_acc = float(row["test_acc"])
    for key, bar in (LEARN_BAR[pe_name] if model is None else {}).items():
        value = float(row[key])
        if not (value > bar if key == "test_acc" else value < bar):
            raise AssertionError(f"{pe_name} did not learn: {key} {value} "
                                 f"(bar {bar})")
    if abs(served_acc - test_acc) > 1e-9:
        raise AssertionError(f"served accuracy {served_acc} != CSV test_acc "
                             f"{test_acc}")
    if counts != expected or serve_counts != serve_expected:
        raise AssertionError(f"launch counts {counts}/{serve_counts} differ "
                             f"from {expected}/{serve_expected}")
    return dict(seconds=seconds, csv=row, launches=counts,
                served_acc=served_acc,
                images_per_s=summary["history"][0]["images_per_sec"])


def check_kernel_vs_plain_training(vit, ts, fused_adamw, datasets, cfg,
                                   device, batch=128, fa=None, expected=None):
    """Phases 9 and 13: five train steps from one init on the same batches
    (32 px synthetic CIFAR-10, upsampled on the device), kernels vs the
    plain path (unfused f32 attention + the AdamW twin). With `expected`,
    the kernel path's launch counts must equal it exactly."""
    bundle = datasets.synthetic("cifar10", n_train=5 * batch, n_test=10,
                                seed=3)
    data_x = torch.from_numpy(bundle.train_x).to(device)
    data_y = torch.from_numpy(bundle.train_y).to(device)
    idx = ts.epoch_indices(5 * batch, batch, True, seed=3).to(device)
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
        if fa is not None:
            reset_counts(fa, fused_adamw)
        for row in range(5):
            params, state, m = train_step(params, state, row, data_x, data_y,
                                          idx)
            out.append(float(m[0]))
        losses[label] = out
        if label == "kernels" and expected is not None:
            losses["launches"] = read_counts(fa, fused_adamw)
            log(f"  launches {losses['launches']} (expected {expected})")
            if losses["launches"] != expected:
                raise AssertionError("launch counts differ from the expected")
        del params, state, train_step
    diffs = [abs(a - b) for a, b in zip(losses["kernels"], losses["plain"])]
    ok = max(diffs) <= TRAIN_LOSS_TOL
    if not all(math.isfinite(x) for x in losses["kernels"]):
        raise AssertionError("kernel path lost its loss")
    log(f"  5 steps {cfg.pos_encoding} N={cfg.seq_len} batch {batch}: kernels "
        f"{losses['kernels']}")
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


def vit_s_train_step(vit, ts, tcfg, mean, std, cfg, device, batch=64):
    """A train step of `cfg` at `batch` (default: ViT-S/16@224 at 64; uint8
    32x32 inputs upsampled on the device, as for serving): a closure that
    runs one step."""
    params = {k: v.requires_grad_() for k, v in vit.init_params(
        torch.Generator().manual_seed(5), cfg, device=device).items()}
    init, update = ts.make_optimizer(tcfg, 100, params)
    images = np.random.default_rng(5).integers(0, 256, (batch, 32, 32, 3),
                                               dtype=np.uint8)
    data_x = torch.from_numpy(images).to(device)
    data_y = torch.from_numpy(np.arange(batch, dtype=np.int32) % 10).to(device)
    step = ts.make_train_step(cfg, update, ts.make_preprocess(cfg, mean, std,
                                                              32))
    idx = torch.arange(batch, device=device)[None]
    state = [params, init(params)]

    def run():
        state[0], state[1], m = step(state[0], state[1], 0, data_x, data_y,
                                     idx)
        return m

    return run


def time_train_step(run, fa, fused_adamw, n_steps=10, batch=64,
                    label="ViT-S/16@224 rope-mixed f32"):
    """Phases 10a and 14: wall time and device time of train steps, and the
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
    log(f"  {label} train step, batch {batch}: "
        f"{wall_ms:.2f} ms wall ({batch * 1e3 / wall_ms:.1f} img/s), "
        f"{device_ms:.2f} ms between device events; launches per step "
        f"{per_step}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, batch=batch,
                img_per_s=batch * 1e3 / wall_ms, launches_per_step=per_step)


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


def stream_inputs(fa, regime, shape, dtype, seed, device):
    """q, k, v and the streaming wrappers' PE keyword arguments (bias /
    poly / rel, cos / sin) for one regime of STREAM_REGIMES; the raw
    (cos, sin) of the rope regimes as the last item."""
    q, k, v, kw = attn_inputs("rel" if regime == "bias" else regime, shape,
                              dtype, seed, device)
    h, n = shape[1], shape[2]
    freqs = kw.pop("freqs_cis", None)
    _, cos, sin = fa.prepare_pe(h, n, device, freqs_cis=freqs)
    if regime == "bias":
        kw = {"bias": fa._dense_bias(h, n, device, rel=kw["rel"])}
    if regime == "poly":
        # Coefficients scaled by grid^-k: unscaled, the degree-3 term reaches
        # 1e5 at grid 64, where one float32 ulp of a logit is 8e-3.
        coeff, grid = kw["poly"]
        powers = torch.arange(coeff.shape[1], device=device).float()
        kw["poly"] = (coeff * float(grid) ** -powers, grid)
    return q, k, v, dict(kw, cos=cos, sin=sin), freqs


def stream_case(fa, regime, shape, dtype, seed, device, backward=True):
    """The streaming kernels and their twins (at the kernels' key tile) on
    one case: forward (out, lse), then dq, dk, dv (+ dbias, dcos/dsin) from
    the kernel's own out and lse. Returns {output: (max_abs_err, ok)}."""
    q, k, v, kw, freqs = stream_inputs(fa, regime, shape, dtype, seed, device)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    torch.cuda.synchronize()
    want_out, want_lse = fa.attention_stream_plain(
        q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw)
    lse_err = float((lse - want_lse).abs().max())
    res = {"out": share_err(out, want_out, STREAM_TOL[dtype]),
           "lse": (lse_err, lse_err <= LSE_TOL, lse_err)}
    if not backward:
        return res
    del want_out, want_lse
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to(device, dtype)
    want_dbias = kw.get("bias") is not None
    want_drot = regime == "rope-mixed"
    got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                  want_dbias=want_dbias, want_drot=want_drot,
                                  **kw)
    torch.cuda.synchronize()
    want = fa.attention_stream_bwd_plain(
        q, k, v, out, g, lse, scale, kv_tile=fa.STREAM_TILE,
        want_dbias=want_dbias, want_drot=want_drot, **kw)
    tol = STREAM_BWD_TOL[dtype]
    for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3]):
        res[name] = share_err(x, y, tol)
    if want_dbias:
        res["dbias"] = share_err(got[3], want[3], tol)
    if want_drot:
        for name, x, y in zip(
                ("dcos", "dsin"),
                fa._rot_grads_to_dfreqs(q, k, got[4], got[5], freqs),
                fa._rot_grads_to_dfreqs(q, k, want[4], want[5], freqs)):
            res[name] = share_err(x, y, tol)
    return res


def check_stream_vs_twin(fa, device):
    """Phase 11: every case is run and logged, then any failure raises.
    Returns the worst f32 errors by kernel: {"fwd", "dq", "dkv"} over all
    cases, {"dbias"} at the training path's shape (B=16: two batch groups
    and the sum kernel)."""
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "dbias": 0.0}
    vit_s_384_train = (16, 6, 577, 64)
    cases = [(shape, dtype, regime, True)
             for shape in ((4, 4, 4097, 32), (8, 6, 577, 64))
             for dtype in (torch.float32, torch.bfloat16)
             for regime in STREAM_REGIMES]
    cases += [(vit_s_384_train, dtype, "bias", True)
              for dtype in (torch.float32, torch.bfloat16)]
    # N=16385: no materialized bias (4.3 GB) and no [N, N] twin tensors.
    cases += [((2, 4, 16385, 32), torch.float32, regime, regime == "rope-mixed")
              for regime in ("none", "poly", "rel", "rope-mixed")]
    failed = []
    for i, (shape, dtype, regime, backward) in enumerate(cases):
        res = stream_case(fa, regime, shape, dtype, 400 + i, device, backward)
        ok = all(r[1] for r in res.values())
        log(f"stream vs twin  B={shape[0]} N={shape[2]} D={shape[3]} "
            f"{str(dtype)[6:]:8s} {regime:10s} "
            + " ".join(f"{k}={v[0]:.2e}({v[2]:.1e})" for k, v in res.items())
            + f" tol(share of largest)={STREAM_TOL[dtype]:g}/"
            f"{STREAM_BWD_TOL[dtype]:g} lse {LSE_TOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((regime, shape, dtype))
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], res["out"][0])
            if "dq" in res:
                worst["dq"] = max(worst["dq"], res["dq"][0])
                worst["dkv"] = max(worst["dkv"], res["dk"][0], res["dv"][0])
            if shape == vit_s_384_train:
                worst["dbias"] = res["dbias"][0]
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"streaming kernels disagree with their twins: "
                             f"{failed}")
    return worst


def serve_longseq(tmp, pe_name, modules, serving):
    """Phase 12 for one PE mode: the long-sequence model through the predict
    CLI on 8 generated 256 px images at batch 4, then the Predictor against
    the unfused f32 reference. Returns the CLI run's launch counts."""
    from vit_rpe_rope_tpu_torch.configs import ViTConfig

    cfg = ViTConfig(**LONGSEQ, pos_encoding=pe_name)
    size = cfg.img_size
    images = np.random.default_rng(12).integers(
        0, 256, (8, size, size, 3), dtype=np.uint8)
    ckpt, preds, counts, secs = serve_through_cli(
        tmp, cfg, f"longseq_{pe_name}.npz", images, size // cfg.patch_size,
        modules, batch_size=4, num_heads=cfg.num_heads)
    expected = {"attn_fwd": 0, "attn_stream_fwd": cfg.depth * 2}
    log(f"  long-sequence {pe_name} N={cfg.seq_len}: predict CLI {secs:.2f} s,"
        f" launches {counts} (expected {expected})")
    if counts != expected:
        raise AssertionError(f"{pe_name}: launch counts differ")
    compare_with_reference(serving, ckpt, size // cfg.patch_size, images,
                           preds, bs=4, num_heads=cfg.num_heads)
    os.remove(ckpt)
    torch.cuda.empty_cache()
    return counts


def serve_vit_s_384(fa, vit, serving, datasets, device):
    """Phase 12b: ViT-S/16@384 rope-mixed through the Predictor at batch 64
    on generated 384 px images, against the unfused reference."""
    from vit_rpe_rope_tpu_torch.configs import ViTConfig

    cfg = ViTConfig(**VIT_S_384, pos_encoding="rope-mixed")
    params = vit.init_params(torch.Generator().manual_seed(6), cfg,
                             device="cpu")
    mean, std = datasets.NORMALIZATION["cifar10"]
    images = np.random.default_rng(13).integers(
        0, 256, (64, 384, 384, 3), dtype=np.uint8)
    kernel = serving.Predictor.from_params(params, cfg, mean, std, 32)
    reference = serving.Predictor.from_params(
        params, dataclasses.replace(cfg, attention_impl="reference"), mean,
        std, 32)
    fa.LAUNCHES = fa.LAUNCHES_STREAM_FWD = 0
    got = kernel.logits(images)
    counts = (fa.LAUNCHES, fa.LAUNCHES_STREAM_FWD)
    want = reference.logits(images)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log(f"  ViT-S/16@384 rope-mixed batch 64: launches (dense, streaming) "
        f"{counts} (expected (0, {cfg.depth})), logits vs reference "
        f"max_abs_err={err:.3e} (|logits| <= {scale:.3f}, tol {LOGITS_TOL:g})")
    if counts != (0, cfg.depth) or not np.isfinite(got).all():
        raise AssertionError("ViT-S/16@384 did not take the streaming kernel")
    if err > LOGITS_TOL * max(1.0, scale):
        raise AssertionError("kernel path disagrees with the reference path")
    times = {}
    for label, pred in (("kernel", kernel), ("reference", reference)):
        u8 = torch.from_numpy(images).to(device)
        model_params = pred.model.params()
        with torch.inference_mode():
            ms = median_ms(lambda: pred._infer(model_params, u8), iters=3,
                           reps=3, warmup=1)
        times[label] = dict(forward_ms=ms, img_per_s=64e3 / ms)
        log(f"  serving ViT-S/16@384 bs64 ({label} attention): device "
            f"forward {ms:.3f} ms/batch ({64e3 / ms:.1f} img/s)")
    return times


def check_generated_bias_training_raises(vit, ts, datasets, device):
    """Phase 13c: polynomial at N=4097 generates its bias in the kernel: the
    eval step runs, the train step raises and names the missing kernel."""
    from vit_rpe_rope_tpu_torch.configs import ViTConfig

    cfg = ViTConfig(**LONGSEQ, pos_encoding="polynomial")
    params = {k: v.requires_grad_() for k, v in vit.init_params(
        torch.Generator().manual_seed(7), cfg, device=device).items()}
    mean, std = datasets.NORMALIZATION["cifar10"]
    pre = ts.make_preprocess(cfg, mean, std, 32)
    images = np.random.default_rng(7).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    data = (torch.from_numpy(images).to(device),
            torch.arange(4, dtype=torch.int32, device=device),
            torch.arange(4, device=device)[None])
    metrics = ts.make_eval_step(cfg, pre)(params, 0, *data)
    if not bool(torch.isfinite(metrics).all()):
        raise AssertionError("polynomial eval step at N=4097 is not finite")
    try:
        ts.make_train_step(cfg, None, pre)(params, None, 0, *data)
    except NotImplementedError as e:
        if "_stream_bwd_fused_kernel" not in str(e):
            raise
        log(f"  polynomial N={cfg.seq_len}: eval loss {float(metrics[0]):.4f};"
            f" the train step raises NotImplementedError naming "
            f"_stream_bwd_fused_kernel")
        return
    raise AssertionError("training a generated polynomial bias did not raise")


def stream_bound_ms(kernel, shape, dtype, kw, want_drot):
    """Least time for one streaming kernel's work: its inputs read once and
    its outputs written once over the memory rate, against its products of
    2*N*N*D per (batch, head) at the bf16 tensor-core peak (fwd 2 products,
    dq 3, dk/dv 4, dbias 2)."""
    b, h, n, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    tensors, stats, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3),
                                "dkv": (6, 2, 4), "dbias": (4, 2, 2)}[kernel]
    nbytes = tensors * b * h * n * d * elem + stats * b * h * n * 4
    if kw.get("bias") is not None:
        nbytes += kw["bias"].numel() * 4 * (2 if kernel == "dbias" else 1)
    if kw.get("cos") is not None:
        nbytes += 2 * kw["cos"].numel() * 4
    if want_drot and kernel in ("dq", "dkv"):
        nbytes += b * h * n * d * 4
    flops = products * 2 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_ms_by_kernel(fn, iters, names):
    """torch.profiler over `iters` calls of fn: for each of `names`, the
    device time in ms of one launch of every kernel whose name contains it
    (the mean over the launches the profiler recorded, summed over those
    kernels). Also returns the least number of launches recorded."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            spans.setdefault(ev.name, []).append(
                ev.time_range.elapsed_us() / 1e3)
    ms = {name: sum(statistics.mean(v) for k, v in spans.items() if name in k)
          for name in names}
    missing = [name for name, t in ms.items() if t <= 0.0]
    if missing:
        raise AssertionError(f"the profiler saw no device time of {missing}")
    recorded = min(len(v) for k, v in spans.items()
                   if any(name in k for name in names))
    return ms, recorded


def time_stream_kernels(fa, device):
    """Phase 14a: the forward kernel by CUDA events around its wrapper; the
    dq, dk/dv and dbias kernels (the dbias time includes its sum over batch
    groups) by the profiler's device time over calls of the one backward
    wrapper, which is also timed whole (delta and launches included). Each
    beside its twin (the whole forward / the whole backward: the twin is not
    split by kernel) and its bound. The yardstick is SDPA on pre-rotated
    q/k: its forward for the forward kernel; its backward (forward +
    backward minus forward; dq, dk and dv in one call, and the mask's
    gradient with a bias) computes what the backward kernels compute
    together, so it stands once, against the whole backward wrapper
    (`group_ms` / `group_library_ms`), and no backward kernel has a library
    call of its own."""
    import torch.nn.functional as F

    rows = {}
    for label, regime, shape, iters in (
            ("longseq N=4097 rope-mixed f32", "rope-mixed", (4, 4, 4097, 32), 5),
            ("vit-s/16@384 rel-bias f32", "bias", (16, 6, 577, 64), 10),
            # the longest sequence that still trains a materialized bias
            ("N=2048 rel-bias f32", "bias", (8, 6, 2048, 64), 3),
            ("longseq N=16385 rope-mixed f32", "rope-mixed", (2, 4, 16385, 32),
             2)):
        q, k, v, kw, _ = stream_inputs(fa, regime, shape, torch.float32, 9,
                                       device)
        scale = shape[-1] ** -0.5
        timing = dict(iters=iters, reps=5, warmup=2)
        out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
        g = torch.randn(shape, generator=torch.Generator().manual_seed(2))
        g = g.to(device)
        want_dbias = kw.get("bias") is not None
        want_drot = regime == "rope-mixed"
        bwd = dict(want_dbias=want_dbias, want_drot=want_drot, **kw)

        def backward():
            fa.attention_stream_bwd(q, k, v, out, g, lse, scale, **bwd)

        ms = {"fwd": median_ms(lambda: fa.attention_stream_fwd(
            q, k, v, scale, **kw), **timing)}
        names = {"dq": "attn_stream_bwd_dq_kernel",
                 "dkv": "attn_stream_bwd_dkv_kernel"}
        if want_dbias:
            names["dbias"] = "attn_stream_bwd_dbias"
        by_name, recorded = device_ms_by_kernel(backward, 3 * iters,
                                                tuple(names.values()))
        ms.update({kernel: by_name[name] for kernel, name in names.items()})
        bwd_ms = median_ms(backward, **timing)
        plain = {"fwd": median_ms(lambda: fa.attention_stream_plain(
            q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw), iters=2, reps=3,
            warmup=1)}
        plain["bwd"] = median_ms(lambda: fa.attention_stream_bwd_plain(
            q, k, v, out, g, lse, scale, kv_tile=fa.STREAM_TILE, **bwd),
            iters=2, reps=3, warmup=1)
        qr, kr = q, k
        if kw["cos"] is not None:
            qr = fa._rotate(q, kw["cos"][None], kw["sin"][None])
            kr = fa._rotate(k, kw["cos"][None], kw["sin"][None])
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (qr, kr, v))
        mask = None
        if want_dbias:
            mask = kw["bias"].detach()[None].clone().requires_grad_()

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                               scale=scale)

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                           scale=scale).backward(g)

        lib_fwd = median_ms(sdpa_fwd, **timing)
        lib_bwd = median_ms(sdpa_fwd_bwd, **timing) - lib_fwd
        rows[label] = {}
        for kernel, t in ms.items():
            bound_ms, bound_by = stream_bound_ms(kernel, shape, torch.float32,
                                                 kw, want_drot)
            row = dict(ms=t, plain_ms=plain["fwd"], library_ms=lib_fwd,
                       bound_ms=bound_ms, bound_by=bound_by)
            if kernel != "fwd":
                row.update(plain_ms=plain["bwd"], library_ms=None,
                           group="attention_stream_bwd", group_ms=bwd_ms,
                           group_library_ms=lib_bwd)
            rows[label][kernel] = row
            log(f"  {label} {kernel:5s} kernel {t:.4f} ms  twin "
                f"{row['plain_ms']:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})"
                + (f"  sdpa {lib_fwd:.4f} ms" if kernel == "fwd" else ""))
        log(f"  {label} whole backward wrapper {bwd_ms:.4f} ms  sdpa backward "
            f"{lib_bwd:.4f} ms (profiler: {recorded} of {3 * iters} launches "
            f"of each backward kernel recorded)")
        del q, k, v, out, lse, g, qr, kr, vr, mask, kw, bwd
        torch.cuda.empty_cache()
    return rows


def kernel_line(name, source, replaces, launches, max_abs_err, times):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"], "library_ms": times["library_ms"],
            **{key: times[key] for key in ("group", "group_ms",
                                           "group_library_ms")
               if key in times}}


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
        sources = (fa.SOURCE, fa.BWD_SOURCE, fa.STREAM_SOURCE,
                   fa.STREAM_BWD_SOURCE, fused_adamw.SOURCE)
        for lib_path in cuda_build.build_all(sources):
            log(f"    built {lib_path.name}")
            log_path = lib_path.with_suffix(".log")
            for line in log_path.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("    ptxas: " + line.strip())
        fa._library(), fa._bwd_library(), fused_adamw._library()
        fa._stream_library(), fa._stream_bwd_library()

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
                f"4 batches of attn_fwd)")
            if serve_launches != {"attn_fwd": vit_s.depth * 4,
                                  "attn_stream_fwd": 0}:
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
                if t_launches != {"attn_fwd": tiny.depth,
                                  "attn_stream_fwd": 0}:
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

    with phase("[11] streaming kernels vs twins on the card", seconds):
        stream_err = check_stream_vs_twin(fa, device)

    with phase("[12] serving on the streaming route", seconds):
        with tempfile.TemporaryDirectory() as tmp:
            for pe_name in PE_NAMES:
                serve_longseq(tmp, pe_name, (fa, vit, checkpoint, predict),
                              serving)
        serve_384 = serve_vit_s_384(fa, vit, serving, datasets, device)

    longseq = ViTConfig(**LONGSEQ, pos_encoding="rope-mixed")
    vit_s_384_rel = ViTConfig(**VIT_S_384, pos_encoding="relative")
    with phase("[13] training on the streaming route, kernel path vs plain "
               "path", seconds):
        stream_paths = {}
        for label, cfg, batch, dbias in (("longseq", longseq, 4, 0),
                                         ("vit_s_384", vit_s_384_rel, 16, 1)):
            expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 5,
                        "attn_stream_fwd": 5 * cfg.depth,
                        "attn_stream_bwd_dq": 5 * cfg.depth,
                        "attn_stream_bwd_dkv": 5 * cfg.depth}
            if dbias:
                expected["attn_stream_bwd_dbias"] = 5 * cfg.depth
            stream_paths[label] = check_kernel_vs_plain_training(
                vit, ts, fused_adamw, datasets, cfg, device, batch=batch,
                fa=fa, expected=expected)
            torch.cuda.empty_cache()
        check_generated_bias_training_raises(vit, ts, datasets, device)
        # The same route through the train CLI (fit, eval, CSV, best
        # checkpoint, the Predictor on it): the long-sequence model as it
        # is, ViT-S/16@384 with its depth cut from 12 to 3.
        stream_training = {
            "longseq": train_through_cli(
                "rope-mixed", train_modules, model=LONGSEQ, batch=4),
            "vit_s_384": train_through_cli(
                "relative", train_modules, model=dict(VIT_S_384, depth=3),
                batch=16)}

    with phase("[14] streaming times on the card", seconds):
        stream_times = time_stream_kernels(fa, device)
        stream_steps = {}
        for label, cfg, batch, n_steps in (
                ("longseq N=4097 rope-mixed f32", longseq, 4, 10),
                ("longseq N=16385 rope-mixed f32",
                 dataclasses.replace(longseq, img_size=512), 2, 3),
                ("ViT-S/16@384 relative f32", vit_s_384_rel, 16, 5)):
            run = vit_s_train_step(vit, ts, TrainConfig(dataset="cifar10"),
                                   mean, std, cfg, device, batch=batch)
            stream_steps[label] = time_train_step(
                run, fa, fused_adamw, n_steps=n_steps, batch=batch,
                label=label)
            if cfg is longseq:
                stream_trace = profile_train_step(run)
            del run
            torch.cuda.empty_cache()

    summary = {"card": card, "attention": attn, "serving": serve_times,
               "serving_profile": serve_trace, "training": training,
               "kernel_vs_plain_losses": paths, "train_step": step_times,
               "train_profile": train_trace, "attention_bwd": bwd,
               "adamw": adamw, "stream_kernels": stream_times,
               "stream_max_abs_err": stream_err, "serving_vit_s_384": serve_384,
               "stream_kernel_vs_plain_losses": stream_paths,
               "stream_training": stream_training,
               "stream_train_steps": stream_steps,
               "stream_train_profile": stream_trace,
               "phase_seconds": seconds}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)

    # Launches: each slice's main path, through the train CLI for one epoch.
    # ViT-tiny/4 (rope-mixed) for the dense kernels and AdamW; the
    # long-sequence model (rope-mixed, N=4097, batch 4) for the streaming
    # forward, dq and dk/dv kernels; ViT-S/16@384 (relative, batch 16, depth
    # 3) for the dbias kernel, whose error and time are taken at that batch.
    launches = training["rope-mixed"]["launches"]
    stream_launches = stream_training["longseq"]["launches"]
    dbias_launches = stream_training["vit_s_384"]["launches"][
        "attn_stream_bwd_dbias"]
    csrc = "vit_rpe_rope_tpu_torch/ops/csrc/"
    jax_fa = "vit_rpe_rope_tpu/ops/flash_attention.py"
    t_long = stream_times["longseq N=4097 rope-mixed f32"]
    t_384 = stream_times["vit-s/16@384 rel-bias f32"]
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
        kernel_line("attn_stream_fwd", csrc + "attn_stream_fwd.cu",
                    jax_fa + ":873", stream_launches["attn_stream_fwd"],
                    stream_err["fwd"], t_long["fwd"]),
        kernel_line("attn_stream_bwd_dq", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1275", stream_launches["attn_stream_bwd_dq"],
                    stream_err["dq"], t_long["dq"]),
        kernel_line("attn_stream_bwd_dkv", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1353", stream_launches["attn_stream_bwd_dkv"],
                    stream_err["dkv"], t_long["dkv"]),
        kernel_line("attn_stream_bwd_dbias", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1437", dbias_launches, stream_err["dbias"],
                    t_384["dbias"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
