"""Digests of the port's attention kernels' outputs on seeded inputs, to show
that two trees of the port compute the same bits where they should.

Runs on a CUDA device a fixed set of kernel calls at built head dims and
polynomial degrees up to 7 (the dense forward and backward, also at
ViT-S/16@224's (64, 6, 197, 64) and ViT-tiny/4's (128, 6, 65, 32) with
rope-mixed and with a relative bias, the streaming
forward, the separate-pass backward with the dcoeff / dtable kernels and,
at ViT-S/16@384's training shape (16, 6, 577, 64) and at (8, 6, 2048, 64),
with a materialized bias and dbias, and at (4, 4, 4097, 32) with
rope-mixed's per-head tables and dqr / dkr, the one-pass backward (also on
key chunks at the shapes of the --q_chunk 2048 epoch, 2,048 rows against
4,608 keys, and of the bounded train step, 16,384 rows against 66,048
keys), the chunk forward at offsets and at the bounded train step's shape,
three AdamW steps over the ViT-S/16 and the ViT-tiny/4 params) and writes the sha256 of every output tensor's bytes to a JSON
file. The backward cases take out and lse from the forward's plain twin (at
the kernels' key tile), not from the forward kernel, so that a change to the
forward kernel changes the `stream_fwd/*` and `chunk_fwd/*` digests only.
`--root` names the tree whose `vit_rpe_rope_tpu_torch` is imported, so a
parent commit unpacked under a git-ignored directory can be run beside the
working tree:

  python scripts/torch_kernel_digest.py --root build/parent --out a.json
  python scripts/torch_kernel_digest.py --root . --out b.json
  python scripts/torch_kernel_digest.py --compare a.json b.json

--compare prints the cases whose digests differ and exits 1 if any does.
--time also records each call's time on the card (CUDA events, the mean of
20 launches after 3 warm-up launches; `stream_dq_dkv` times the separate
passes' dq and dk/dv kernels alone; `adamw` the AdamW wrapper, host work
included; `sdpa_fwd/*` PyTorch's scaled_dot_product_attention on the same
inputs as the streaming forward or chunk case of the same name, as a
yardstick, with no digest; beside each, the host's time to issue one call,
by its clock over the same 20 calls) and, for the dense kernels at those
two shapes, the streaming forward at (16, 6, 577, 64) and (8, 6, 2048, 64)
with a bias and at (4, 4, 4097, 32) rope-mixed, the chunk forward at the
bounded step's shape, the separate-pass backward at its three shapes and
the one-pass backward at (4, 4, 4097, 32) and on its two key chunks, each
kernel's device time (torch.profiler, the mean over 20 calls), so that two
trees can be timed in turns in one process each on one card:

  for tree in build/parent . . build/parent; do
    python scripts/torch_kernel_digest.py --root $tree --out d.json --time
  done

--only REGEX times only the cases whose name matches (every digest is
still recorded).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
import time


def _digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def run(root, out_path, timed, only=None):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from vit_rpe_rope_tpu_torch.configs import ViTConfig
    from vit_rpe_rope_tpu_torch.models import vit
    from vit_rpe_rope_tpu_torch.ops import cuda_build
    from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
    from vit_rpe_rope_tpu_torch.ops import fused_adamw

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    assert fa.__file__.startswith(os.path.abspath(root)), fa.__file__
    cuda_build.build_all([fa.SOURCE, fa.BWD_SOURCE, fa.STREAM_SOURCE,
                          fa.STREAM_BWD_SOURCE, fa.STREAM_FUSED_SOURCE,
                          fused_adamw.SOURCE])
    dev = torch.device("cuda")
    digests = {}

    times = {}
    host_times = {}
    kernel_times = {}

    def record_kernels(name, call):
        """Each kernel's device time per call (torch.profiler over 20
        calls, after 3 warm-up calls), keyed by its name without namespace
        and argument list."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        if not timed or (only and not re.search(only, name)):
            return
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        spans = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                kernel = ev.name.replace("(anonymous namespace)::", "")
                kernel = kernel.removeprefix("void ").split("(")[0]
                spans.setdefault(kernel, []).append(
                    ev.time_range.elapsed_us() / 1e3)
        kernel_times[name] = {k: sum(v) / 20 for k, v in spans.items()}

    def record(name, tensors, call=None):
        torch.cuda.synchronize()
        for i, t in enumerate(tensors):
            if t is not None:
                digests[f"{name}/{i}"] = _digest(t)
        if timed and call is not None and not (only and
                                               re.search(only, name) is None):
            for _ in range(3):
                call()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            t0 = time.perf_counter()
            for _ in range(20):
                call()
            host_times[name] = (time.perf_counter() - t0) * 1e3 / 20
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end) / 20

    def qkv(shape, seed):
        gen = torch.Generator().manual_seed(seed)
        return [torch.randn(shape, generator=gen).to(dev) for _ in range(4)]

    def pe_args(regime, h, n, d, seed):
        gen = torch.Generator().manual_seed(seed + 100)
        grid = int(round((n - 1) ** 0.5))
        if regime.startswith("poly"):
            terms = int(regime[4:]) + 1
            powers = torch.arange(terms).float()
            coeff = 0.05 * torch.randn((h, terms), generator=gen) \
                * float(grid) ** -powers
            return {"poly": (coeff.to(dev), grid)}
        if regime == "rel":
            return {"rel": torch.randn((h, 2 * n - 1), generator=gen).to(dev)}
        if regime == "rope-axial":
            phase = 6.0 * torch.rand((n - 1, d // 2), generator=gen)
            cos, sin = fa._kernel_freqs((torch.cos(phase), torch.sin(phase)),
                                        h, n, dev)
            return {"cos": cos, "sin": sin}
        return {}

    def twin_fwd(q, k, v, scale, **kw):
        """out and lse of the streaming forward's plain twin at the kernels'
        key tile: the backward cases' inputs, the same in every tree."""
        return fa.attention_stream_plain(q, k, v, scale,
                                         kv_tile=fa.STREAM_TILE, **kw)

    def sdpa(q, k, v, scale, bias=None, cos=None, sin=None):
        """A call of PyTorch's SDPA on the streaming case's inputs (q and k
        rotated first, the bias as its mask)."""
        import torch.nn.functional as F

        if cos is not None:
            q = fa._rotate(q, cos[None], sin[None])
            k = fa._rotate(k, cos[None], sin[None])
        mask = None if bias is None else bias[None]
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                      scale=scale)

    def stream_fwd_case(name, q, k, v, scale, **kw):
        """The streaming forward's digests, its time and its kernels'
        device times, beside SDPA's time."""
        def fwd():
            return fa.attention_stream_fwd(q, k, v, scale, **kw)

        record(f"stream_fwd/{name}", fwd(), fwd)
        record_kernels(f"stream_fwd/{name}", fwd)
        record(f"sdpa_fwd/{name}", (), sdpa(q, k, v, scale, **kw))

    # dense forward and backward at ViT-S/16 (N=197, D=64), rope-mixed
    q, k, v, g = qkv((4, 6, 197, 64), 0)
    gen = torch.Generator().manual_seed(1)
    phase = 6.0 * torch.rand((6, 196, 32), generator=gen).to(dev)
    cos, sin = fa._kernel_freqs((torch.cos(phase), torch.sin(phase)), 6, 197,
                                dev)
    out = fa.attention_fwd(q, k, v, 0.125, None, cos, sin)
    record("dense_fwd", [out])
    record("dense_bwd", fa.attention_bwd(q, k, v, out, g, 0.125, None, cos,
                                         sin, want_drot=True))
    # the dense kernels at ViT-S/16@224's training shape and ViT-tiny/4's,
    # rope-mixed (with dqr/dkr) and with a relative bias (with dbias), timed
    # with each kernel's device time
    for shape in ((64, 6, 197, 64), (128, 6, 65, 32)):
        b, h, n, d = shape
        q, k, v, g = qkv(shape, 9)
        scale = d ** -0.5
        for regime in ("rope-mixed", "rel"):
            gen = torch.Generator().manual_seed(10)
            bias = cos = sin = None
            if regime == "rel":
                bias = fa._dense_bias(h, n, dev, rel=torch.randn(
                    (h, 2 * n - 1), generator=gen).to(dev))
            else:
                phase = 6.0 * torch.rand((h, n - 1, d // 2), generator=gen)
                cos, sin = fa._kernel_freqs((torch.cos(phase),
                                             torch.sin(phase)), h, n, dev)
            name = f"{regime}@{n}x{d}"

            def fwd():
                return fa.attention_fwd(q, k, v, scale, bias, cos, sin)

            out = fwd()

            def bwd():
                return fa.attention_bwd(q, k, v, out, g, scale, bias, cos,
                                        sin, want_dbias=bias is not None,
                                        want_drot=cos is not None)

            record(f"dense_fwd/{name}", [out], fwd)
            record_kernels(f"dense_fwd/{name}", fwd)
            record(f"dense_bwd/{name}", bwd(), bwd)
            record_kernels(f"dense_bwd/{name}", bwd)
        del q, k, v, g, out
    # the streaming route at (2, 4, 577, 32), (1, 4, 1100, 64) and the
    # long-sequence model's (4, 4, 4097, 32)
    for shape in ((2, 4, 577, 32), (1, 4, 1100, 64), (4, 4, 4097, 32)):
        b, h, n, d = shape
        for regime in ("none", "poly3", "poly7", "rel", "rope-axial"):
            q, k, v, g = qkv(shape, 2)
            kw = pe_args(regime, h, n, d, 3)
            name = f"{regime}@{n}x{d}"
            scale = d ** -0.5
            record(f"stream_fwd/{name}", fa.attention_stream_fwd(
                q, k, v, scale, **kw),
                lambda: fa.attention_stream_fwd(q, k, v, scale, **kw))
            out, lse = twin_fwd(q, k, v, scale, **kw)
            dparam = "poly" in kw or "rel" in kw
            record(f"stream_bwd/{name}", fa.attention_stream_bwd(
                q, k, v, out, g, lse, scale, want_dparam=dparam, **kw))
            record(f"stream_dq_dkv/{name}", (), lambda: fa.attention_stream_bwd(
                q, k, v, out, g, lse, scale, **kw))
            delta = (g * out).sum(dim=-1)

            def fused():
                return fa.attention_stream_bwd_fused(q, k, v, g, lse, delta,
                                                     scale, **kw)

            record(f"fused_bwd/{name}", fused(), fused)
            if n == 4097:
                record_kernels(f"fused_bwd/{name}", fused)
            if "cos" not in kw:
                rows = slice(n // 2, n)
                record(f"chunk_fwd/{name}", fa.streaming_chunk_fwd(
                    q[:, :, rows], k, v, scale, n // 2, 0, n, **kw))
    # the separate passes with a materialized bias and dbias, at ViT-S/16@384
    # training's shape and at (8, 6, 2048, 64), the longest sequence that
    # trains a materialized bias; digests of dq, dk, dv and dbias
    for shape in ((16, 6, 577, 64), (8, 6, 2048, 64)):
        n = shape[2]
        q, k, v, g = qkv(shape, 4)
        bias = fa._dense_bias(6, n, dev, rel=pe_args("rel", 6, n, 64, 5)[
            "rel"])
        stream_fwd_case(f"bias@{n}x64", q, k, v, 0.125, bias=bias)
        out, lse = twin_fwd(q, k, v, 0.125, bias=bias)

        def dbias_bwd():
            return fa.attention_stream_bwd(q, k, v, out, g, lse, 0.125,
                                           bias=bias, want_dbias=True)

        record(f"stream_bwd_dbias/bias@{n}x64", dbias_bwd()[:4], dbias_bwd)
        record_kernels(f"stream_bwd_dbias/bias@{n}x64", dbias_bwd)
        del q, k, v, g, bias, out, lse
    # the separate passes with rope-mixed's per-head tables and dqr / dkr at
    # the long-sequence model's shape
    shape = (4, 4, 4097, 32)
    q, k, v, g = qkv(shape, 8)
    gen = torch.Generator().manual_seed(11)
    phase = 6.0 * torch.rand((4, 4096, 16), generator=gen)
    cos, sin = fa._kernel_freqs((torch.cos(phase), torch.sin(phase)), 4,
                                4097, dev)
    stream_fwd_case("rope-mixed@4097x32", q, k, v, 32 ** -0.5, cos=cos,
                    sin=sin)
    out, lse = twin_fwd(q, k, v, 32 ** -0.5, cos=cos, sin=sin)

    def drot_bwd():
        return fa.attention_stream_bwd(q, k, v, out, g, lse, 32 ** -0.5,
                                       cos=cos, sin=sin, want_drot=True)

    record("stream_bwd_drot/rope-mixed@4097x32", drot_bwd()[:6], drot_bwd)
    record_kernels("stream_bwd_drot/rope-mixed@4097x32", drot_bwd)
    del q, k, v, g, out, lse
    # the chunk forward at the bounded train step's shape at N = 65,537: the
    # second q-chunk of 16,384 rows against all 66,048 keys, 65,537 valid
    q, k, v, _ = qkv((1, 4, 66048, 32), 12)
    qc, n_valid = q[:, :, 16384:32768], 65537

    def chunk():
        return fa.streaming_chunk_fwd(qc, k, v, 32 ** -0.5, 16384, 0, n_valid)

    record("chunk_fwd/none@16384x66048x32", chunk(), chunk)
    record_kernels("chunk_fwd/none@16384x66048x32", chunk)
    record("sdpa_fwd/none@16384x66048x32", (), sdpa(
        qc, k[:, :, :n_valid], v[:, :, :n_valid], 32 ** -0.5))
    del q, k, v, qc
    # the one-pass backward on the key chunks of the bounded train step: the
    # second q-chunk of the --q_chunk 2048 epoch at N = 4,097 (batch 4,
    # 2,048 rows against its 4,608 padded keys) and of the step at N =
    # 65,537 (16,384 rows against 66,048 keys), lse and delta of the twin
    for label, shape, r0, rows, n_valid in (
            ("2048x4608x32", (4, 4, 4608, 32), 2048, 2048, 4097),
            ("16384x66048x32", (1, 4, 66048, 32), 16384, 16384, 65537)):
        q, k, v, g = qkv(shape, 13)
        q, g = q[:, :, r0:r0 + rows], g[:, :, r0:r0 + rows]
        lse = torch.randn(q.shape[:3], generator=torch.Generator(
            ).manual_seed(14)).to(dev).abs() + 8.0
        delta = 0.1 * torch.randn(q.shape[:3], generator=torch.Generator(
            ).manual_seed(15)).to(dev)

        def chunk_bwd():
            return fa.streaming_chunk_bwd(q, k, v, g, lse, delta, 32 ** -0.5,
                                          r0, 0, n_valid)

        record(f"fused_chunk/none@{label}", chunk_bwd()[:3], chunk_bwd)
        record_kernels(f"fused_chunk/none@{label}", chunk_bwd)
        del q, k, v, g, lse, delta
    # three AdamW steps over the ViT-S/16 params (21,580,426) and the
    # ViT-tiny/4 CIFAR params (the train CLI's default), then the wrapper's
    # time on the same lists
    hyper = (1e-3, 0.271, 0.0039, 0.9, 0.999, 1e-8, 0.05)
    for label, cfg in (("vit_s16", ViTConfig(
            img_size=224, patch_size=16, embed_dim=384, depth=12, num_heads=6,
            pos_encoding="rope-mixed")),
            ("vit_tiny4", ViTConfig(pos_encoding="rope-mixed"))):
        params = vit.init_params(torch.Generator().manual_seed(6), cfg,
                                 device=dev)
        gen = torch.Generator().manual_seed(7)
        grads, mus, nus = ([torch.randn(p.shape, generator=gen).to(dev)
                            for p in params.values()] for _ in range(3))
        lists = (list(params.values()), grads, mus, [t.abs() for t in nus])

        def adamw_step():
            fused_adamw.adamw_update(*lists, *hyper)

        for _ in range(3):
            adamw_step()
        record(f"adamw/{label}", [torch.cat([t.flatten() for t in group])
                                  for group in (lists[0], lists[2],
                                                lists[3])], adamw_step)
        record_kernels(f"adamw/{label}", adamw_step)
    with open(out_path, "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0),
                   "digests": digests, "ms": times,
                   "host_ms": host_times, "kernel_ms": kernel_times}, f,
                  indent=1, sort_keys=True)
    print(f"{len(digests)} digests -> {out_path}")
    for name, ms in times.items():
        print(f"{root}  {name}  {ms:.4f} ms  (host {host_times[name]:.4f} "
              f"ms)")
    for name, by_kernel in kernel_times.items():
        for kernel, ms in sorted(by_kernel.items()):
            print(f"{root}  {name}  kernel {kernel}  {ms:.4f} ms")


def compare(a, b):
    da, db = (json.load(open(p))["digests"] for p in (a, b))
    differ = sorted(k for k in set(da) | set(db) if da.get(k) != db.get(k))
    print(f"{len(da)} / {len(db)} outputs; {len(differ)} differ"
          + "".join(f"\n  {k}" for k in differ))
    return 1 if differ else 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--only", help="time only the cases matching this regex")
    args = ap.parse_args()
    if args.compare:
        raise SystemExit(compare(*args.compare))
    run(args.root, args.out, args.time, args.only)


if __name__ == "__main__":
    main()
