"""Where the fused block kernel (row 12) spends its time: the SM clock
cycles of each phase of one CTA.

Builds a copy of ops/csrc/block_fused.cu into build/block_phases/ with
clock64() stamps by thread 0 of CTA 0 and of CTA gridDim.x / 2 at the
phase boundaries (the residual load and LN1, the qkv product, the cluster
barrier that publishes K and V, the attention, the projection and LN2, the
wait before the MLP, the MLP) written to a __device__ array, runs one block
of chip_smoke.block_stack's weights through `block_forward` with that copy
at ViT-tiny/4 (batch 128) and ViT-S/16@224 (batch 64), f32, none, three
times, and prints the last run's cycles by phase. The stamps themselves
cost a few hundred cycles. Needs a CUDA device and nvcc.

  python scripts/torch_block_phases.py
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "block_phases"

STAMP = ("if (threadIdx.x == 0 && (blockIdx.x == 0 || "
         "blockIdx.x == gridDim.x / 2)) "
         "probe_cycles[blockIdx.x == 0 ? 0 : 1][{id}] = clock64();\n")
# (text of block_fused.cu, stamp index, stamp before or after it)
ANCHORS = (
    ("  const bf16* wqkv = p.w;  // the prologue's tiles of each matrix\n",
     0, "before"),
    ("  layer_norm(p, xres, hln, ROWS, row0, p.n1w, p.n1b);\n"
     "  __syncthreads();\n", 1, "after"),
    ("  cluster_arrive();  // K and V published to the cluster\n", 2,
     "before"),
    ("  attention<KB, TILES>(p, q_s, k_s, v_s, hln);\n", 3, "before"),
    ("  cluster_arrive();  // done reading the cluster's K and V\n", 4,
     "after"),
    ("  layer_norm(p, xres, hln, ROWS, row0, p.n2w, p.n2b);\n"
     "  __syncthreads();\n", 5, "after"),
    ("  cluster_wait();  // every CTA is done with this CTA's K and V: G "
     "may take them\n", 6, "after"),
    ("  cluster_arrive();  // no CTA leaves while others may still arrive "
     "on its barriers\n", 7, "before"),
)
PHASES = ("residual load + LN1", "qkv product", "publish K and V",
          "attention", "projection + LN2", "wait before the MLP", "MLP")


def stamped_source(text):
    for anchor, index, where in ANCHORS:
        if anchor not in text:
            raise SystemExit(f"{anchor!r} is not in block_fused.cu")
        stamp = STAMP.format(id=index)
        text = text.replace(anchor, anchor + stamp if where == "after"
                            else stamp + anchor)
    text = text.replace("namespace {\n",
                        "__device__ long long probe_cycles[2][8];\n"
                        "namespace {\n", 1)
    return text + ('\nextern "C" void probe_read(long long* out) {\n'
                   '  cudaMemcpyFromSymbol(out, probe_cycles, '
                   'sizeof(probe_cycles));\n}\n')


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from vit_rpe_rope_tpu_torch.configs import ViTConfig
    from vit_rpe_rope_tpu_torch.models import vit
    from vit_rpe_rope_tpu_torch.ops import block_fused, cuda_build

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}")
    OUT.mkdir(parents=True, exist_ok=True)
    source = OUT / "block_fused_phases.cu"
    source.write_text(stamped_source(block_fused.SOURCE.read_text()))
    for header in block_fused.SOURCE.parent.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    lib = ctypes.CDLL(str(cuda_build.build(source)))
    block_fused._bind(lib)
    lib.probe_read.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    real_library = block_fused._library
    block_fused._library = lambda: lib
    device = torch.device("cuda")
    try:
        for label, kw, batch in (
                ("ViT-tiny/4", {}, 128),
                ("ViT-S/16@224", dict(img_size=224, patch_size=16,
                                      embed_dim=384, num_heads=6), 64)):
            cfg = ViTConfig(**kw, pos_encoding="none")
            blocks, freqs = chip_smoke.block_stack(vit, cfg, device, 30, 1)
            x = torch.randn((batch, cfg.seq_len, cfg.embed_dim),
                            generator=torch.Generator().manual_seed(31))
            x = x.to(device)
            for _ in range(3):
                block_fused.block_forward(x, blocks[0], cfg, freqs)
            torch.cuda.synchronize()
            cycles = (ctypes.c_longlong * 16)()
            lib.probe_read(cycles)
            plan = block_fused.block_plan(cfg.seq_len, cfg.embed_dim,
                                          cfg.head_dim, cfg.mlp_hidden_dim)
            for cta in range(2):
                stamps = cycles[cta * 8:cta * 8 + 8]
                parts = ", ".join(
                    f"{name} {stamps[i + 1] - stamps[i]}"
                    for i, name in enumerate(PHASES))
                print(f"{label} B={batch} cluster {plan['CLUSTER']} CTA "
                      f"{'0' if cta == 0 else 'grid/2'}: {parts}; total "
                      f"{stamps[7] - stamps[0]} cycles")
    finally:
        block_fused._library = real_library
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
