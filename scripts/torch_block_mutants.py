"""Shows that the check of the fused block kernel (row 12) in phase 16a of
chip_smoke.py fails a kernel that drops the key mask, the rope rotation or
the keys of the other CTAs of its cluster.

Writes three deliberately broken copies of ops/csrc/block_fused.cu into a
temporary directory (keys at index >= N left unmasked; q and k left
unrotated; every CTA of a cluster attending only over the key blocks it
holds itself, read in place of the other ranks'), builds them beside the
intact kernel, and runs each through `block_forward` on phase 16a's cases:
one block of chip_smoke.block_stack's weights, float32, in none and
rope-axial, at ViT-tiny/4 (batch 128, one CTA an image) and at
ViT-S/16@224 (batch 64, a cluster of 7 CTAs an image). For each it prints
max |kernel - twin| and its share of the largest entry of the block's update
(chip_smoke.update_share) against the check's limit, BLOCK_FUSED_TOL. A
mutant is run only where it changes the kernel: the rotation with rope, the
other ranks' keys in a cluster of more than one CTA. Needs a CUDA device and
nvcc; exits 1 if a broken kernel passes the check or the intact one fails
it.

  python scripts/torch_block_mutants.py
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Each mutant: (text of block_fused.cu, its replacement), every occurrence.
MUTANTS = {
    "no key mask": ("x = key < N ? __fmul_rn(x, p.scale) : NEG_INF;",
                    "x = __fmul_rn(x, p.scale);"),
    "no rotation": ("if (rope && tok >= 1 && tok <= tab_rows && tok < N) {",
                    "if (false) {"),
    "own keys only": ("const int src = owner;",
                      "const int src = cluster_rank();"),
}


def build_mutants(block_fused, cuda_build):
    """{name: loaded library} of the intact kernel and every mutant."""
    text = block_fused.SOURCE.read_text()
    libs = {"intact": block_fused._library()}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        tmp = pathlib.Path(tmp)
        for header in block_fused.SOURCE.parent.glob("*.cuh"):
            (tmp / header.name).write_text(header.read_text())
        for name, (old, new) in MUTANTS.items():
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in "
                                 f"{block_fused.SOURCE.name}")
            path = tmp / f"block_fused_{name.replace(' ', '_')}.cu"
            path.write_text(text.replace(old, new))
            paths[name] = path
        for name, lib_path in zip(paths, cuda_build.build_all(paths.values())):
            lib = ctypes.CDLL(str(lib_path))
            block_fused._bind(lib)
            libs[name] = lib
    return libs


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
    device = torch.device("cuda")
    libs = build_mutants(block_fused, cuda_build)
    real_library = block_fused._library
    tol = chip_smoke.BLOCK_FUSED_TOL
    wrong = []
    for label, kw, batch in (
            ("ViT-tiny/4", {}, 128),
            ("ViT-S/16@224", dict(img_size=224, patch_size=16, embed_dim=384,
                                  num_heads=6), 64)):
        for pe_name in ("none", "rope-axial"):
            cfg = ViTConfig(**kw, pos_encoding=pe_name)
            cluster = block_fused.block_plan(
                cfg.seq_len, cfg.embed_dim, cfg.head_dim,
                cfg.mlp_hidden_dim)["CLUSTER"]
            blocks, freqs = chip_smoke.block_stack(vit, cfg, device, 30)
            x = torch.randn((batch, cfg.seq_len, cfg.embed_dim),
                            generator=torch.Generator().manual_seed(31))
            x = x.to(device)
            want = block_fused.block_forward_plain(x, blocks[0], cfg, freqs)
            for name, lib in libs.items():
                if (name == "no rotation" and freqs is None) or (
                        name == "own keys only" and cluster == 1):
                    continue  # the same kernel as the intact one here
                block_fused._library = lambda lib=lib: lib
                try:
                    got = block_fused.block_forward(x, blocks[0], cfg, freqs)
                    torch.cuda.synchronize()
                finally:
                    block_fused._library = real_library
                err, share = chip_smoke.update_share(got, want, x)
                passes = share <= tol
                print(f"{label:12s} cluster {cluster:2d} {pe_name:10s} "
                      f"{name:13s} max_abs_err={err:.3e} share of the "
                      f"update's largest entry={share:.3e} (tol {tol:g}): "
                      f"{'passes' if passes else 'fails'}")
                if passes != (name == "intact"):
                    wrong.append((label, pe_name, name))
    if wrong:
        print(f"the check's verdict is wrong for {wrong}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
