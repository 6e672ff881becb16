"""CLI for the port's training-trajectory parity harness
(vit_rpe_rope_tpu_torch/utils/trajectory_parity.py): trains the reference
model (from the directory that VIT_PE_REFERENCE, or --reference, names)
and the PyTorch port from one init on one synthetic set in one batch
order, per PE mode, and writes a JSON report with the JAX script's
statistics (scripts/trajectory_parity.py). It imports no JAX.

Usage:
  VIT_PE_REFERENCE=path/to/reference \\
      python scripts/torch_trajectory_parity.py --pe all --steps 200
  python scripts/torch_trajectory_parity.py --pe polynomial \\
      --dataset cifar10 --steps 400 --reference path/to/reference \\
      --device cpu --out poly_traj.json

Without the reference directory it stops with an error that names it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ALL_PES = ["none", "absolute", "relative", "polynomial", "rope-axial",
           "rope-mixed"]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pe", default="all", choices=ALL_PES + ["all"])
    ap.add_argument("--dataset", default="mnist",
                    choices=["mnist", "cifar10"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--embed_dim", type=int, default=64)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--num_heads", type=int, default=4)
    ap.add_argument("--img_size", type=int, default=None)
    ap.add_argument("--patch_size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reference", default=None,
                    help="the reference checkout (default: "
                         "$VIT_PE_REFERENCE)")
    ap.add_argument("--device", default=None,
                    help="the port's device (default: the card; cpu asks "
                         "for the CPU; the reference model trains on the "
                         "CPU)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from vit_rpe_rope_tpu_torch.utils.trajectory_parity import (
        reference_dir, run_trajectory_parity)

    try:
        reference_dir(args.reference)
    except FileNotFoundError as e:
        ap.error(str(e))
    pes = ALL_PES if args.pe == "all" else [args.pe]
    results = [run_trajectory_parity(
        pe=pe, dataset=args.dataset, steps=args.steps,
        batch_size=args.batch_size, epochs=args.epochs,
        embed_dim=args.embed_dim, depth=args.depth,
        num_heads=args.num_heads, img_size=args.img_size,
        patch_size=args.patch_size, lr=args.lr, seed=args.seed,
        reference=args.reference, device=args.device) for pe in pes]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
