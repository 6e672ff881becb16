"""Inference CLI: classify an .npz of uint8 images with a checkpoint.

  --input images.npz   npz with 'images' (uint8 NHWC or HWC, at the
                       dataset's native size or already at the model's
                       size) and optional 'labels' to score accuracy

The model architecture is reconstructed from the checkpoint's shapes alone
(viz.introspect.infer_vit_config), so reference-trained .pth files work
directly. Checkpoints whose shapes do not pin the patch grid (none,
absolute, rope, shared-coefficient polynomial) default to grid 8; pass
--grid_size 14 for a ViT-S/16 at 224 px.

  python -m vit_rpe_rope_tpu_torch.cli.predict ckpt.npz --input batch.npz \\
      --grid_size 14

Runs on the CUDA device; --device cpu runs on the CPU. Artifact export,
int8 and sharded export are not ported yet: their flags are refused.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ViT inference: classify images")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trained checkpoint (.npz / reference .pth)")
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "mnist", "cifar10"],
                   help="normalization/native-size contract (auto: by the "
                        "checkpoint's in_chans — 1=mnist, 3=cifar10)")
    p.add_argument("--input", type=str, default=None,
                   help="npz with 'images' (uint8 NHWC or HWC) and optional "
                        "'labels'")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_heads", type=int, default=6,
                   help="fallback when the checkpoint doesn't pin it")
    p.add_argument("--grid_size", type=int, default=None,
                   help="patch grid when the checkpoint's shapes don't pin "
                        "it (default: 8, incl. the reference's cifar10-"
                        "filename quirk; an explicit value always wins)")
    p.add_argument("--rope_mixed_compat_scramble", action="store_true",
                   help="interpret rope-mixed learned frequencies with the "
                        "reference's (head, position) memory scramble — use "
                        "for reference-trained .pth")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "CPU)")
    p.add_argument("--export", type=str, default=None,
                   help="not ported yet (refused)")
    p.add_argument("--artifact", type=str, default=None,
                   help="not ported yet (refused)")
    p.add_argument("--int8", action="store_true",
                   help="not ported yet (refused)")
    p.add_argument("--export_data_parallel", type=int, default=1,
                   help="not ported yet (refused when > 1)")
    return p


def reject_unported(parser: argparse.ArgumentParser, asked: dict) -> None:
    """argparse error naming every {flag: was_asked_for} that is asked for:
    those features are not ported yet and are never silently ignored."""
    flags = [flag for flag, on in asked.items() if on]
    if flags:
        parser.error(f"{', '.join(flags)}: not ported to the PyTorch "
                     f"package yet")


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    reject_unported(parser, {
        "--export": args.export is not None,
        "--artifact": args.artifact is not None,
        "--int8": args.int8,
        "--export_data_parallel": args.export_data_parallel > 1,
    })
    if args.checkpoint is None:
        parser.error("need a checkpoint")

    import numpy as np

    from vit_rpe_rope_tpu_torch import serving

    params, cfg, mean, std, native, dataset = serving.load_serving_state(
        args.checkpoint, dataset=args.dataset, num_heads=args.num_heads,
        grid_size=args.grid_size,
        rope_mixed_compat_scramble=args.rope_mixed_compat_scramble)
    print(f"{args.checkpoint}: {cfg.pos_encoding} ViT d{cfg.embed_dim} "
          f"depth {cfg.depth} heads {cfg.num_heads} patch "
          f"{cfg.patch_size} @ {cfg.img_size}px ({dataset} contract)")
    if not args.input:
        return None
    predictor = serving.Predictor.from_params(params, cfg, mean, std, native,
                                              device=args.device)
    with np.load(args.input) as z:
        images = z["images"]
        labels = z["labels"] if "labels" in z.files else None
    if images.ndim == 3:
        images = images[None]
    preds = []
    for s in range(0, len(images), args.batch_size):
        preds.append(predictor.predict(images[s:s + args.batch_size]))
    preds = np.concatenate(preds)
    print("predictions:", " ".join(str(int(c)) for c in preds[:64])
          + (" ..." if len(preds) > 64 else ""))
    if labels is not None:
        acc = 100.0 * float((preds == np.asarray(labels)).mean())
        print(f"accuracy: {acc:.2f}% ({len(preds)} examples)")
    return preds


if __name__ == "__main__":
    main()
