"""Inference / deployment CLI, three things composable in one invocation:

  * classify:  --input images.npz   (npz: 'images' uint8 NHWC or HWC, at
               the dataset's native size or already at the model's size,
               and optional 'labels' to score accuracy)
  * export:    --export model.pt2   (a self-contained batch-polymorphic
               torch.export artifact; replayable with torch and the port's
               ops module, without the checkpoint or the model code)
  * serve an artifact: --artifact model.pt2 (instead of a checkpoint)

--int8 quantizes after loading (quant.py; --int8_mode w8a8, w8a8-static
with calibration images from --calib or --input, or w8a16); classify and
export share the quantized params.

The model architecture is reconstructed from the checkpoint's shapes alone
(viz.introspect.infer_vit_config), so reference-trained .pth files work
directly. Checkpoints whose shapes do not pin the patch grid (none,
absolute, rope, shared-coefficient polynomial) default to grid 8; pass
--grid_size 14 for a ViT-S/16 at 224 px.

  python -m vit_rpe_rope_tpu_torch.cli.predict ckpt.npz --input batch.npz \\
      --grid_size 14 --int8 --int8_mode w8a16 --export vit_s_w8a16.pt2

Runs on the CUDA device; --device cpu runs on the CPU (an artifact serves
on the device type it was exported on). --export_data_parallel N exports a
data-parallel artifact over N devices (serving.export_model(mesh=)): each
batch is split into N equal shards, one per device; it needs N CUDA
devices (or runs N "cpu" entries with --device cpu).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="ViT inference: classify images / export an artifact")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trained checkpoint (.npz / reference .pth); omit "
                        "when using --artifact")
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "mnist", "cifar10"],
                   help="normalization/native-size contract (auto: by the "
                        "checkpoint's in_chans — 1=mnist, 3=cifar10)")
    p.add_argument("--input", type=str, default=None,
                   help="npz with 'images' (uint8 NHWC or HWC) and optional "
                        "'labels'")
    p.add_argument("--export", type=str, default=None,
                   help="write a torch.export serving artifact (.pt2) here")
    p.add_argument("--artifact", type=str, default=None,
                   help="serve from a saved artifact (no checkpoint/model "
                        "code needed)")
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
    p.add_argument("--export_data_parallel", type=int, default=1,
                   help="export a data-parallel artifact: the batch split "
                        "over this many devices; replay requires the same "
                        "device count (serving.export_model mesh=)")
    p.add_argument("--int8", action="store_true",
                   help="post-training int8 quantization (quant.py); mode "
                        "per --int8_mode")
    p.add_argument("--int8_mode", type=str, default="w8a8",
                   choices=["w8a8", "w8a8-static", "w8a16"],
                   help="w8a8: int8 products with dynamic per-token "
                        "activation scales; w8a8-static: int8 products with "
                        "offline-calibrated per-tensor scales (--calib, "
                        "default: the --input batch); w8a16: weight-only — "
                        "int8 weights dequantized into bf16 matmuls")
    p.add_argument("--calib", type=str, default=None,
                   help="npz with 'images' (uint8) for w8a8-static "
                        "activation-scale calibration; defaults to --input")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "CPU)")
    return p


def _export_mesh(n: int, device):
    """The mesh of n devices for --export_data_parallel n: the first n CUDA
    devices (n "cpu" entries on the CPU); exits, as the JAX CLI does, where
    fewer are visible."""
    from vit_rpe_rope_tpu_torch.parallel.mesh import local_devices, make_mesh
    from vit_rpe_rope_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    devices = ([device] * n if device.type == "cpu"
               else local_devices(device.type))
    mesh = make_mesh(num_devices=n, devices=devices)
    if mesh.size != n:
        raise SystemExit(f"--export_data_parallel {n}: only {mesh.size} "
                         f"devices visible")
    return mesh


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.artifact is None and args.checkpoint is None:
        parser.error("need a checkpoint or --artifact")
    if args.artifact is not None and (args.checkpoint is not None
                                      or args.export or args.int8):
        # An artifact is finished: there is nothing to re-export or
        # quantize, and a checkpoint beside it would be ignored.
        parser.error("--artifact serves a finished artifact and cannot be "
                     "combined with a checkpoint, --export, or --int8")

    import os

    import numpy as np

    from vit_rpe_rope_tpu_torch import serving

    int8 = args.int8_mode if args.int8 else False
    if args.artifact is not None:
        predictor = serving.Predictor.from_artifact(args.artifact,
                                                    device=args.device)
        print(f"Loaded artifact {args.artifact} (input "
              f"{predictor.in_shape}, batch-polymorphic)")
    else:
        calib_u8 = None
        if int8 == "w8a8-static":
            calib_src = args.calib or args.input
            if calib_src is None:
                parser.error(
                    "--int8_mode w8a8-static needs calibration images: "
                    "pass --calib images.npz (or --input, used as fallback)")
            with np.load(calib_src) as z:
                calib_u8 = z["images"]
        # Quantized once here; classify and export share the result.
        params, cfg, mean, std, native, dataset = serving.load_serving_state(
            args.checkpoint, dataset=args.dataset, num_heads=args.num_heads,
            grid_size=args.grid_size,
            rope_mixed_compat_scramble=args.rope_mixed_compat_scramble,
            int8=int8, calib_images_u8=calib_u8, device=args.device)
        print(f"{args.checkpoint}: {cfg.pos_encoding} ViT d{cfg.embed_dim} "
              f"depth {cfg.depth} heads {cfg.num_heads} patch "
              f"{cfg.patch_size} @ {cfg.img_size}px ({dataset} contract"
              + (f", int8 {int8}" if int8 else "") + ")")
        predictor = None
        if args.input:
            predictor = serving.Predictor.from_params(
                params, cfg, mean, std, native, device=args.device,
                int8=int8)
        if args.export:
            mesh = None
            if args.export_data_parallel > 1:
                mesh = _export_mesh(args.export_data_parallel, args.device)
            exported = serving.export_model(params, cfg, mean, std, native,
                                            int8=int8, mesh=mesh,
                                            device=args.device)
            path = serving.save_artifact(args.export, exported)
            shard_note = (f", sharded over {mesh.size} devices"
                          if mesh is not None else "")
            print(f"Exported {path} ({os.path.getsize(path):,} bytes, "
                  f"device {serving.artifact_device_type(exported)}, "
                  f"symbolic batch{shard_note})")

    if not args.input:
        return None
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
