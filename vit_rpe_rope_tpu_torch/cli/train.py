"""Training CLI — the reference's flag surface preserved verbatim (same
flags, defaults and choices, including the paired --poly_shared_heads /
--no-poly_shared_heads negative flag) and the JAX package's extension flags,
plus --device.

  python -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --pos_encoding rope-mixed

Runs on the CUDA device; --device cpu runs on the CPU. --q_chunk (and
--kv_chunk) train through the bounded-program driver (train/bounded.py),
which refuses --drop_rate, --attn_drop_rate, --drop_path_rate and
--augment, as the JAX package's does. --attn_drop_rate runs the attention
on the unfused oracle (the mask lives on the probabilities). --remat
recomputes each block in the backward (--remat_policy full, dots or
softmax); --steps_per_dispatch k > 1 runs k steps per dispatch, one CUDA
graph replay on the card (eagerly where the steps draw random numbers or
under --debug_nans); --profile_dir writes a torch.profiler Chrome trace;
--debug_nans raises FloatingPointError at the first NaN.

Data parallelism: launch one rank per device with torchrun, and each rank
takes its share of every batch (the world size must divide --batch_size);
--zero1 also shards the AdamW moments over the ranks:

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --zero1

The ranks talk over NCCL on CUDA (one rank per card) and over gloo with
--device cpu; --dist_backend gloo lets several ranks share one card. Only
rank 0 prints and writes the CSV and the checkpoints.

Tensor parallelism: --model_parallel T shards the heads and the MLP rows
over T ranks (T must divide the world size and --num_heads); the world is
a data x model grid of D = world / T data ranks, and --zero1 shards each
model shard's AdamW moments over its D data ranks:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --model_parallel 2 --zero1 --device cpu

Context parallelism: --sequence_parallel R shards the tokens over R ranks
and runs every block's attention as a KV ring over them (R must divide the
world size); the world is a data x seq grid of D = world / R data ranks,
and --zero1 shards the AdamW moments over every rank. With --q_chunk the
bounded driver runs its per-q-chunk ring over the same grid. Ranks that
share one card need --dist_backend gloo:

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --sequence_parallel 2 --dist_backend gloo

Pipeline parallelism: --pipeline_parallel P stages the blocks over P ranks
(P must divide the world size and --depth) and runs each batch through
them as a GPipe schedule of --pp_microbatches M microbatches (0: P; M
must divide a data rank's share of the batch); the world is a data x pipe
grid of D = world / P data ranks. With --model_parallel T each stage also
shards its heads and MLP rows over T ranks (a data x pipe x model grid of
D = world / (P·T) data ranks). --zero1, --grad_accum and dropout are
refused with it, as in the JAX package:

  python -m torch.distributed.run --nproc_per_node 2 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --pipeline_parallel 2 --pp_microbatches 4 --device cpu

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --pipeline_parallel 2 --model_parallel 2 --dist_backend gloo

The compositions with the sequence axis take no flag of their own:
--sequence_parallel R with --model_parallel T runs TP x CP on a data x seq
x model grid of D = world / (R·T) data ranks, with --pipeline_parallel P
PP x CP (data x pipe x seq), and with both PP x TP x CP (data x pipe x seq
x model). --zero1 is refused with TP x CP and with a pipe axis, dropout
with any of them, --grad_accum with a pipe axis, as in the JAX package:

  python -m torch.distributed.run --nproc_per_node 4 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --sequence_parallel 2 --model_parallel 2 \\
      --dist_backend gloo --device cpu

  python -m torch.distributed.run --nproc_per_node 8 \\
      -m vit_rpe_rope_tpu_torch.cli.train --dataset cifar10 --synthetic \\
      --epochs 1 --pipeline_parallel 2 --sequence_parallel 2 \\
      --model_parallel 2 --dist_backend gloo --device cpu
"""

from __future__ import annotations

import argparse



def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Vision Transformer Training")

    # Directories
    parser.add_argument("--log_dir", type=str, default="logs")
    parser.add_argument("--ckpt_dir", type=str, default="checkpoints")

    # Dataset selection
    parser.add_argument("--dataset", type=str, default="mnist",
                        choices=["mnist", "cifar10"])
    # Positional encoding method
    parser.add_argument("--pos_encoding", type=str, default="absolute",
                        choices=["none", "absolute", "relative", "polynomial",
                                 "rope-axial", "rope-mixed"])
    # RoPE theta parameter for controlling frequency bands
    parser.add_argument("--rope_theta", type=float, default=100.0,
                        help="Theta parameter for RoPE variants (lower value = "
                             "higher frequency)")
    # Polynomial-specific parameters
    parser.add_argument("--poly_degree", type=int, default=3,
                        help="Degree of polynomial for PolynomialRPE (default: 3)")
    parser.add_argument("--poly_shared_heads", action="store_true", default=True,
                        help="Share polynomial coefficients across attention heads")
    parser.add_argument("--no-poly_shared_heads", action="store_false",
                        dest="poly_shared_heads",
                        help="Do not share polynomial coefficients across "
                             "attention heads")
    # Training hyperparameters
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=25)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    # Model architecture parameters
    parser.add_argument("--img_size", type=int, default=32)
    parser.add_argument("--patch_size", type=int, default=4)
    parser.add_argument("--embed_dim", type=int, default=192)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--num_heads", type=int, default=6)

    # ---- Extensions (not in the reference CLI) ----
    ext = parser.add_argument_group("extensions")
    ext.add_argument("--data_dir", type=str, default="./data",
                     help="[extension] dataset root directory")
    ext.add_argument("--synthetic", action="store_true",
                     help="[extension] use a deterministic procedural dataset "
                          "(for smoke tests / zero-egress environments)")
    ext.add_argument("--seed", type=int, default=0,
                     help="[extension] PRNG seed (the reference never seeds)")
    ext.add_argument("--attention_impl", type=str, default="auto",
                     choices=["auto", "reference", "flash", "flash_block"],
                     help="[extension] attention: the hand-written fused "
                          "kernels (auto/flash), the same kernels behind one "
                          "differentiation boundary per block for the "
                          "bias-free PE modes (flash_block; relative and "
                          "polynomial fall back to flash) or the unfused "
                          "torch oracle (reference)")
    ext.add_argument("--compute_dtype", type=str, default="float32",
                     choices=["float32", "bfloat16"],
                     help="[extension] activation compute dtype")
    ext.add_argument("--remat", action="store_true",
                     help="[extension] rematerialize blocks in the backward "
                          "pass (O(depth) less activation memory)")
    ext.add_argument("--remat_policy", type=str, default="full",
                     choices=["full", "dots", "softmax"],
                     help="[extension] remat selectivity: full recompute; "
                          "dots (save matmul outputs, recompute elementwise)"
                          "; softmax (save everything EXCEPT the f32 "
                          "attention softmax tensors — cheapest recompute, "
                          "removes the dominant dense-regime residual "
                          "traffic)")
    ext.add_argument("--rope_mixed_compat_scramble", action="store_true",
                     help="[extension] reproduce the reference RoPE-Mixed "
                          "(head,position) memory-scramble (SURVEY.md Q1) for "
                          "checkpoint-level parity")
    ext.add_argument("--augment", action="store_true",
                     help="[extension] on-device random flip + pad-and-crop "
                          "augmentation (the reference trains without any; "
                          "published accuracies reflect the no-augmentation "
                          "regime)")
    ext.add_argument("--resume", action="store_true",
                     help="[extension] resume from {ckpt_dir}/{dataset}_"
                          "{pos_encoding}_last.npz (params + optimizer + "
                          "epoch; the reference always restarts from scratch)")
    ext.add_argument("--profile_dir", type=str, default=None,
                     help="[extension] torch.profiler Chrome trace of the "
                          "run, written to this directory")
    ext.add_argument("--debug_nans", action="store_true",
                     help="[extension] NaN sanitizer: raise "
                          "FloatingPointError at the first NaN, forward or "
                          "backward")
    ext.add_argument("--steps_per_dispatch", type=int, default=0,
                     help="[extension] train steps per dispatch: one CUDA "
                          "graph replay of k captured steps on the card "
                          "(0 = auto: 1 on every device)")
    ext.add_argument("--model_parallel", type=int, default=1,
                     help="[extension] tensor-parallel degree: shard attention"
                          " heads and the MLP hidden dim over the mesh's"
                          " 'model' axis (must divide num_heads; 1 = pure"
                          " data parallelism)")
    ext.add_argument("--sequence_parallel", type=int, default=1,
                     help="[extension] sequence/context-parallel degree: "
                          "shard tokens over a mesh axis and run attention "
                          "as a KV ring over ICI (long-sequence memory "
                          "scaling; composes with --model_parallel into a "
                          "3-axis data x seq x model mesh)")
    ext.add_argument("--pipeline_parallel", type=int, default=1,
                     help="[extension] pipeline-parallel degree: stage the "
                          "transformer blocks over a mesh axis with a GPipe "
                          "microbatch schedule (must divide depth; composes "
                          "with --model_parallel into a 3-axis data x pipe "
                          "x model mesh; mutually exclusive with "
                          "--sequence_parallel)")
    ext.add_argument("--pp_microbatches", type=int, default=0,
                     help="[extension] microbatches per device batch under "
                          "--pipeline_parallel (0 = auto: the stage count)")
    ext.add_argument("--grad_accum", type=int, default=1,
                     help="[extension] gradient accumulation: batches summed "
                          "per optimizer step (effective batch = batch_size "
                          "x grad_accum at one batch of activation memory)")
    ext.add_argument("--q_chunk", type=int, default=0,
                     help="[extension] bounded-program stepping: slice each "
                          "train step into many short single-device programs "
                          "(this many attention query rows per program) — "
                          "for per-program execution deadlines and remat-"
                          "free residency at very long N (train/bounded.py); "
                          "0 = monolithic step")
    ext.add_argument("--kv_chunk", type=int, default=0,
                     help="[extension] with --q_chunk: also segment the key "
                          "axis of the backward (bounds dk/dv gradient "
                          "residency; the N=2M single-chip regime needs it)")
    ext.add_argument("--zero1", action="store_true",
                     help="[extension] ZeRO stage 1: shard the Adam moments "
                          "over the data axis (1/n_data optimizer memory per "
                          "chip; params ride one tiled all_gather over ICI)")
    ext.add_argument("--drop_rate", type=float, default=0.0,
                     help="[extension] dropout after attn-proj and MLP"
                          " linears (the reference constructor accepts this"
                          " but never forwards it into blocks; effective"
                          " reference value is 0)")
    ext.add_argument("--attn_drop_rate", type=float, default=0.0,
                     help="[extension] dropout on attention probabilities"
                          " (same reference caveat as --drop_rate)")
    ext.add_argument("--drop_path_rate", type=float, default=0.0,
                     help="[extension] per-sample stochastic depth on"
                          " residual branches (reference instantiates"
                          " DropPath but always at 0)")
    ext.add_argument("--device", type=str, default=None,
                     help="[extension] torch device (default: cuda; 'cpu' "
                          "runs on the CPU)")
    ext.add_argument("--dist_backend", type=str, default=None,
                     choices=["nccl", "gloo"],
                     help="[extension] torch.distributed backend of the "
                          "ranks under torchrun (default: nccl on CUDA, gloo "
                          "on the CPU; gloo lets several ranks share one "
                          "card)")
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    regularised = [flag for flag, on in {
        "--drop_rate": args.drop_rate > 0,
        "--attn_drop_rate": args.attn_drop_rate > 0,
        "--drop_path_rate": args.drop_path_rate > 0,
        "--augment": args.augment}.items() if on]
    if args.q_chunk > 0 and regularised:
        parser.error(f"--q_chunk (bounded-program stepping) does not support "
                     f"{', '.join(regularised)}")
    from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
    from vit_rpe_rope_tpu_torch.parallel import distributed
    from vit_rpe_rope_tpu_torch.train.loop import fit

    cfg = ViTConfig(
        img_size=args.img_size,
        patch_size=args.patch_size,
        in_chans=1 if args.dataset == "mnist" else 3,
        num_classes=10,
        embed_dim=args.embed_dim,
        depth=args.depth,
        num_heads=args.num_heads,
        pos_encoding=args.pos_encoding,
        rope_theta=args.rope_theta,
        poly_degree=args.poly_degree,
        poly_shared_heads=args.poly_shared_heads,
        rope_mixed_compat_scramble=args.rope_mixed_compat_scramble,
        attention_impl=args.attention_impl,
        compute_dtype=args.compute_dtype,
        remat=args.remat,
        remat_policy=args.remat_policy,
        drop_rate=args.drop_rate,
        attn_drop_rate=args.attn_drop_rate,
        drop_path_rate=args.drop_path_rate,
    )
    tcfg = TrainConfig(
        dataset=args.dataset,
        batch_size=args.batch_size,
        epochs=args.epochs,
        lr=args.lr,
        weight_decay=args.weight_decay,
        log_dir=args.log_dir,
        ckpt_dir=args.ckpt_dir,
        data_dir=args.data_dir,
        seed=args.seed,
        synthetic_data=args.synthetic,
        resume=args.resume,
        augment=args.augment,
        pp_microbatches=args.pp_microbatches,
        grad_accum=args.grad_accum,
        q_chunk=args.q_chunk,
        kv_chunk=args.kv_chunk,
        zero1=args.zero1,
        model_parallel=args.model_parallel,
        sequence_parallel=args.sequence_parallel,
        pipeline_parallel=args.pipeline_parallel,
        steps_per_dispatch=args.steps_per_dispatch,
        profile_dir=args.profile_dir,
        debug_nans=args.debug_nans,
    )
    # torchrun's environment: join its process group (a no-op without one)
    joined = (not distributed.is_initialized()
              and distributed.initialize(args.dist_backend, args.device))
    try:
        summary = fit(cfg, tcfg, device=args.device)
    finally:
        if joined:
            distributed.finalize()
    if summary["log_file"] is not None:  # rank 0, or the one process
        print(f"\nDone. Best Test Acc: {summary['best_acc']:.2f}% | "
              f"params: {summary['num_params']:,} | "
              f"devices: {summary['num_devices']} | log: "
              f"{summary['log_file']}")
    return summary


if __name__ == "__main__":
    main()
