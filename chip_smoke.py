#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (vit_rpe_rope_tpu_torch).

  python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc;
exits nonzero without a card, or when any phase fails. Phases:

1. the card (nvidia-smi name and power limit), versions, the build of the
   kernels (attn_fwd.cu, attn_bwd.cu, attn_stream_fwd.cu,
   attn_stream_bwd.cu, attn_stream_bwd_fused.cu, adamw.cu, block_fused.cu;
   one nvcc each, in parallel) with each instance's registers and spills
   (row 12 may not spill);
2. the attention kernel against its plain PyTorch twin on the card, in five
   PE regimes (none, poly bias, rel bias, rope-axial, rope-mixed), f32 and
   bf16 inputs, at the ViT-S/16@224 shape (N=197, D=64) and the
   ViT-tiny/4 CIFAR shape (N=65, D=32), both on the resident route (one
   CTA per batch and head), and on the wide route at (2, 1, 640, 64), each
   case's route read from the route counts;
3. the serving path at full width: a seeded ViT-S/16@224 rope-mixed
   checkpoint through the predict CLI (256 uint8 32x32 images, batch 64),
   counting the kernel's launches (every one on the resident route);
   logits against the unfused reference on the card; then the ViT-tiny/4
   CIFAR config in all six PE modes;
4. HTTP: the serve CLI's server on an ephemeral port, three requests;
5. times on the card (CUDA events, medians): the kernel at (64, 6, 197,
   64) and (128, 6, 65, 32), its twin, its bound, the PyTorch SDPA call as
   a yardstick, serving images/s, and a torch.profiler breakdown of the
   ViT-S forward by kernel;
6. the attention backward kernel against its twin (dq, dk, dv, dbias,
   dcos/dsin) in the five regimes, f32 and bf16, at B=64 N=197 D=64 and
   B=128 N=65 D=32 (resident) and at (2, 1, 640, 64) (wide), every case
   launched twice and compared bit for bit; autograd through both kernels
   against autograd through the unfused f32 oracle;
7. the fused AdamW kernel against its twin and, bit for bit, the IEEE
   op-by-op reference: 3 steps on the ViT-S/16 params, then 3 steps whose
   parameters are replaced by new tensors before each, which build the
   device table anew;
8. training at full width through the train CLI (ViT-tiny/4 CIFAR
   defaults, synthetic CIFAR-10, one epoch) in rope-mixed and relative,
   at the CLI's auto steps per dispatch (25 of the 100 steps and 20
   evaluation rows a CUDA-graph replay, after one warm-up step and one
   warm-up forward), counting every kernel's launches (every dense one on
   the resident route); the best checkpoint served by the Predictor
   reproduces the CSV's test accuracy;
9. five train steps on the kernel path against the plain path (unfused
   attention + the AdamW twin) from one init on the same batches;
10. times: a ViT-S/16@224 rope-mixed f32 train step at batch 64 with a
   profiler breakdown (every dense launch on the resident route), and the
   backward kernel at (64, 6, 197, 64) and (128, 6, 65, 32) (with the
   resident kernel's and the slab sum's device times by the profiler) and
   the AdamW kernel against their twins, their bounds and a PyTorch call
   as a yardstick (AdamW: the
   wrapper by CUDA events, the kernel's device time by the profiler, which
   also shows that a step copies nothing between host and device);
11. the streaming kernels (forward with lse, launched twice and compared
   bit for bit, and its prologue's bf16 keys and values bit for bit; dq,
   dk/dv, dbias) against their twins at the twins' own key tile, in six
   regimes (none,
   materialized bias, generated polynomial and relative bias, rope-axial,
   rope-mixed), f32 and bf16, at the long-sequence shape (B=4, H=4,
   N=4097, D=32) and the ViT-S/16@384 shape (B=8, H=6, N=577, D=64), and
   with a bias at that model's training batch (B=16: 16 slabs of ds from
   the dq kernel and the dbias sum kernel); the forward and the rope-mixed
   backward at B=2, H=4, N=16385, D=32; limits as a share of each output's
   largest entry; then dbias at B = 1, 7, 8, 9, 16, N = 577 and 300, f32
   and bf16, within and over a lowered byte budget, launched twice;
11b. the one-pass streaming backward (dq, dk, dv, dcoeff / dtable) against
   its twin in four regimes (none, rope-axial, generated polynomial and
   relative bias), f32 and bf16, at (4, 4, 4097, 32), (16, 6, 577, 64) and
   (2, 4, 16385, 32), every case launched twice and compared bit for bit,
   its prologue (the operands rounded once) against its twin bit for bit;
   in forced 1024-key segments; at global offsets (1000, 2000) against a
   shorter key chunk; the dcoeff and dtable kernels of the separate-pass
   backward against their twin;
12. serving on the streaming route: the long-sequence model (patch 4,
   embed 128, depth 2, 4 heads, 256 px, batch 4) through the predict CLI
   and the Predictor in all six PE modes, logits against the unfused f32
   reference, exact launch counts; ViT-S/16@384 rope-mixed through the
   Predictor at batch 64;
13. training on the streaming route, five steps each, kernel path against
   plain path on the same batches with exact launch counts: the
   long-sequence model in rope-mixed at N=4097, ViT-S/16@384 in relative
   (materialized bias, dbias kernel), the long-sequence model in polynomial
   and in relative (generated bias, the one-pass backward; neither dq nor
   dk/dv launched); direct calls of the separate-pass backward with a
   generated bias (the dcoeff and dtable kernels) against the one-pass
   kernel's parameter gradients; then through the train CLI for one epoch
   of synthetic CIFAR-10 the long-sequence model at depth 1 in rope-mixed
   and in relative (on STREAM_EPOCH_TRAIN examples) and in rope-axial (the
   last two through the one-pass backward; rope-axial must learn, relative
   stays at chance on this task on either path) and ViT-S/16@384 (at depth
   1), each at the CLI's auto k (32 steps and 32 evaluation rows a CUDA
   graph), counting every kernel's launches, the best checkpoint served
   by the Predictor; the rope-mixed and relative epochs also at
   --steps_per_dispatch 1, their CSV rows equal to the graphed ones', and
   each epoch's img/s, capture seconds and peak device memory printed;
14. times: each streaming kernel (the forward's wrapper by CUDA events,
   its kernel and prologue and the backward kernels by the profiler's
   device time), its twin, its bound and SDPA as the yardstick (its
   backward once, against the whole backward wrapper; with a bias, dbias as
   the dq kernel's added time for its ds slabs plus the sum kernel) at the
   two shapes, at N=2048 with a bias (dbias's largest case) and at
   N=16385; the one-pass backward (none, polynomial, relative) beside the
   separate dq + dk/dv passes at the same shapes, its sweep's, prologue's
   and dq sum's device times, the cluster size, its bound and SDPA's
   backward, and on the key chunk of the --q_chunk 2048 epoch, and the
   dcoeff / dtable kernels; train steps
   of the long-sequence model at N=4097 and N=16385 in rope-mixed,
   rope-axial, polynomial and relative, and of ViT-S/16@384; profiler
   breakdowns of the N=4097 steps;
15. bounded-program stepping: the chunk forward kernel (q rows against a
   key chunk at global offsets) against its twin in three regimes (none,
   generated polynomial and relative bias), f32 and bf16, at a small padded
   sequence and at the bounded step's shapes at N=65,537 (every case
   launched twice, bit-identical, one prologue per launch), and at (r0, 0)
   against the rows of the whole-sequence kernel bit for bit; the bounded
   step (q-chunks of 16,384) against the monolithic step at N=65,537 (the
   long-sequence model at 1024 px, batch 1) in rope-axial, polynomial and
   relative, with exact launch counts; key segments of 32,768 against none;
   grad_accum 2 against one batch of 4 at N=4,097; one epoch of the
   long-sequence model (its depth cut from 2 to 1) through the train CLI
   with --q_chunk 2048 in rope-axial, exact launch counts, the best
   checkpoint served; times: the
   chunk wrapper, its kernel and its prologue (device time), its twin, its
   bound and SDPA at (1, 4, 16,384 rows, 66,048 keys, 32) and at the
   --q_chunk 2048 epoch's (4, 4, 2,048 rows, 4,608 keys, 32), the bounded
   and monolithic steps at N=65,537 and a profiler breakdown of the
   bounded step; at N=4,097 in rope-axial (batch 4) the
   bounded and the monolithic step's gradients against the unfused f32
   oracle and each other, and the chunk forward on q, k rotated in PyTorch
   against the whole-sequence forward rotating in the kernel, bit for bit;
16. the block-level paths: the fused block kernel (block_fused.cu, row 12;
   an image's rows over a thread-block cluster, block_fused.block_plan)
   against its twin at ViT-tiny/4 (batch 128, one CTA an image) and
   ViT-S/16@224 (batch 64, a cluster of CTAs an image), f32 and bf16, and at
   the CPU tests' shape, in none and rope-axial, and at ViT-tiny/4 with
   rope-mixed's per-head tables (head 0's for every head, as in the JAX
   package), every case launched twice and compared bit for bit, its
   weight prologue against its twin bit for bit; a 6-block forward at
   ViT-tiny/4 (none, rope-axial) and a 12-block ViT-S/16@224 forward
   (none) timed for the wrapper (exactly one kernel and one prologue launch
   a block) beside the kernel's and the prologue's device times, the per-op
   block, the twin, torch.nn.TransformerEncoderLayer (none) and the bound;
   attention_impl="flash_block" against "flash" gradients at ViT-tiny/4
   rope-mixed (N=65) and the long-sequence model in rope-axial (N=4,097);
   one epoch each through the train CLI of ViT-tiny/4 rope-mixed with
   --attention_impl flash_block, with the default flash, and with
   --num_heads 4 (head dim 48, padded to 64 in the kernels), exact launch
   counts and the learning bar; five
   train steps of the long-sequence model at polynomial degree 8 (nine
   terms) against the plain path;
17. regularised training and the visualizers: the ViT-tiny/4 train CLI at
   its defaults (rope-mixed) with --drop_rate 0.1 --drop_path_rate 0.1
   --augment, twice with seed 0 (the same CSV row) and once with seed 1
   (another), each at the auto k with its draws inside the CUDA graph,
   launching the attention kernels and AdamW exactly as phase 8's
   unregularised epoch, its epoch img/s beside that one's; then
   with --attn_drop_rate 0.1 too (train steps on the unfused attention,
   evaluation on attn_fwd); both visualizer CLIs in a scratch directory
   whose checkpoints/ holds the regularised checkpoint and phase 8's
   relative one exported to .pth (auto-discovery, --load_model,
   --compare_models, --compare_thetas): each mode's figures (figures(args):
   every similarity and FFT matrix) computed on the card against the CPU's,
   and drawn to PNGs where matplotlib is installed; the exported .pth
   through the Predictor against its .npz.
18. the k-step driver, remat, --debug_nans, --profile_dir and the C++
   decoders: (a) the ViT-tiny/4 train CLI at its defaults (rope-mixed, 100
   steps of 128) with --steps_per_dispatch 1 and 4 beside phase 8's auto
   epoch, and the regularised epoch at 1 beside phase 17's auto one:
   each epoch's img/s, the CUDA graphs' capture times, exact launches (one
   replay a dispatch of k captured steps after one warm-up step, AdamW
   through its device-table entry) and the CSV rows held equal bit for
   bit; phase 8's checkpoint evaluated one row a call and 20 rows a CUDA
   graph, the metrics bit-equal and equal to the CSV's; the AdamW
   table entry against the IEEE op-by-op reference bit for bit (3 live
   steps, 1 not live) and its times; (b) remat off, full, dots and softmax
   at ViT-S/16@224 rope-mixed f32 batch 64 and at the long-sequence model
   at N = 16,385 rope-axial batch 2: a train step's time, the peak memory
   of a forward and backward (below remat off's under full and dots, at
   most remat off's under softmax), the attention launches (the forward
   twice under full and dots, once under softmax, which keeps the
   kernels' outputs as JAX's policy keeps pallas_call's) and the
   gradients bit-equal to remat off's; (c) a poisoned run
   under --debug_nans raises FloatingPointError, a clean one repeats its
   row; (d) --profile_dir writes a Chrome trace naming the kernels; (e)
   IDX and CIFAR files decoded by the C++ library (or numpy where it
   cannot be built; the decoder that ran is printed) equal to numpy's.
19. int8 serving and serving artifacts: (a) phase 3's seeded ViT-S/16@224
   rope-mixed checkpoint through the predict CLI with --int8 in each mode
   (w8a8, w8a8-static calibrated with --calib on 64 of the images, w8a16),
   256 images at batch 64: exact attn_fwd launches (12 a batch, and 12 for
   the calibration forward; all resident) and torch._int_mm calls (50 a
   batch; none in w8a16, counted in quant.LAUNCHES_INT_MM), every int8
   product against the CPU's on the card's own inputs (bit for bit; w8a16
   within one bf16 rounding), the logits against the CPU's forward and the
   card's float32 logits; (b) phase 8's trained ViT-tiny/4 rope-mixed and
   relative checkpoints: int8 top-1 agreement with float32 on 256 test
   images at least 95% in every mode; (c) the long-sequence model at N =
   4,097 in rope-axial, batch 4, w8a16 (bf16 q, k, v) through the
   Predictor: one streaming forward and prologue a block, logits close to
   float32, the forward and the streaming wrapper timed in bf16 against
   f32, the model exported on the card and replayed bit for bit; (d)
   ViT-S/16@224 exported on the card in float32 and w8a8 (torch.export,
   symbolic batch), saved, loaded in a fresh process that imports only
   vit_rpe_rope_tpu_torch.serving and replayed at batches 64 and 37,
   bit-equal to the live Predictors with 12 attn_fwd launches a replay;
   (e) device forward times at batch 64 of float32, the three int8 modes
   and the float32 artifact, and one int8 product at the fc1 shape
   (12,608 x 384 x 1,536) against float32 and bf16 torch.matmul.
20. data parallelism, ZeRO-1 and antialiased downsampling: (a) the ViT-tiny/4
   train CLI at its defaults for one epoch, plainly and then under
   torchrun's variables at world size 1 (an NCCL group of this process)
   without and with --zero1, and with --zero1 --steps_per_dispatch 4 (its
   one slice through AdamW's device-table entry in the CUDA graph): the CSV
   row and every array of `_last.npz` bit-equal to the plain run's, the
   launches, each step time; (b)
   the same epoch on two ranks that share the card over gloo
   (--dist_backend gloo), each a process of its own, plain and with
   --zero1: the ranks' final params bit-equal, ZeRO-1's equal to plain
   data parallelism's, rank 0's first DP_EARLY_STEPS step losses within
   DP_STEP_TOL of the one-rank run's and its row past the learning bar,
   one CSV, each rank's launches of rows 1, 2 and 11 (the attention at the
   half batch of 64, AdamW once a step); (c) the epoch
   with --img_size 16 on the 32 px images (the antialiased resize), exact
   launches, the learning bar, the best checkpoint served to its CSV
   accuracy, make_preprocess on the card against the CPU; (d) the
   Predictor over make_mesh(num_devices=1) bit-equal to the one-device
   Predictor, and --export_data_parallel 2 through the predict CLI exiting
   with "only 1 devices visible" on a one-card machine.
21. tensor parallelism: (a) the same epoch on two gloo ranks that share
   the card with --model_parallel 2 (each rank 3 of the 6 heads and half
   of the MLP rows; Megatron's f and g all-reduced over gloo): the
   replicated params bit-equal on both ranks, rank 0's first
   DP_EARLY_STEPS step losses within DP_STEP_TOL of the one-rank run's
   (phase 20a), its row past the learning bar, one CSV, each rank's
   launches of rows 1, 2 and 11 (the attention at 3 heads in training, at
   6 in evaluation on the params gathered back), each rank's step time
   beside one rank's; (b) the relative epoch on TP_B_TRAIN examples on
   four gloo ranks, data 2 x model 2, with --zero1 (the bias sliced to a
   rank's heads; ZeRO-1 over each model shard's flat vector): the
   replicated params bit-equal on all four, each shard equal on its two
   data ranks, the early step losses against a one-rank epoch of the same
   data in this process, the launches at batch 64; (c) the long-sequence
   model (N = 4,097, 4 heads, batch 4) in rope-mixed and relative on the
   same four ranks in the same launch, TP_STREAM_TRAIN examples: the
   streaming route at 2 heads a rank (model rank 1's per-head rope tables
   and relative table at a non-zero offset) through rows 3, 5, 6 and 7
   and their prologues, evaluation at 4 heads on the gathered params, held
   as (b) to a one-rank epoch of the same data. (b), (c), 23 (b) and 24
   (a), (b) are the runs of one four-rank launch, made here, and 20 (b),
   21 (a), 22 (b)-(d) and 23 (a), (c) the runs of one two-rank launch,
   made in phase 20 (shared_launch: a process's start-up and first calls
   paid once a world size).
22. context parallelism: (a) whether gloo's send / recv move CUDA tensors
   (the ring hop stages them through the host under gloo either way); the
   kernel ring at R = 2 on two gloo ranks sharing the card at (4, 4, 4,097,
   32) in none, relative, polynomial and rope-mixed (q and k rotated
   before the ring), and on 4,096 tokens of which 1,948 are valid (the
   second shard padding only: a hop over a key chunk masked whole):
   out, lse, dq, dk, dv and the bias parameters' gradient summed over the
   ranks against the one-device kernels (the chunk entries at (0, 0) over
   every key) within CP_RING_TOL and against the plain float32 ring within
   CP_PLAIN_TOL, every value finite, a second pass bit-equal to the first
   (and timed: the ring's forward and backward beside the one-device
   kernels'), two chunk forwards and two one-pass backwards a rank and
   call; (b) the long-sequence model at depth 1
   (N = 4,097, batch 4) through the train CLI on two gloo ranks with
   --sequence_parallel 2 in rope-mixed and relative, on CP_TRAIN examples:
   the params bit-equal on both ranks, the launches of rows 4, 5 and 11
   exact, one CSV, each of the six step losses within CP_STEP_TOL of a
   one-rank epoch of the same data; (c) rope-mixed with --zero1, bit-equal
   to (b); (d) rope-axial with --q_chunk 2048 (the bounded driver's ring:
   q-chunks of 2,048 and 512 rows a rank, two hops each), held as (b);
   (e) the bounded step with force_ring on a process group of one rank
   over NCCL against the plain bounded step, bit for bit.
23. pipeline parallelism (GPipe stages, the hop staged through the host
   under gloo): (a) the ViT-tiny/4 train CLI at its defaults on
   PP_TRAIN examples on two gloo ranks sharing the card with
   --pipeline_parallel 2 --pp_microbatches PP_MICRO (3 blocks a stage,
   the attention at the microbatch of 32 in training and at 128 in
   evaluation on the params gathered back): each rank's launches of rows
   1, 2 and 11 exact (bubble ticks launch nothing), its stage's blocks
   alone, the replicated params bit-equal on both ranks, rank 0's first
   DP_EARLY_STEPS step losses within DP_STEP_TOL of a one-rank epoch of
   the same data in this process, one CSV, each rank's step time beside
   one rank's; rank 0's `_last.npz` in the reference layout resumed at
   world size 1; (c) the long-sequence model at depth 2 (N = 4,097, batch
   4, 2 microbatches) in relative in the same launch on PP_STREAM_TRAIN
   examples: rows 3 and 5 (the generated bias) and their prologues,
   held as (a); (b) the relative epoch of (a)'s data on four gloo ranks
   with --pipeline_parallel 2 --model_parallel 2 (3 heads a rank, the
   bias sliced; block shards distinct on all four ranks, the relative
   table bit-equal), held as (a).
24. the compositions with the sequence axis, on four gloo ranks sharing the
   card (runs of phase 21's four-rank launch): (a) the long-sequence model
   at depth 1 (N = 4,097, 4 heads, batch 4) through the train CLI with
   --sequence_parallel 2 --model_parallel 2 (TP x CP: 2 heads and 2,049
   query rows a rank) in rope-mixed and relative, and (b) at depth 2 in
   relative with --pipeline_parallel 2 --sequence_parallel 2 (PP x CP: one
   block a stage, 2 microbatches of 2), each on COMP_TRAIN examples: each
   rank's launches of rows 4, 5 and 11 exact (the evaluation runs the
   composed forward; bubble ticks launch nothing), the chunk kernels at the
   rank's heads, images and rows, the replicated params bit-equal on all
   four ranks and the block shards equal exactly within a ring, rank 0's
   first DP_EARLY_STEPS step losses within CP_STEP_TOL of a one-rank epoch
   of the same data in this process, one CSV, each rank's step time beside
   one rank's; (c) the trajectory-parity harness's port side
   (utils/trajectory_parity.train_port at its defaults) for COMP_TRAJ_STEPS
   steps on the card against the same steps on the CPU: each loss within
   COMP_TRAJ_TOL (relative), AdamW (row 11) once a step.
25. bf16 training under remat, the JAX package's remat configuration at
   full width: (a) ViT-S/16@224 rope-mixed at batch 64 with dropout and
   drop-path 0.1, in f32 and in bf16, under remat off, full, dots and
   softmax, the masks drawn from one seed: per dtype the phase 18b checks
   (launches, gradients bit-equal to remat off's, peak memory), each bf16
   loss within BF16_LOSS_TOL of the f32 one, a train step's time; (b) one
   epoch of the train CLI at that width with --compute_dtype bfloat16
   --remat --drop_path_rate 0.1 per policy on BF16_CLI_TRAIN synthetic
   examples, at the CLI's auto k (16: one CUDA graph of 16 steps that
   draw, captured once, no eager notice on stdout) and at
   --steps_per_dispatch 1: the CSV rows bit-equal, exact launches.

The line before the last is a JSON object {"kernels": [...]}; the last is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import importlib.util
import io
import json
import math
import os
import shutil
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
# The long-sequence model (N=4097, batch 4) learns the task within an epoch
# in rope-axial and rope-mixed (test accuracy above 99% on an H100) and stays
# at chance in relative and polynomial, on the kernel path and on the
# unfused path alike, at learning rates from 1e-4 to 1e-3: 4,096 table
# entries, or a bias that sees distances only, carry too little about WHERE
# the blob lies. So of the one-pass backward's modes rope-axial is held to a
# bar; the relative epoch is held to its launch counts, a finite CSV and the
# served accuracy, and the five-step comparison with the plain path holds
# its gradients.
LEARN_BAR = {"rope-mixed": {"train_loss": math.log(10), "test_acc": 90.0},
             "rope-axial": {"train_loss": math.log(10), "test_acc": 90.0},
             "relative": {"test_loss": math.log(10), "test_acc": 12.0}}
STREAM_PASSES = ("attn_stream_bwd_prologue", "attn_stream_bwd_dq",
                 "attn_stream_bwd_dkv")
VIT_S = dict(img_size=224, patch_size=16, embed_dim=384, depth=12,
             num_heads=6)
VIT_S_384 = dict(VIT_S, img_size=384)  # N=577: the dense tiles do not fit
# The JAX package's long-sequence model (scripts/bench_longseq.py): N=4097
# at 256 px (batch 4), N=16385 at 512 px (batch 2).
LONGSEQ = dict(img_size=256, patch_size=4, embed_dim=128, depth=2, num_heads=4)
STREAM_EPOCH_TRAIN = 2560  # phase 13's rope-mixed and relative epochs of the
#   long-sequence model: 640 steps of 4 (the CLI's whole set, 12,800, for
#   rope-axial, which must learn)
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
# One-pass backward vs its twin, dq / dk / dv as a share of the output's
# largest entry. p = exp(s - lse) needs no running max, so the twin's tiles
# (FUSED_TWIN_TILES) only reorder float32 sums; what is left are bf16
# roundings of p and ds that flip after a last-ulp difference, as for the
# separate passes. The outputs are float32 for bf16 inputs too, so both
# dtypes share the separate passes' float32 limit.
FUSED_TOL = 4e-3
# dcoeff / dtable vs the twin, as a share of the gradient's largest entry:
# float32 sums of ds over up to B*N*N elements that nearly cancel (every
# unmasked row of ds sums to zero), taken in another order.
PARAM_TOL = 1e-3
# The separate passes' prologue vs its twin: the operands (q and k rotated
# op by op in float32, every operand rounded to bf16) bit for bit; delta, a
# float32 sum of D products taken in another order, as a share of its
# largest entry.
PROLOGUE_DELTA_TOL = 1e-5
FUSED_REGIMES = ("none", "rope-axial", "poly", "rel")
FUSED_TWIN_TILES = dict(q_tile=1024, kv_tile=512)
# The bounded train step (phase 15): the long-sequence model at N=65,537
# (1024 px, batch 1, f32; scripts/bench_longseq.py's CONFIGS[65537]) in
# q-chunks of 16,384 rows (n_pad 66,048: four chunks of 16,384 and one of
# 512).
BOUNDED = dict(LONGSEQ, img_size=1024)
BOUNDED_Q_CHUNK = 16384
# Bounded step vs the monolithic step on the same batch and init, both with
# bf16 products: the loss, relative; every gradient as a share of its
# largest entry. The chunk forward computes each valid row as the
# whole-sequence forward does; what differs is the float32 order of the
# backward's sums (key segments of 8,192 per q-chunk against 1,984 over the
# whole sequence), the compute-dtype rounding of the chunk partials, and
# the padded shapes of the O(N) matmuls.
BOUNDED_LOSS_TOL = 1e-4
BOUNDED_GRAD_TOL = 5e-3
# The epoch through the train CLI with --q_chunk 2048 runs at half the CLI's
# learning rate. At lr 1e-3, batch 4 (a constant rate: the cosine steps per
# epoch) the long-sequence rope-axial model trains at the edge of stability
# on this task: a late loss spike ended the bounded epoch at 89.57% test
# accuracy with seed 0, 96.99% with seed 1 and 100.00% with seed 2, the
# monolithic epoch at 99.92% (seed 0) and 100.00% (seed 1); at lr 5e-4 both
# reach 100.00% with seed 0 (scripts/torch_bounded_epochs.py on an H100).
BOUNDED_EPOCH_LR = 5e-4

# Row 12 (phase 16), the fused block forward against its twin on the card,
# as a share of the largest entry of the block's update (output - x), with
# every weight moved off its init so that the attention is far from
# uniform. Same rounding points; an LN output, q, k, p, o or GELU value
# that rounds to the other bf16 neighbour after a last-ulp float32
# difference (sums in another order, rsqrt, exp) moves the update by a
# fraction of a bf16 ulp of its largest entries: 2.70e-3 (none) and
# 1.27e-3 (rope-axial) at ViT-tiny/4, 2.78e-3 / 2.81e-3 at ViT-S/16@224,
# f32, on an H100. A bf16 output is held to the same limit beyond one bf16
# ulp of each entry. A kernel without the key mask misses it by 2.35e-2 /
# 2.92e-2 at ViT-tiny/4 and 7.40e-3 / 7.12e-3 at ViT-S/16@224, one without
# the rotation by 1.35e-1 / 4.45e-1, one that reads only its own CTA's
# keys by 5.1e-1 (scripts/torch_block_mutants.py), so the limit sits below
# the weakest of those and within twice the seen error.
BLOCK_FUSED_TOL = 5e-3
# The blocks of row 12's timed forward: ViT-tiny/4's depth.
BLOCK_DEPTH = 6
# flash_block against flash on the kernels, as the norm of the difference
# over the norm of each gradient: the JAX package's bound for its own
# flash_block (the same attention kernels; float32 sums in another order
# in the rest of the block).
FLASH_BLOCK_TOL = 2e-3
# Phase 17, path B: the ViT-tiny/4 train CLI at its defaults (rope-mixed)
# with the JAX README's regularisation and the augmentation.
REGULARISED = {"drop_rate": 0.1, "drop_path_rate": 0.1, "augment": True}
# What a regularised epoch must reach: a finite CSV, an epoch-mean train
# loss below ln 10 and a test accuracy of four times chance. Not
# LEARN_BAR's 90%: the random horizontal flip maps the synthetic task's
# blob columns 0.25 and 0.75 onto each other, so six of its ten classes
# pair up and a model that learned the flipped task can tell a pair apart
# on the (unflipped) test images no better than by a coin: about 70% is
# the most one epoch can reach.
REGULARISED_BAR = {"train_loss": math.log(10), "test_acc": 40.0}
# Phase 17, path A: each matrix of a visualizer's figures computed on the
# card against the same one computed on the CPU, absolute. The biases and
# the cos/sin tables are float32 on both (cosf / sinf within a few ulps of
# each other); the float64 cosine similarity, the normalisation and the FFT
# then run in numpy on both, so an entry (at most ~4 in magnitude, the log
# spectrum) differs by a few float32 ulps at most.
VIZ_TOL = 1e-5


def log(*args):
    print(*args, flush=True)


@contextlib.contextmanager
def phase(name, seconds):
    log(name)
    t0 = time.perf_counter()
    yield
    seconds[name.split()[0]] = time.perf_counter() - t0
    log(f"    ({seconds[name.split()[0]]:.1f} s)")


def demangle(names):
    """C++ names of the mangled kernel names (as they are without c++filt),
    without the anonymous namespace and the parameter list."""
    if shutil.which("c++filt") is None:
        return names
    out = subprocess.run(["c++filt"], input="\n".join(names),
                         capture_output=True, text=True).stdout.splitlines()
    return [name.replace("(anonymous namespace)::", "").split("(")[0]
            for name in out] if len(out) == len(names) else names


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


# A dense shape past the resident kernels' 13 blocks of 16 rows (H=1 keeps
# N=640 within _dense_attn_fits): the wide kernels, held to the same twins.
WIDE_SHAPE = (2, 1, 640, 64)


def dense_cases():
    """(shape, dtype, regime, seed, route) of phases 2 and 6: the slice
    shapes on the resident route in every regime and dtype, WIDE_SHAPE on
    the wide route in rope-mixed and rel, f32."""
    cases = [(shape, dtype, regime, i, "resident")
             for shape in ((8, 6, 197, 64), (8, 6, 65, 32))
             for dtype in (torch.float32, torch.bfloat16)
             for i, regime in enumerate(REGIMES)]
    return cases + [(WIDE_SHAPE, torch.float32, regime, 10 + i, "wide")
                    for i, regime in enumerate(("rope-mixed", "rel"))]


def route_launches(fa, route, backward=False):
    if route == "resident":
        return fa.LAUNCHES_BWD_RESIDENT if backward else fa.LAUNCHES_RESIDENT
    return fa.LAUNCHES_BWD_WIDE if backward else fa.LAUNCHES_WIDE


def check_kernel_vs_twin(fa, device):
    """Phase 2. Returns the worst max |kernel - twin| at the slice shape."""
    worst_slice = 0.0
    for shape, dtype, regime, i, route in dense_cases():
        q, k, v, kw = attn_inputs(regime, shape, dtype, 100 + i, device)
        bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
        scale = shape[-1] ** -0.5
        before = route_launches(fa, route)
        got = fa.flash_attention(q, k, v, scale, **kw)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, scale, bias, cos, sin)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        tol = KERNEL_TOL[dtype]
        ok = bool((err <= tol + tol * want.float().abs()).all())
        max_err = float(err.max())
        log(f"kernel vs twin  {route:8s} B={shape[0]} H={shape[1]} "
            f"N={shape[2]} D={shape[3]} {str(dtype)[6:]:8s} {regime:10s} "
            f"max_abs_err={max_err:.3e} tol={tol:g}(abs+rel) "
            f"{'ok' if ok else 'FAIL'}")
        if route_launches(fa, route) != before + 1:
            raise AssertionError(f"{shape} did not take the {route} route")
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
    fa.LAUNCHES = fa.LAUNCHES_BWD = fa.LAUNCHES_STREAM_FWD = 0
    fa.LAUNCHES_STREAM_FWD_PROLOGUE = 0
    reset_routes(fa)
    t0 = time.perf_counter()
    preds = predict.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {"attn_fwd": fa.LAUNCHES,
              "attn_stream_fwd": fa.LAUNCHES_STREAM_FWD}
    if fa.LAUNCHES_STREAM_FWD_PROLOGUE:
        counts["attn_stream_fwd_prologue"] = fa.LAUNCHES_STREAM_FWD_PROLOGUE
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


# Shapes of the dense kernels' timings (phases 5a and 10b): ViT-S/16@224's
# serving and training batch and the ViT-tiny/4 train CLI's batch.
DENSE_TIMED = (("", (64, 6, 197, 64)), ("vit-tiny/4 ", (128, 6, 65, 32)))


def time_attention(fa, device):
    """Phase 5a: the kernel at the serving slice shape (B=64, H=6, N=197,
    D=64) and at ViT-tiny/4's (128, 6, 65, 32) against its twin and against
    PyTorch SDPA on pre-rotated q/k."""
    import torch.nn.functional as F

    rows = {}
    cases = [(prefix + label, shape, regime, dtype)
             for prefix, shape in DENSE_TIMED
             for label, regime, dtype in (
                 ("rope-mixed f32", "rope-mixed", torch.float32),
                 ("rope-mixed bf16", "rope-mixed", torch.bfloat16),
                 ("rel-bias f32", "rel", torch.float32))
             if not (prefix and dtype == torch.bfloat16)]
    for label, shape, regime, dtype in cases:
        scale = shape[-1] ** -0.5
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
                           bound_by=bound_by, shape=list(shape))
        log(f"  attention {label:27s} kernel {kernel_ms:.4f} ms  twin "
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
        u8 = torch.from_numpy(batch).to(pred.device)
        fwd_ms = median_ms(lambda: pred.forward(u8), iters=5, reps=5,
                           warmup=2)
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

    u8 = torch.from_numpy(images[:64]).to(predictor.device)
    predictor.forward(u8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_iter):
            predictor.forward(u8)
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
    again = fa.attention_bwd(*args, want_dbias=bias is not None,
                             want_drot=want_drot)
    torch.cuda.synchronize()
    want = fa.attention_bwd_plain(*args, want_dbias=bias is not None,
                                  want_drot=want_drot)
    tol = BWD_TOL[dtype]
    res = {name: worst_err(x, y, tol)
           for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3])}
    same = all(torch.equal(x, y) for x, y in zip(got, again)
               if x is not None)
    res["two launches"] = (0.0 if same else 1.0, same)
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
    """Phase 6a, over dense_cases() at the training batches (B=64 at N=197,
    B=128 at N=65): every case launched twice, bit-identical. Returns the
    worst dq/dk/dv error at the slice shape, f32."""
    worst_slice = 0.0
    batch = {197: 64, 65: 128}
    for shape, dtype, regime, i, route in dense_cases():
        shape = (batch.get(shape[2], shape[0]),) + shape[1:]
        before = route_launches(fa, route, backward=True)
        res = bwd_case(fa, regime, shape, dtype, 200 + i, device)
        ok = all(r[1] for r in res.values())
        log(f"bwd vs twin  {route:8s} B={shape[0]} H={shape[1]} "
            f"N={shape[2]} D={shape[3]} {str(dtype)[6:]:8s} {regime:10s} "
            + " ".join(f"{k}={v[0]:.2e}" for k, v in res.items())
            + f" tol={BWD_TOL[dtype]:g} {'ok' if ok else 'FAIL'}")
        if route_launches(fa, route, backward=True) != before + 2:
            raise AssertionError(f"{shape} did not take the {route} route")
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


def adamw_exact_step(fused_adamw):
    """A `step` for make_fused_adamw that applies the IEEE op-by-op
    reference (fused_adamw.adamw_exact) in place."""
    def step(params, grads, mus, nus, *hyper):
        new = fused_adamw.adamw_exact(params, grads, mus, nus, *hyper)
        for old_list, new_list in zip((params, mus, nus), new):
            for old, x in zip(old_list, new_list):
                old.copy_(x)
    return step


def adamw_steps(fused_adamw, params, gen, steps=3, replace=False):
    """`steps` AdamW steps on the same gradients of the kernel on `params`,
    of its twin and of the IEEE op-by-op reference on copies; with
    `replace`, the kernel's parameters are handed over as new tensors before
    every step (as a resumed run hands them over). Returns {path: (params,
    mu, nu)} and the device tables built."""
    schedule = lambda step: 1e-3 * (0.9 ** step)  # noqa: E731
    fused_adamw._TABLES.clear()  # freed storages of earlier runs may recur
    builds = fused_adamw.TABLE_BUILDS
    paths = {}
    for name, step in (("kernel", fused_adamw.adamw_update),
                       ("twin", fused_adamw.adamw_plain),
                       ("exact", adamw_exact_step(fused_adamw))):
        paths[name] = [{k: v.clone() for k, v in params.items()}]
        init, update = fused_adamw.make_fused_adamw(
            params, schedule, weight_decay=0.05, step=step)
        paths[name].append(init(paths[name][0]))
        paths[name].append(update)
    handed_over = []  # kept alive, so that no new tensor reuses a storage
    for _ in range(steps):
        grads = {k: torch.randn(v.shape, generator=gen).to(v.device)
                 for k, v in params.items()}
        for name, (p, state, update) in paths.items():
            if replace and name == "kernel":
                handed_over.append(p)
                p = {k: v.clone() for k, v in p.items()}
            paths[name][:2] = update(grads, state, p)
    torch.cuda.synchronize()
    return ({name: (p, state[0], state[1]) for name, (p, state, _)
             in paths.items()}, fused_adamw.TABLE_BUILDS - builds)


def check_adamw(fused_adamw, vit, cfg, device):
    """Phase 7: 3 AdamW steps on the ViT-S params, each launching one
    kernel and the device table built once; then 3 steps whose parameters
    are replaced by new tensors before every step, which build the table
    anew each time. The kernel must equal the IEEE op-by-op reference
    (fused_adamw.adamw_exact) bit for bit, and its twin to ADAMW_TOL (the
    twin divides by a Python scalar as a product with the reciprocal on
    CUDA). Returns the worst error against the twin over params and
    moments."""
    gen = torch.Generator().manual_seed(21)
    params = vit.init_params(gen, cfg, device=device)
    worst, ok = 0.0, True
    for label, replace, builds_expected in (("same tensors", False, 1),
                                            ("replaced tensors", True, 3)):
        fused_adamw.LAUNCHES_ADAMW = 0
        paths, builds = adamw_steps(fused_adamw, params, gen, replace=replace)
        launches = fused_adamw.LAUNCHES_ADAMW
        case_worst, case_ok, exact, twin_bitwise = 0.0, True, True, True
        for got, twin, ref in zip(paths["kernel"], paths["twin"],
                                  paths["exact"]):
            for key in got:
                err, good = worst_err(got[key], twin[key], ADAMW_TOL)
                case_worst, case_ok = max(case_worst, err), case_ok and good
                exact = exact and torch.equal(got[key], ref[key])
                twin_bitwise = twin_bitwise and torch.equal(got[key],
                                                            twin[key])
        case_ok = case_ok and exact and launches == 3 and \
            builds == builds_expected
        log(f"  AdamW kernel vs twin ({label}): "
            f"{vit.num_params(paths['kernel'][0]):,} params, 3 steps, wd "
            f"0.05: max_abs_err={case_worst:.3e} (tol {ADAMW_TOL:g} abs+rel; "
            f"bit-identical to the twin {twin_bitwise}), bit-identical to "
            f"the IEEE op-by-op reference {exact}, launches {launches}, "
            f"device tables built {builds} (expected {builds_expected}) "
            f"{'ok' if case_ok else 'FAIL'}")
        worst, ok = max(worst, case_worst), ok and case_ok
    if not ok:
        raise AssertionError("AdamW kernel disagrees with its twin or its "
                             "IEEE reference")
    return worst


def reset_counts(fa, fused_adamw):
    fa.LAUNCHES = fa.LAUNCHES_BWD = fused_adamw.LAUNCHES_ADAMW = 0
    fused_adamw.LAUNCHES_ADAMW_TABLE = 0
    reset_routes(fa)
    fa.LAUNCHES_STREAM_FWD = fa.LAUNCHES_STREAM_DQ = 0
    fa.LAUNCHES_STREAM_DKV = fa.LAUNCHES_STREAM_DBIAS = 0
    fa.LAUNCHES_STREAM_PROLOGUE = 0
    fa.LAUNCHES_STREAM_FUSED = fa.LAUNCHES_STREAM_DCOEFF = 0
    fa.LAUNCHES_STREAM_DTABLE = fa.LAUNCHES_STREAM_CHUNK_FWD = 0
    fa.LAUNCHES_STREAM_FWD_PROLOGUE = fa.LAUNCHES_STREAM_FUSED_PROLOGUE = 0


def reset_routes(fa):
    fa.LAUNCHES_RESIDENT = fa.LAUNCHES_WIDE = 0
    fa.LAUNCHES_BWD_RESIDENT = fa.LAUNCHES_BWD_WIDE = 0


def check_resident(fa, label):
    """Every dense launch since the route counts were reset took the
    resident kernels: the route counts add up to the wrappers' counts
    (LAUNCHES / LAUNCHES_BWD, reset with them) and the wide ones are 0.
    Returns the route counts."""
    torch.cuda.synchronize()
    routes = {"resident": fa.LAUNCHES_RESIDENT, "wide": fa.LAUNCHES_WIDE,
              "bwd_resident": fa.LAUNCHES_BWD_RESIDENT,
              "bwd_wide": fa.LAUNCHES_BWD_WIDE}
    log(f"    dense routes {label}: {routes}")
    if (routes["wide"] or routes["bwd_wide"]
            or routes["resident"] != fa.LAUNCHES
            or routes["bwd_resident"] != fa.LAUNCHES_BWD):
        raise AssertionError(f"{label}: a dense launch left the resident "
                             f"route: {routes}, wrappers {fa.LAUNCHES} / "
                             f"{fa.LAUNCHES_BWD}")
    return routes


def read_counts(fa, fused_adamw):
    """Launches since reset_counts; the streaming kernels only where one
    was launched (the dense paths' expectations name the dense kernels)."""
    torch.cuda.synchronize()
    counts = {"attn_fwd": fa.LAUNCHES, "attn_bwd": fa.LAUNCHES_BWD,
              "adamw": fused_adamw.LAUNCHES_ADAMW}
    if fused_adamw.LAUNCHES_ADAMW_TABLE:
        counts["adamw_table"] = fused_adamw.LAUNCHES_ADAMW_TABLE
    stream = {"attn_stream_fwd": fa.LAUNCHES_STREAM_FWD,
              "attn_stream_chunk_fwd": fa.LAUNCHES_STREAM_CHUNK_FWD,
              "attn_stream_fwd_prologue": fa.LAUNCHES_STREAM_FWD_PROLOGUE,
              "attn_stream_bwd_prologue": fa.LAUNCHES_STREAM_PROLOGUE,
              "attn_stream_bwd_dq": fa.LAUNCHES_STREAM_DQ,
              "attn_stream_bwd_dkv": fa.LAUNCHES_STREAM_DKV,
              "attn_stream_bwd_dbias": fa.LAUNCHES_STREAM_DBIAS,
              "attn_stream_bwd_fused": fa.LAUNCHES_STREAM_FUSED,
              "attn_stream_bwd_fused_prologue":
                  fa.LAUNCHES_STREAM_FUSED_PROLOGUE,
              "attn_stream_bwd_dcoeff": fa.LAUNCHES_STREAM_DCOEFF,
              "attn_stream_bwd_dtable": fa.LAUNCHES_STREAM_DTABLE}
    counts.update({k: v for k, v in stream.items() if v})
    return counts


def with_prologues(expected):
    """expected launch counts with the streaming prologues: the forward's
    before every whole-sequence and every chunk forward, the one-pass
    backward's before every one-pass launch."""
    expected = dict(expected)
    n = (expected.get("attn_stream_fwd", 0)
         + expected.get("attn_stream_chunk_fwd", 0))
    if n:
        expected["attn_stream_fwd_prologue"] = n
    if expected.get("attn_stream_bwd_fused"):
        expected["attn_stream_bwd_fused_prologue"] = expected[
            "attn_stream_bwd_fused"]
    return expected


def bounded_launches(fa, batch, heads, head_dim, n, q_chunk, kv_chunk=0):
    """(chunk forwards, one-pass backward launches) of one block of the
    bounded step at N=n: one forward per q-chunk, and per (q-chunk, key
    segment) pair as many backward launches as _fused_kv_seg_cols cuts its
    keys into."""
    n_pad = fa._round_up(n, 512)
    q_chunk = fa._round_up(q_chunk, 512)
    rows = [min(q_chunk, n_pad - s) for s in range(0, n_pad, q_chunk)]
    kv_chunk = fa._round_up(kv_chunk, 512) if kv_chunk else n_pad
    cols = [min(kv_chunk, n_pad - c) for c in range(0, n_pad, kv_chunk)]
    return len(rows), sum(
        -(-width // fa._fused_kv_seg_cols(batch, heads, r, head_dim))
        for r in rows for width in cols)


def train_through_cli(pe_name, modules, model=None, batch=128, bar=None,
                      q_chunk=None, lr=None, flags=None, keep=None,
                      n_train=12800):
    """Phases 8, 13, 15, 17 and 18 for one PE mode: the train CLI on synthetic
    CIFAR-10 for one epoch (run in a scratch directory, so the default logs/
    and checkpoints/ land there), with every count reset just before and
    read just after; then the best checkpoint through the Predictor. `model`
    is None for the CLI's defaults (ViT-tiny/4, dense kernels, held to
    `bar`, else LEARN_BAR) or the ViTConfig fields of a model on the
    streaming route, which is held to `bar` when one is given. q_chunk:
    train and evaluate through the bounded-program driver (--q_chunk). lr:
    --lr, else the CLI's default. flags: more CLI flags that keep the
    defaults' dense route (--attention_impl flash_block, --num_heads, the
    regularisation flags, --steps_per_dispatch; True for a flag without a
    value; with --attn_drop_rate the train steps run the unfused attention,
    as in the JAX package, and only evaluation launches the forward kernel).
    The steps per dispatch are --steps_per_dispatch, else the CLI's auto
    (the largest divisor of the epoch's steps up to 32 on the card), and
    the evaluation rows per dispatch auto over its rows; both 1 with
    --q_chunk. Where k > 1 each dispatch replays a CUDA graph of k captured
    steps (or evaluation forwards), after one warm-up step (or forward),
    and the run must report the graph's capture seconds. keep: a path the
    best checkpoint is copied to. n_train: the synthetic set's training
    examples (n_train // 5 test images; the CLI's set is 12,800 and
    2,560). Returns the run's times, CSV row, launches, peak device memory
    and the k it took."""
    from vit_rpe_rope_tpu_torch.train import train_step as ts

    fa, fused_adamw, train_cli, serving, datasets = modules
    argv = ["--dataset", "cifar10", "--synthetic", "--epochs", "1",
            "--pos_encoding", pe_name, "--batch_size", str(batch)]
    for key, value in {**(model or {}), **(flags or {})}.items():
        argv += [f"--{key}"] if value is True else [f"--{key}", str(value)]
    if q_chunk:
        argv += ["--q_chunk", str(q_chunk)]
    if lr is not None:
        argv += ["--lr", str(lr)]
    depth = model["depth"] if model else 6
    grid = model["img_size"] // model["patch_size"] if model else None
    heads = (model or flags or {}).get("num_heads", 6)
    serve_bs = 128 if model is None else 64
    n_test = n_train // 5
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts(fa, fused_adamw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with small_dataset(datasets, n_train=n_train, n_test=n_test):
                summary = train_cli.main(argv)
            counts = read_counts(fa, fused_adamw)
            seconds = time.perf_counter() - t0
            peak_bytes = torch.cuda.max_memory_allocated()
            routes = (check_resident(fa, f"train CLI {pe_name} {flags or ''}")
                      if model is None else None)
            with open(summary["log_file"]) as f:
                rows = [line.strip().split(",") for line in f]
            ckpt = os.path.abspath(summary["ckpt_path"])
            if keep:
                shutil.copy(ckpt, keep)
            params, cfg, mean, std, native, _ = serving.load_serving_state(
                ckpt, grid_size=grid, num_heads=heads)
            predictor = serving.Predictor.from_params(params, cfg, mean, std,
                                                      native)
            # The CLI's synthetic data follow --seed.
            test = datasets.synthetic("cifar10", n_train=n_train,
                                      n_test=n_test,
                                      seed=int((flags or {}).get("seed", 0)))
            reset_counts(fa, fused_adamw)
            preds = np.concatenate(
                [predictor.predict(test.test_x[s:s + serve_bs])
                 for s in range(0, len(test.test_y), serve_bs)])
            serve_counts = read_counts(fa, fused_adamw)
            if model is None:
                check_resident(fa, f"Predictor {pe_name}")
        finally:
            os.chdir(cwd)
    header = ["epoch", "train_loss", "train_acc", "test_loss", "test_acc",
              "best_acc"]
    row = dict(zip(header, rows[1])) if len(rows) > 1 else {}
    served_acc = 100.0 * float((preds == test.test_y).mean())
    steps, evals = n_train // batch, n_test // batch
    # The CLI's k and k_eval (auto: the largest divisor up to 32 on the
    # card; 1 with --q_chunk), and the rows each launches: one CUDA graph
    # replay per dispatch of k captured steps or forwards (padded ones
    # too) after one warm-up step or forward; AdamW through its table
    # entry in a graph.
    spd = int((flags or {}).get("steps_per_dispatch", 0))
    spd = 1 if q_chunk else min(spd or ts.pick_steps_per_dispatch(steps),
                                steps)
    k_eval = 1 if q_chunk else ts.pick_steps_per_dispatch(evals)
    train_rows = -(-steps // spd) * spd + 1 if spd > 1 else steps
    eval_rows = -(-evals // k_eval) * k_eval + 1 if k_eval > 1 else evals
    fwd = "attn_fwd" if model is None else "attn_stream_fwd"
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": steps,
                fwd: depth * (train_rows + eval_rows)}
    if spd > 1:
        expected.update(adamw=0, adamw_table=train_rows)
    if model is None and (flags or {}).get("attn_drop_rate"):
        expected["attn_fwd"] = depth * eval_rows  # the train steps: oracle
    elif model is None:
        expected["attn_bwd"] = depth * train_rows
    elif q_chunk:
        # The bounded driver: chunk forwards in every train and eval step,
        # the one-pass backward per (q-chunk, key segment), no
        # whole-sequence forward.
        del expected[fwd]
        n_fwd, n_bwd = bounded_launches(fa, batch, heads,
                                        model["embed_dim"] // heads,
                                        grid * grid + 1, q_chunk)
        expected["attn_stream_chunk_fwd"] = depth * n_fwd * (steps + evals)
        expected["attn_stream_bwd_fused"] = depth * n_bwd * steps
    else:
        # As the JAX package routes: a bias up to 2048 tokens is
        # materialized (separate passes + dbias), rope-mixed learns its
        # frequencies (separate passes), every other mode takes the
        # one-pass backward.
        biased = pe_name in ("relative", "polynomial")
        materialized = biased and grid * grid + 1 <= 2048
        if materialized or pe_name == "rope-mixed":
            expected.update({name: depth * train_rows
                             for name in STREAM_PASSES})
            if materialized:
                expected["attn_stream_bwd_dbias"] = depth * train_rows
        else:
            expected["attn_stream_bwd_fused"] = depth * train_rows
    serve_expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 0,
                      fwd: depth * (n_test // serve_bs)}
    expected = with_prologues(expected)
    serve_expected = with_prologues(serve_expected)
    capture = (summary.get("capture_seconds"),
               summary.get("eval_capture_seconds"))
    log(f"  train CLI {pe_name} {model or 'defaults'} {flags or ''}: "
        f"{seconds:.1f} s, k {summary.get('steps_per_dispatch')} (expected "
        f"{spd}), evaluation k {summary.get('eval_rows_per_dispatch')} "
        f"(expected {k_eval}), capture seconds {capture}, peak device "
        f"memory {peak_bytes / 2**30:.2f} GiB, CSV "
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
    if model is None and bar is None:
        bar = LEARN_BAR[pe_name]
    for key, limit in (bar or {}).items():
        value = float(row[key])
        if not (value > limit if key == "test_acc" else value < limit):
            raise AssertionError(f"{pe_name} did not learn: {key} {value} "
                                 f"(bar {limit})")
    if abs(served_acc - test_acc) > 1e-9:
        raise AssertionError(f"served accuracy {served_acc} != CSV test_acc "
                             f"{test_acc}")
    if counts != expected or serve_counts != serve_expected:
        raise AssertionError(f"launch counts {counts}/{serve_counts} differ "
                             f"from {expected}/{serve_expected}")
    if (summary["steps_per_dispatch"], summary["eval_rows_per_dispatch"]) \
            != (spd, k_eval):
        raise AssertionError(f"the CLI took k {summary['steps_per_dispatch']}"
                             f" / {summary['eval_rows_per_dispatch']}, "
                             f"expected {spd} / {k_eval}")
    if (capture[0] is None) != (spd == 1) \
            or (capture[1] is None) != (k_eval == 1):
        raise AssertionError(f"capture seconds {capture} at k {spd} / "
                             f"{k_eval}: a graph was not captured")
    return dict(seconds=seconds, csv=row, launches=counts, routes=routes,
                served_acc=served_acc, n_train=n_train,
                images_per_s=summary["history"][0]["images_per_sec"],
                capture_seconds=capture[0], eval_capture_seconds=capture[1],
                k=spd, k_eval=k_eval, peak_bytes=peak_bytes)


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
    if expected is not None:
        expected = with_prologues(expected)
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
    """Phase 10b: the backward kernel at the ViT-S training shape and at
    ViT-tiny/4's against its twin and against SDPA's backward on
    pre-rotated q/k (forward + backward minus forward); the resident
    kernel's and the slab sum's device times by the profiler."""
    import torch.nn.functional as F

    rows = {}
    for prefix, shape in DENSE_TIMED:
        scale = shape[-1] ** -0.5
        for label, regime in ((prefix + "rope-mixed f32", "rope-mixed"),
                              (prefix + "rel-bias f32", "rel")):
            q, k, v, kw = attn_inputs(regime, shape, torch.float32, 8, device)
            bias, cos, sin = fa.prepare_pe(shape[1], shape[2], device, **kw)
            out = fa.attention_fwd(q, k, v, scale, bias, cos, sin)
            g = torch.randn(shape, generator=torch.Generator().manual_seed(1))
            g = g.to(device)
            want_drot = regime == "rope-mixed"
            args = (q, k, v, out, g, scale, bias, cos, sin)

            def kernel():
                fa.attention_bwd(*args, want_dbias=bias is not None,
                                 want_drot=want_drot)

            kernel_ms = median_ms(kernel)
            names = ("attn_bwd_resident_kernel",) + (
                ("attn_bwd_slab_sum_kernel",) if bias is not None else ())
            device_ms, _, _ = device_ms_by_kernel(kernel, 20, names)
            plain_ms = median_ms(lambda: fa.attention_bwd_plain(
                *args, want_dbias=bias is not None, want_drot=want_drot))
            qr, kr = q, k
            if cos is not None:
                qr = fa._rotate(q, cos[None], sin[None])
                kr = fa._rotate(k, cos[None], sin[None])
            qr, kr, vr = (t.detach().clone().requires_grad_()
                          for t in (qr, kr, v))
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
                               bound_by=bound_by, device_ms=device_ms,
                               shape=list(shape))
            log(f"  attention bwd {label:26s} kernel {kernel_ms:.4f} ms  twin "
                f"{plain_ms:.4f} ms  sdpa bwd {library_ms:.4f} ms  bound "
                f"{bound_ms:.4f} ms ({bound_by}); device time by kernel "
                + ", ".join(f"{k} {v:.4f} ms" for k, v in device_ms.items()))
    return rows


def time_adamw(fused_adamw, vit, cfg, device):
    """Phase 10c: one AdamW step over the ViT-S params: the wrapper (CUDA
    events around back-to-back calls, host work included), the kernel's own
    device time (torch.profiler), its twin, torch.optim.AdamW(fused=True)
    as a yardstick, and the bound; and what a step with an unchanged
    parameter set copies between host and device (the profiler's Memcpy
    events, none expected: the device table is built once)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(22)
    params = vit.init_params(gen, cfg, device=device)
    grads = {k: torch.randn(v.shape, generator=gen).to(device)
             for k, v in params.items()}
    keys = list(params)
    lists = ([params[k] for k in keys], [grads[k] for k in keys],
             [torch.zeros_like(params[k]) for k in keys],
             [torch.zeros_like(params[k]) for k in keys])
    hyper = (1e-3, 0.1, 0.001, 0.9, 0.999, 1e-8, 0.01)

    def step():
        fused_adamw.adamw_update(*lists, *hyper)

    kernel_ms = median_ms(step)
    by_name, recorded, calls = device_ms_by_kernel(step, 20, ("adamw_kernel",))
    device_ms = by_name["adamw_kernel"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            step()
        torch.cuda.synchronize()
    copies = sorted({ev.name for ev in prof.events()
                     if "emcpy" in ev.name or "pin_memory" in ev.name})
    launched = sum(ev.device_type == DeviceType.CUDA and "adamw_kernel"
                   in ev.name for ev in prof.events())
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
    log(f"  AdamW step, {n:,} params: wrapper {kernel_ms:.4f} ms  kernel "
        f"device time {device_ms:.4f} ms (profiler, {recorded} of {calls} "
        f"launches recorded)  torch fused AdamW {library_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms (bytes)  twin {plain_ms:.4f} ms; device time / "
        f"bound {device_ms / bound_ms:.2f}, wrapper / torch fused "
        f"{kernel_ms / library_ms:.2f}")
    log(f"  AdamW, 10 profiled steps on one parameter set: {launched} kernel "
        f"launches seen, host-device copies and pinned allocations: "
        f"{copies or 'none'}")
    if copies:
        raise AssertionError(f"an AdamW step with an unchanged parameter set "
                             f"copied between host and device: {copies}")
    return dict(ms=kernel_ms, device_ms=device_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by="bytes",
                num_params=n, profiled_launches=launched, copies=copies)


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
    if per_step["attn_fwd"] or per_step["attn_bwd"]:
        check_resident(fa, label)
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
    one case: forward (out, lse; launched twice, bit-identical, one prologue
    before each launch) and its prologue alone (its operands bit for bit),
    then dq, dk, dv (+ dbias, dcos/dsin) from the kernel's own out and lse,
    and the separate passes' prologue alone (its operands bit for bit,
    delta within PROLOGUE_DELTA_TOL). Returns {output: (max_abs_err, ok,
    share of the largest entry)}."""
    q, k, v, kw, freqs = stream_inputs(fa, regime, shape, dtype, seed, device)
    scale = shape[-1] ** -0.5
    res = fwd_relaunch(fa, q, k, v, scale, kw)
    out, lse = res.pop("outputs")
    want_out, want_lse = fa.attention_stream_plain(
        q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw)
    lse_err = float((lse - want_lse).abs().max())
    res.update({"out": share_err(out, want_out, STREAM_TOL[dtype]),
                "lse": (lse_err, lse_err <= LSE_TOL, lse_err)})
    ops = fa.attention_stream_fwd_prologue(k, v, kw["cos"], kw["sin"])
    want_ops = fa.attention_stream_fwd_prologue_plain(k, v, kw["cos"],
                                                      kw["sin"])
    err = float((ops.float() - want_ops.float()).abs().max())
    res["fwd prologue"] = (err, torch.equal(ops, want_ops), err)
    del ops, want_ops
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
    del want
    ops, delta = fa.attention_stream_bwd_prologue(q, k, v, out, g, kw["cos"],
                                                  kw["sin"])
    torch.cuda.synchronize()
    want_ops, want_delta = fa.attention_stream_bwd_prologue_plain(
        q, k, v, out, g, kw["cos"], kw["sin"])
    err, ok, share = share_err(delta, want_delta, PROLOGUE_DELTA_TOL)
    res["prologue"] = (err, ok and torch.equal(ops, want_ops), share)
    del ops, want_ops
    return res


def fwd_relaunch(fa, q, k, v, scale, kw):
    """The streaming forward launched twice on one case: {"outputs": the
    first (out, lse), "relaunch": (0, whether the second is bit-identical
    and each launch followed one prologue, 0 or 1)}."""
    counts = (fa.LAUNCHES_STREAM_FWD_PROLOGUE, fa.LAUNCHES_STREAM_FWD)
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    again, again_lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    torch.cuda.synchronize()
    ok = (torch.equal(out, again) and torch.equal(lse, again_lse)
          and (fa.LAUNCHES_STREAM_FWD_PROLOGUE, fa.LAUNCHES_STREAM_FWD)
          == (counts[0] + 2, counts[1] + 2))
    return {"outputs": (out, lse), "relaunch": (0.0, ok, 0.0 if ok else 1.0)}


def check_stream_vs_twin(fa, device):
    """Phase 11: every case is run and logged, then any failure raises.
    Returns the worst f32 errors by kernel: {"fwd", "fwd_prologue" (held
    bit for bit), "dq", "dkv", "prologue" (delta; its operands are held bit
    for bit)} over all cases, {"dbias"} at the training path's shape (B=16:
    16 ds slabs and the sum kernel)."""
    worst = {"fwd": 0.0, "fwd_prologue": 0.0, "dq": 0.0, "dkv": 0.0,
             "dbias": 0.0, "prologue": 0.0}
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
            f"{STREAM_BWD_TOL[dtype]:g} lse {LSE_TOL:g} prologue delta "
            f"{PROLOGUE_DELTA_TOL:g}, operands bit for bit, forward "
            f"relaunched bit for bit {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((regime, shape, dtype))
        if dtype == torch.float32:
            worst["fwd"] = max(worst["fwd"], res["out"][0])
            worst["fwd_prologue"] = max(worst["fwd_prologue"],
                                        res["fwd prologue"][0])
            if "dq" in res:
                worst["dq"] = max(worst["dq"], res["dq"][0])
                worst["dkv"] = max(worst["dkv"], res["dk"][0], res["dv"][0])
                worst["prologue"] = max(worst["prologue"],
                                        res["prologue"][0])
            if shape == vit_s_384_train:
                worst["dbias"] = res["dbias"][0]
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"streaming kernels disagree with their twins: "
                             f"{failed}")
    return worst


def check_dbias_vs_twin(fa, device):
    """Phase 11c: dbias from the dq pass (per-batch float32 ds slabs and the
    sum kernel) against the twin with a materialized relative bias at 6
    heads of 64, B = 1, 7, 8, 9 and 16 at N = 577 and 300 (not a multiple
    of 64), f32 and bf16; at B=16, N=577 also over a lowered byte budget of
    3 slabs (3 batch groups) and of none (one group: the same bits as one
    slab per batch; slabs of [H, N, fa.dbias_pitch(N)]). dq, dk, dv and
    dbias as a share of their largest entries (STREAM_BWD_TOL); every call
    launched twice and compared bit for bit, one launch of the prologue, dq
    (its dbias instance), dk/dv and dbias each."""
    slab = 6 * 577 * fa.dbias_pitch(577) * 4
    cases = [(b, n, dtype, None) for n in (577, 300) for b in (1, 7, 8, 9, 16)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(16, 577, dtype, budget) for budget in (3 * slab, 0)
              for dtype in (torch.float32, torch.bfloat16)]
    failed, per_batch = [], {}
    for i, (b, n, dtype, budget) in enumerate(cases):
        shape = (b, 6, n, 64)
        q, k, v, kw, _ = stream_inputs(fa, "bias", shape, dtype, 600 + b,
                                       device)
        out, lse = fa.attention_stream_fwd(q, k, v, 0.125, **kw)
        g = torch.randn(shape, generator=torch.Generator().manual_seed(b))
        g = g.to(device, dtype)
        counts = (fa.LAUNCHES_STREAM_PROLOGUE, fa.LAUNCHES_STREAM_DQ,
                  fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS)
        got, again = (fa.attention_stream_bwd(
            q, k, v, out, g, lse, 0.125, want_dbias=True,
            dbias_budget=budget, **kw)[:4] for _ in range(2))
        torch.cuda.synchronize()
        launched = tuple(after - before for after, before in zip(
            (fa.LAUNCHES_STREAM_PROLOGUE, fa.LAUNCHES_STREAM_DQ,
             fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DBIAS), counts))
        want = fa.attention_stream_bwd_plain(
            q, k, v, out, g, lse, 0.125, kv_tile=fa.STREAM_TILE,
            want_dbias=True, **kw)
        tol = STREAM_BWD_TOL[dtype]
        res = {name: share_err(x, y, tol) for name, x, y in
               zip(("dq", "dk", "dv", "dbias"), got, want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        if budget is None and n == 577 and b == 16:
            per_batch[dtype] = got
        if budget == 0:  # one group: the same bits as one slab per batch
            same = same and all(torch.equal(x, y) for x, y in
                                zip(got, per_batch[dtype]))
        ok = all(r[1] for r in res.values()) and same and \
            launched == (2, 2, 2, 2)
        log(f"dbias vs twin  B={b} N={n} {str(dtype)[6:]:8s} groups "
            f"{fa.dbias_groups(b, 6, n, budget, fa.dbias_pitch(n))}"
            f"{'' if budget is None else f' (budget {budget} bytes)'} "
            + " ".join(f"{name}={r[0]:.2e}({r[2]:.1e})"
                       for name, r in res.items())
            + f" tol(share of largest)={tol:g} bit-identical {same} launches "
            f"{launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((b, n, str(dtype), budget))
        del q, k, v, out, lse, g, got, again, want
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"dbias disagrees with its twin: {failed}")


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
    expected = with_prologues({"attn_fwd": 0,
                                  "attn_stream_fwd": cfg.depth * 2})
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
    fa.LAUNCHES = fa.LAUNCHES_STREAM_FWD = fa.LAUNCHES_STREAM_FWD_PROLOGUE = 0
    got = kernel.logits(images)
    counts = (fa.LAUNCHES, fa.LAUNCHES_STREAM_FWD,
              fa.LAUNCHES_STREAM_FWD_PROLOGUE)
    want = reference.logits(images)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    log(f"  ViT-S/16@384 rope-mixed batch 64: launches (dense, streaming, "
        f"its prologue) {counts} (expected (0, {cfg.depth}, {cfg.depth})), "
        f"logits vs reference max_abs_err={err:.3e} (|logits| <= "
        f"{scale:.3f}, tol {LOGITS_TOL:g})")
    if counts != (0, cfg.depth, cfg.depth) or not np.isfinite(got).all():
        raise AssertionError("ViT-S/16@384 did not take the streaming kernel")
    if err > LOGITS_TOL * max(1.0, scale):
        raise AssertionError("kernel path disagrees with the reference path")
    times = {}
    for label, pred in (("kernel", kernel), ("reference", reference)):
        u8 = torch.from_numpy(images).to(device)
        ms = median_ms(lambda: pred.forward(u8), iters=3, reps=3, warmup=1)
        times[label] = dict(forward_ms=ms, img_per_s=64e3 / ms)
        log(f"  serving ViT-S/16@384 bs64 ({label} attention): device "
            f"forward {ms:.3f} ms/batch ({64e3 / ms:.1f} img/s)")
    return times


def fused_inputs(fa, regime, shape, dtype, seed, device):
    """One backward's inputs from the forward kernel: (q, k, v, g, lse,
    delta, scale), the PE keyword arguments, and out."""
    q, k, v, kw, _ = stream_inputs(fa, regime, shape, dtype, seed, device)
    scale = shape[-1] ** -0.5
    out, lse = fa.attention_stream_fwd(q, k, v, scale, **kw)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to(device, dtype)
    delta = (g.float() * out.float()).sum(dim=-1)
    return (q, k, v, g, lse, delta, scale), kw, out


def fused_errors(got, want):
    """{output: (max_abs_err, ok, share)} of one one-pass backward against
    its twin: (dq, dk, dv, dcoeff, dtable)."""
    res = {name: share_err(x, y, FUSED_TOL)
           for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3])}
    for name, x, y in zip(("dcoeff", "dtable"), got[3:], want[3:]):
        if (x is None) != (y is None):
            raise AssertionError(f"{name}: kernel and twin disagree on None")
        if x is not None:
            res[name] = share_err(x, y, PARAM_TOL)
    return res


def fused_prologue_err(fa, q, k, v, g, cos=None, sin=None):
    """The one-pass backward's prologue against its twin: (max_abs_err, bit
    for bit, max_abs_err) over its four operands."""
    got = fa.attention_stream_bwd_fused_prologue(q, k, v, g, cos, sin)
    torch.cuda.synchronize()
    want = fa.attention_stream_bwd_fused_prologue_plain(q, k, v, g, cos, sin)
    err = max(float((x.float() - y.float()).abs().max())
              for x, y in zip(got, want))
    return err, all(torch.equal(x, y) for x, y in zip(got, want)), err


def check_fused_vs_twin(fa, device):
    """Phase 11b: every case is run and logged, then any failure raises.
    Returns the worst f32-input errors: {"fused"} over dq, dk, dv of all
    one-pass cases, {"prologue"} of its prologue (held bit for bit),
    {"dcoeff", "dtable"} of the separate-pass kernels."""
    worst = {"fused": 0.0, "prologue": 0.0, "dcoeff": 0.0, "dtable": 0.0}
    failed = []
    longseq = (4, 4, 4097, 32)

    def report(label, shape, dtype, regime, res):
        ok = all(r[1] for r in res.values())
        log(f"{label}  B={shape[0]} N={shape[2]} D={shape[3]} "
            f"{str(dtype)[6:]:8s} {regime:10s} "
            + " ".join(f"{k}={v[0]:.2e}({v[2]:.1e})" for k, v in res.items())
            + f" tol(share of largest)={FUSED_TOL:g}, params {PARAM_TOL:g} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((label, regime, shape, dtype))

    cases = [(shape, dtype, regime)
             for shape in (longseq, (16, 6, 577, 64), (2, 4, 16385, 32))
             for dtype in (torch.float32, torch.bfloat16)
             for regime in FUSED_REGIMES]
    for i, (shape, dtype, regime) in enumerate(cases):
        args, kw, _ = fused_inputs(fa, regime, shape, dtype, 500 + i, device)
        counts = (fa.LAUNCHES_STREAM_FUSED, fa.LAUNCHES_STREAM_FUSED_PROLOGUE)
        got = fa.attention_stream_bwd_fused(*args, **kw)
        again = fa.attention_stream_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
        same = all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(got, again)) and (
            fa.LAUNCHES_STREAM_FUSED, fa.LAUNCHES_STREAM_FUSED_PROLOGUE) == (
            counts[0] + 2, counts[1] + 2)
        want = fa.attention_stream_bwd_fused_plain(*args, **FUSED_TWIN_TILES,
                                                   **kw)
        res = fused_errors(got, want)
        res["two launches"] = (0.0, same, 0.0 if same else 1.0)
        res["prologue"] = fused_prologue_err(fa, *args[:4], kw.get("cos"),
                                             kw.get("sin"))
        report("one-pass bwd vs twin", shape, dtype, regime, res)
        if dtype == torch.float32:
            worst["fused"] = max(worst["fused"],
                                 *(res[name][0] for name in ("dq", "dk", "dv")))
            worst["prologue"] = max(worst["prologue"], res["prologue"][0])
        del args, kw, got, again, want
        torch.cuda.empty_cache()

    # Forced 1024-key segments (five launches, the last of one key), rope
    # applied outside the sweep, launched twice; then one (shard, chunk) pair
    # of a ring, launched twice.
    real_seg_cols = fa._fused_kv_seg_cols
    for i, (dtype, regime) in enumerate(
            [(torch.float32, regime) for regime in FUSED_REGIMES]
            + [(torch.bfloat16, "rope-axial"), (torch.bfloat16, "rel")]):
        args, kw, _ = fused_inputs(fa, regime, longseq, dtype, 540 + i, device)
        want = fa.attention_stream_bwd_fused_plain(*args, **FUSED_TWIN_TILES,
                                                   **kw)
        fa._fused_kv_seg_cols = lambda b, h, n, d: 1024
        try:
            before = fa.LAUNCHES_STREAM_FUSED
            got = fa.attention_stream_bwd_fused(*args, **kw)
            again = fa.attention_stream_bwd_fused(*args, **kw)
            torch.cuda.synchronize()
            launches = fa.LAUNCHES_STREAM_FUSED - before
        finally:
            fa._fused_kv_seg_cols = real_seg_cols
        res = fused_errors(got, want)
        same = all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(got, again))
        res["5 launches a call"] = (launches / 2, launches == 10, 0.0)
        res["two launches"] = (0.0, same, 0.0 if same else 1.0)
        report("one-pass bwd in 1024-key segments", longseq, dtype, regime,
               res)
    for i, regime in enumerate(("none", "poly", "rel")):
        (q, k, v, g, lse, delta, scale), kw, _ = fused_inputs(
            fa, regime, longseq, torch.float32, 550 + i, device)
        pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
        rows, cols = slice(1000, 4097), slice(2000, 3500)
        args = (q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows],
                lse[:, :, rows], delta[:, :, rows], scale)
        got = fa.streaming_chunk_bwd(*args, 1000, 2000, 4097, **pe)
        again = fa.streaming_chunk_bwd(*args, 1000, 2000, 4097, **pe)
        torch.cuda.synchronize()
        same = all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(got, again))
        want = fa.attention_stream_bwd_fused_plain(
            *args, **FUSED_TWIN_TILES, n_valid=4097, row0=1000, col0=2000,
            **pe)
        got = got[:3] + ((got[3], None) if regime == "poly" else
                         (None, got[3]))
        res = fused_errors(got, want)
        res["two launches"] = (0.0, same, 0.0 if same else 1.0)
        res["prologue"] = fused_prologue_err(fa, *args[:4])
        report("one-pass bwd at offsets (1000, 2000), 1500 keys", longseq,
               torch.float32, regime, res)
    torch.cuda.empty_cache()

    # Rows 9 and 10: the separate-pass backward with want_dparam.
    cases = [(shape, dtype, regime)
             for shape in (longseq, (16, 6, 577, 64))
             for dtype in (torch.float32, torch.bfloat16)
             for regime in ("poly", "rel")]
    cases += [((2, 4, 16385, 32), torch.float32, regime)
              for regime in ("poly", "rel")]
    for i, (shape, dtype, regime) in enumerate(cases):
        (q, k, v, g, lse, _, scale), kw, out = fused_inputs(
            fa, regime, shape, dtype, 560 + i, device)
        got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                      want_dparam=True, **kw)
        again = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                        want_dparam=True, **kw)
        torch.cuda.synchronize()
        want = fa.attention_stream_bwd_plain(
            q, k, v, out, g, lse, scale, kv_tile=FUSED_TWIN_TILES["kv_tile"],
            want_dparam=True, **kw)
        name, at = ("dcoeff", 6) if regime == "poly" else ("dtable", 7)
        same = torch.equal(got[at], again[at])
        res = {name: share_err(got[at], want[at], PARAM_TOL),
               "two launches": (0.0, same, 0.0 if same else 1.0)}
        report(f"{name} kernel vs twin", shape, dtype, regime, res)
        if dtype == torch.float32:
            worst[name] = max(worst[name], res[name][0])
        del q, k, v, g, lse, out, got, again, want, kw
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"one-pass / parameter-gradient kernels "
                             f"disagree with their twins: {failed}")
    return worst


def check_direct_dparam_path(fa, fused_adamw, device, depth):
    """Phase 13c: the path of rows 9 and 10. No model reaches them (as in
    the JAX package: the custom_vjp takes the one-pass kernel); their
    callers call the separate-pass backward with a generated bias directly.
    Here: `depth` such calls each for the polynomial and the relative bias
    at the long-sequence model's attention shape, counts reset just before
    and read just after, the coefficients' / table's gradient held to the
    one-pass kernel's on the same inputs. Returns the launch counts."""
    shape = (4, LONGSEQ["num_heads"], 4097,
             LONGSEQ["embed_dim"] // LONGSEQ["num_heads"])
    cases = []
    for i in range(depth):
        for regime in ("poly", "rel"):
            args, kw, out = fused_inputs(fa, regime, shape, torch.float32,
                                         600 + i, device)
            cases.append((regime, args, kw, out))
    reset_counts(fa, fused_adamw)
    separate = [fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                        want_dparam=True, **kw)
                for _, (q, k, v, g, lse, _, scale), kw, out in cases]
    counts = read_counts(fa, fused_adamw)
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 0,
                "attn_stream_bwd_prologue": 2 * depth,
                "attn_stream_bwd_dq": 2 * depth,
                "attn_stream_bwd_dkv": 2 * depth,
                "attn_stream_bwd_dcoeff": depth,
                "attn_stream_bwd_dtable": depth}
    log(f"  direct separate-pass backward with poly= / rel=: launches "
        f"{counts} (expected {expected})")
    if counts != expected:
        raise AssertionError("launch counts differ from the expected")
    for (regime, args, kw, _), got in zip(cases, separate):
        one_pass = fa.attention_stream_bwd_fused(*args, **kw)
        x, y = (got[6], one_pass[3]) if regime == "poly" else (got[7],
                                                              one_pass[4])
        err, ok, share = share_err(x, y, PARAM_TOL)
        log(f"    {regime}: separate-pass vs one-pass parameter gradient "
            f"max_abs_err={err:.3e} ({share:.1e} of largest, tol "
            f"{PARAM_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{regime}: the two parameter gradients "
                                 f"disagree")
    return counts


def stream_bound_ms(kernel, shape, dtype, kw, want_drot):
    """Least time for one streaming kernel's work: its inputs read once and
    its outputs written once over the memory rate, against its products of
    2*N*N*D per (batch, head) at the bf16 tensor-core peak. [B, H, N, D]
    tensors in the input dtype, in bf16 and [B, H, N] float32 rows of
    statistics, by kernel: the forward's wrapper ("fwd") reads q, k, v and
    writes out and lse (2 products); its kernel ("fwd_kernel") reads q and
    the prologue's two bf16 operands and writes out and lse (2 products);
    its prologue reads k and v and writes the two bf16 operands (no
    product);
    the separate passes' prologue reads q, k, v, g and out and writes the
    four bf16 operands and delta (no product); dq reads the four bf16
    operands, lse and delta and writes dq (3 products); dk/dv reads the
    same and writes dk and dv (4); dbias, the work of the JAX dbias kernel,
    reads q, k, v, g, lse and delta (2 products)."""
    b, h, n, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    tensors, bf16_tensors, stats, products = {
        "fwd": (4, 0, 1, 2), "fwd_kernel": (2, 2, 1, 2),
        "fwd_prologue": (2, 2, 0, 0), "prologue": (5, 4, 1, 0),
        "dq": (1, 4, 2, 3), "dkv": (2, 4, 2, 4), "dbias": (4, 0, 2, 2)}[kernel]
    nbytes = (tensors * elem + bf16_tensors * 2) * b * h * n * d \
        + stats * b * h * n * 4
    if kw.get("bias") is not None and "prologue" not in kernel:
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
    """torch.profiler over at least `iters` calls of fn: for each of
    `names`, the device time in ms of one launch of every kernel whose name
    contains it (the mean over the launches the profiler recorded, summed
    over those kernels). In a process that has run for a while the profiler
    drops the first launches after it starts (up to six calls seen), so it
    is given at least eight calls, and twice as many again when a kernel
    went unrecorded. Also returns the least number of launches
    recorded and the calls made."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    calls = max(iters, 8)
    for _attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                spans.setdefault(ev.name, []).append(
                    ev.time_range.elapsed_us() / 1e3)
        ms = {name: sum(statistics.mean(v) for k, v in spans.items()
                        if name in k) for name in names}
        missing = [name for name, t in ms.items() if t <= 0.0]
        if not missing:
            break
        calls *= 2
    else:
        raise AssertionError(f"the profiler saw no device time of {missing}")
    recorded = min(len(v) for k, v in spans.items()
                   if any(name in k for name in names))
    return ms, recorded, calls


def time_stream_kernels(fa, device):
    """Phase 14a: the forward by CUDA events around its wrapper (its
    prologue, a padded copy of the bias and the launches included) and its
    kernel and prologue by the profiler's device time over calls of the
    wrapper; the separate passes' prologue, dq and dk/dv kernels by the
    profiler's device time over calls of the one backward wrapper, which is
    also timed whole (launches and a padded copy of the bias included).
    With a bias, dbias is the dq kernel's dbias instance less its instance
    without dbias (the same call with want_dbias=False), plus the sum
    kernel; dq is the instance without dbias. Each beside its twin (the prologue's own; the whole forward / the whole
    backward: the twin of dq and dk/dv is not split by kernel) and its
    bound. The yardstick is SDPA on pre-rotated
    q/k: its forward for the forward kernel; its backward (forward +
    backward minus forward; dq, dk and dv in one call, and the mask's
    gradient with a bias) computes what the backward kernels compute
    together, so it stands once, against the whole backward wrapper
    (`group_ms` / `group_library_ms`), and no backward kernel has a library
    call of its own; the forward kernel stands against SDPA's forward, its
    prologue against none, both with the whole forward wrapper as their
    group."""
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

        def forward():
            fa.attention_stream_fwd(q, k, v, scale, **kw)

        ms = {"fwd": median_ms(forward, **timing)}
        fwd_names = {"fwd_kernel": "attn_stream_fwd_kernel",
                     "fwd_prologue": "attn_stream_fwd_prologue_kernel"}
        by_name, _, _ = device_ms_by_kernel(forward, 3 * iters,
                                            tuple(fwd_names.values()))
        ms.update({kernel: by_name[name]
                   for kernel, name in fwd_names.items()})
        names = {"prologue": "attn_stream_bwd_prologue_kernel",
                 "dq": "attn_stream_bwd_dq_kernel",
                 "dkv": "attn_stream_bwd_dkv_kernel"}
        if want_dbias:
            names["dbias_sum"] = "attn_stream_bwd_dbias_sum_kernel"
        by_name, recorded, calls = device_ms_by_kernel(
            backward, 3 * iters, tuple(names.values()))
        ms.update({kernel: by_name[name] for kernel, name in names.items()})
        parts = {}
        if want_dbias:
            alone, _, _ = device_ms_by_kernel(
                lambda: fa.attention_stream_bwd(
                    q, k, v, out, g, lse, scale,
                    **dict(bwd, want_dbias=False)),
                3 * iters, (names["dq"],))
            parts = {"dq_with_dbias_ms": ms["dq"],
                     "dq_alone_ms": alone[names["dq"]],
                     "sum_ms": ms.pop("dbias_sum")}
            ms["dq"] = parts["dq_alone_ms"]
            ms["dbias"] = (parts["dq_with_dbias_ms"] - parts["dq_alone_ms"]
                           + parts["sum_ms"])
        bwd_ms = median_ms(backward, **timing)
        plain = {"fwd": median_ms(lambda: fa.attention_stream_plain(
            q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw), iters=2, reps=3,
            warmup=1)}
        plain["bwd"] = median_ms(lambda: fa.attention_stream_bwd_plain(
            q, k, v, out, g, lse, scale, kv_tile=fa.STREAM_TILE, **bwd),
            iters=2, reps=3, warmup=1)
        plain["prologue"] = median_ms(
            lambda: fa.attention_stream_bwd_prologue_plain(
                q, k, v, out, g, kw["cos"], kw["sin"]), **timing)
        plain["fwd_prologue"] = median_ms(
            lambda: fa.attention_stream_fwd_prologue_plain(
                k, v, kw["cos"], kw["sin"]), **timing)
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
            if kernel.startswith("fwd_"):
                row.update(plain_ms=plain.get(kernel, plain["fwd"]),
                           library_ms=lib_fwd if kernel == "fwd_kernel"
                           else None, group="attention_stream_fwd",
                           group_ms=ms["fwd"], group_library_ms=lib_fwd)
            elif kernel != "fwd":
                row.update(plain_ms=plain.get(kernel, plain["bwd"]),
                           library_ms=None, group="attention_stream_bwd",
                           group_ms=bwd_ms, group_library_ms=lib_bwd)
            rows[label][kernel] = row
            what = "wrapper" if kernel == "fwd" else "kernel"
            log(f"  {label} {kernel:12s} {what} {t:.4f} ms  twin "
                f"{row['plain_ms']:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})"
                + (f"  sdpa {lib_fwd:.4f} ms" if kernel.startswith("fwd")
                   and kernel != "fwd_prologue" else ""))
        if parts:
            rows[label]["dbias"].update(parts)
            log(f"  {label} dbias: dq kernel with its ds slabs "
                f"{parts['dq_with_dbias_ms']:.4f} ms, without "
                f"{parts['dq_alone_ms']:.4f} ms, sum over "
                f"{fa.dbias_groups(*shape[:3])} slabs "
                f"{parts['sum_ms']:.4f} ms")
        log(f"  {label} whole backward wrapper {bwd_ms:.4f} ms  sdpa backward "
            f"{lib_bwd:.4f} ms (profiler: {recorded} of {calls} launches "
            f"of each backward kernel recorded)")
        del q, k, v, out, lse, g, qr, kr, vr, mask, kw, bwd
        torch.cuda.empty_cache()
    return rows


def fused_bound_ms(shape, dtype, kw, products, outputs):
    """Least time for the one-pass backward's work (products=5, outputs=3:
    dq, dk, dv in float32) or for a parameter-gradient pass (products=2,
    outputs=0): q, k, v, g, lse and delta read once, the outputs and the
    parameters' gradient written once (plus the rope tables, the
    coefficients or the table) over the memory rate, against the products
    of 2*N*N*D per (batch, head) at the bf16 tensor-core peak."""
    b, h, n, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (4 * elem + outputs * 4) * b * h * n * d + 2 * b * h * n * 4
    if kw.get("cos") is not None:
        nbytes += 2 * kw["cos"].numel() * 4
    if kw.get("poly") is not None:
        nbytes += 2 * kw["poly"][0].numel() * 4
    if kw.get("rel") is not None:
        nbytes += 2 * kw["rel"].numel() * 4
    flops = products * 2 * b * h * n * n * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fused_prologue_bound_ms(shape, dtype, kw, keys=None):
    """Least time for the one-pass backward's prologue: q and g (rows) and
    k and v (keys) read once in the input dtype, and the rope tables, over
    the memory rate; the four bf16 operands written once."""
    b, h, n, d = shape
    keys = n if keys is None else keys
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (elem + 2) * 2 * (n + keys) * b * h * d
    if kw.get("cos") is not None:
        nbytes += 2 * kw["cos"].numel() * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def time_fused_kernels(fa, device):
    """Phase 14b: the one-pass backward (none / polynomial / relative) and
    the separate dq + dk/dv passes on the same inputs, both as the whole
    backward from g and out (delta included) by CUDA events around the
    wrappers; the one-pass sweep kernel, its prologue and its dq sum alone
    by the profiler's device time per launch (the sweep in thread-block
    clusters of fa.FUSED_CLUSTER CTAs); the twin; the bound; SDPA's backward
    on the same q, k, v (with the materialized bias as a mask that needs a
    gradient, up to N=4097) as the library yardstick. Then the one-pass
    backward on the key chunk of most launches of the --q_chunk 2048 epoch
    (batch 4, the second q-chunk of 2,048 rows against the 4,608 keys of
    N=4,097, no bias), and the dcoeff / dtable kernels of the separate-pass
    backward (with their sums) by the profiler, beside their bound; no
    PyTorch call computes what they compute. Returns (one-pass rows,
    parameter-pass rows), each {shape label: {regime: row}}."""
    import torch.nn.functional as F

    log(f"  one-pass sweep: thread-block clusters of {fa.FUSED_CLUSTER} "
        f"CTAs of {fa.STREAM_BWD_ROWS} keys")
    names = ("attn_stream_bwd_fused_kernel",
             "attn_stream_bwd_fused_prologue_kernel",
             "attn_stream_bwd_fused_dq_kernel")
    fused_rows, param_rows = {}, {}
    for label, shape, iters in (("longseq N=4097", (4, 4, 4097, 32), 5),
                                ("vit-s/16@384", (16, 6, 577, 64), 10),
                                ("longseq N=16385", (2, 4, 16385, 32), 2)):
        fused_rows[label], param_rows[label] = {}, {}
        timing = dict(iters=iters, reps=5, warmup=2)
        twin_timing = dict(iters=1, reps=3, warmup=1)
        for regime in ("none", "poly", "rel"):
            (q, k, v, g, lse, _, scale), kw, out = fused_inputs(
                fa, regime, shape, torch.float32, 10, device)

            def one_pass():
                delta = (g.float() * out.float()).sum(dim=-1)
                fa.attention_stream_bwd_fused(q, k, v, g, lse, delta, scale,
                                              **kw)

            def separate(want_dparam=False):
                fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                        want_dparam=want_dparam, **kw)

            def twin():
                delta = (g.float() * out.float()).sum(dim=-1)
                fa.attention_stream_bwd_fused_plain(
                    q, k, v, g, lse, delta, scale, **FUSED_TWIN_TILES, **kw)

            before = fa.LAUNCHES_STREAM_FUSED
            one_pass()
            per_call = fa.LAUNCHES_STREAM_FUSED - before
            ms = median_ms(one_pass, **timing)
            separate_ms = median_ms(separate, **timing)
            sweep, recorded, _ = device_ms_by_kernel(one_pass, 3 * iters,
                                                     names)
            plain_ms = median_ms(twin, **twin_timing)
            bound_ms, bound_by = fused_bound_ms(shape, torch.float32, kw, 5, 3)
            pro_bound = fused_prologue_bound_ms(shape, torch.float32, kw)
            pro_plain = median_ms(
                lambda: fa.attention_stream_bwd_fused_prologue_plain(
                    q, k, v, g, kw.get("cos"), kw.get("sin")), **twin_timing)
            library_ms = None
            if regime == "none" or shape[2] <= 4097:
                qr, kr, vr = (t.detach().clone().requires_grad_()
                              for t in (q, k, v))
                mask = None
                if regime != "none":
                    mask = fa._dense_bias(
                        shape[1], shape[2], device, poly=kw.get("poly"),
                        rel=kw.get("rel"))[None].requires_grad_()

                def sdpa_fwd():
                    with torch.no_grad():
                        F.scaled_dot_product_attention(
                            qr, kr, vr, attn_mask=mask, scale=scale)

                def sdpa_fwd_bwd():
                    F.scaled_dot_product_attention(
                        qr, kr, vr, attn_mask=mask, scale=scale).backward(g)

                library_ms = (median_ms(sdpa_fwd_bwd, **timing)
                              - median_ms(sdpa_fwd, **timing))
                del qr, kr, vr, mask
            fused_rows[label][regime] = dict(
                ms=ms, separate_ms=separate_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                sweep_ms=sweep[names[0]], prologue_ms=sweep[names[1]],
                prologue_bound_ms=pro_bound, prologue_plain_ms=pro_plain,
                dq_sum_ms=sweep[names[2]], cluster=fa.FUSED_CLUSTER,
                launches_per_call=per_call)
            log(f"  {label} {regime:5s} one-pass backward {ms:.4f} ms "
                f"({per_call} launch(es): sweep {sweep[names[0]]:.4f} ms, "
                f"prologue {sweep[names[1]]:.4f} ms (bound {pro_bound:.4f}, "
                f"twin {pro_plain:.4f}), dq sum {sweep[names[2]]:.4f} ms; "
                f"profiler: {recorded} recorded)  dq + dk/dv passes "
                f"{separate_ms:.4f} ms  twin {plain_ms:.4f} ms  bound "
                f"{bound_ms:.4f} ms ({bound_by})  sdpa backward "
                + (f"{library_ms:.4f} ms" if library_ms is not None
                   else "not measured"))
            if regime != "none":
                name = ("attn_stream_bwd_dcoeff" if regime == "poly"
                        else "attn_stream_bwd_dtable")
                by_name, _, _ = device_ms_by_kernel(
                    lambda: separate(True), 3 * iters, (name,))
                plain_ms = median_ms(
                    lambda: fa.attention_stream_bwd_plain(
                        q, k, v, out, g, lse, scale,
                        kv_tile=FUSED_TWIN_TILES["kv_tile"], want_dparam=True,
                        **kw), **twin_timing)
                bound_ms, bound_by = fused_bound_ms(shape, torch.float32, kw,
                                                    2, 0)
                param_rows[label][regime] = dict(
                    ms=by_name[name], plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None)
                log(f"  {label} {regime:5s} {name} kernel (with its sum) "
                    f"{by_name[name]:.4f} ms  twin (whole backward) "
                    f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})")
            del q, k, v, g, lse, out, kw
            torch.cuda.empty_cache()
    fused_rows["q_chunk 2048 epoch"] = {"none": time_fused_chunk(fa, device)}
    return fused_rows, param_rows


def time_fused_chunk(fa, device):
    """Phase 14b: the one-pass backward on the key chunk of most launches of
    the --q_chunk 2048 epoch: (4, 4, 2,048 rows, 4,608 keys, 32) f32, rows
    [2048, 4096) against every key, 4,097 valid, lse and delta of the
    whole rows. The wrapper by CUDA events, the sweep and the prologue by
    the profiler, the twin, the bound over the valid keys, and SDPA's
    backward on the same rows against the valid keys (all keys in one
    chunk: the same function)."""
    import torch.nn.functional as F

    shape, r0, rows, n_valid = (4, 4, 4608, 32), 2048, 2048, 4097
    (q, k, v, g, lse, delta, scale), _, _ = fused_inputs(
        fa, "none", shape, torch.float32, 740, device)
    args = (q[:, :, r0:r0 + rows], k, v, g[:, :, r0:r0 + rows],
            lse[:, :, r0:r0 + rows], delta[:, :, r0:r0 + rows], scale)
    del q, g

    def chunk():
        fa.streaming_chunk_bwd(*args, r0, 0, n_valid)

    names = ("attn_stream_bwd_fused_kernel",
             "attn_stream_bwd_fused_prologue_kernel")
    ms = median_ms(chunk, iters=10, reps=5, warmup=2)
    by_name, recorded, _ = device_ms_by_kernel(chunk, 20, names)
    plain_ms = median_ms(lambda: fa.attention_stream_bwd_fused_plain(
        *args, **FUSED_TWIN_TILES, n_valid=n_valid, row0=r0),
        iters=1, reps=3, warmup=1)
    b, h, _, d = shape
    flops = 5 * 2 * b * h * rows * n_valid * d
    nbytes = (4 * (4 * rows + 4 * shape[2]) * d + 4 * 2 * rows) * b * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                              else "operations")
    qr, kr, vr = (t.detach().clone().requires_grad_()
                  for t in (args[0], k[:, :, :n_valid], v[:, :, :n_valid]))
    go = args[3]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qr, kr, vr, scale=scale)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qr, kr, vr, scale=scale).backward(go)

    library_ms = (median_ms(sdpa_fwd_bwd, iters=10, reps=5, warmup=2)
                  - median_ms(sdpa_fwd, iters=10, reps=5, warmup=2))
    log(f"  q_chunk 2048 epoch chunk (4, 4, {rows} rows, {shape[2]} keys, "
        f"32) f32 none one-pass backward {ms:.4f} ms (sweep "
        f"{by_name[names[0]]:.4f} ms, prologue {by_name[names[1]]:.4f} ms; "
        f"profiler: {recorded} recorded)  twin {plain_ms:.4f} ms  bound "
        f"{bound_ms:.4f} ms ({bound_by})  sdpa backward {library_ms:.4f} ms")
    del args, qr, kr, vr, go
    torch.cuda.empty_cache()
    return dict(ms=ms, sweep_ms=by_name[names[0]],
                prologue_ms=by_name[names[1]], plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def chunk_case(fa, regime, dtype, seed, device, shape, rows, cols, n_valid):
    """The chunk kernel and its twin (at the kernel's key tile) on one chunk
    of a padded sequence: q rows `rows` against the keys `cols` (global
    indices), n_valid valid tokens; launched twice, bit-identical, one
    prologue before each launch. Returns {output: (max_abs_err, ok,
    share)}."""
    q, k, v, kw, _ = stream_inputs(fa, regime, shape, dtype, seed, device)
    pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
    args = (q[:, :, rows[0]:rows[1]], k[:, :, cols[0]:cols[1]],
            v[:, :, cols[0]:cols[1]], shape[-1] ** -0.5)
    counts = (fa.LAUNCHES_STREAM_FWD_PROLOGUE, fa.LAUNCHES_STREAM_CHUNK_FWD)
    out, lse = fa.streaming_chunk_fwd(*args, rows[0], cols[0], n_valid, **pe)
    again, again_lse = fa.streaming_chunk_fwd(*args, rows[0], cols[0],
                                              n_valid, **pe)
    torch.cuda.synchronize()
    same = (torch.equal(out, again) and torch.equal(lse, again_lse)
            and (fa.LAUNCHES_STREAM_FWD_PROLOGUE,
                 fa.LAUNCHES_STREAM_CHUNK_FWD)
            == (counts[0] + 2, counts[1] + 2))
    del again, again_lse
    want, want_lse = fa.attention_stream_plain(
        *args, kv_tile=fa.STREAM_TILE, row0=rows[0], col0=cols[0],
        n_valid=n_valid, **pe)
    lse_err = float((lse - want_lse).abs().max())
    return {"out": share_err(out, want, STREAM_TOL[dtype]),
            "lse": (lse_err, lse_err <= LSE_TOL and
                    bool(torch.isfinite(lse).all()), lse_err),
            "relaunch": (0.0, same, 0.0 if same else 1.0)}


def check_chunk_vs_twin(fa, device):
    """Phase 15a: the chunk forward kernel against its twin in three
    regimes: at a small padded sequence (1,100 valid tokens of 1,536 rows,
    rows [512, 1536) against the 1,033 keys from token 300), f32 and bf16;
    at the bounded step's own shapes at N=65,537 (the second q-chunk of
    16,384 rows and the last of 512, 511 of them padded, against all 66,048
    keys). Then at (r0, 0) against every key of a whole sequence, against
    the rows of attention_stream_fwd on the same tensors, bit for bit.
    Returns the worst f32 error of out."""
    worst, failed = 0.0, []
    cases = [((2, 4, 1536, 32), dtype, regime, (512, 1536), (300, 1333), 1100)
             for dtype in (torch.float32, torch.bfloat16)
             for regime in ("none", "poly", "rel")]
    big = (1, 4, 66048, 32)
    cases += [(big, torch.float32, regime, rows, (0, 66048), 65537)
              for regime in ("none", "poly", "rel")
              for rows in ((16384, 32768), (65536, 66048))]
    for i, (shape, dtype, regime, rows, cols, n_valid) in enumerate(cases):
        res = chunk_case(fa, regime, dtype, 700 + i, device, shape, rows,
                         cols, n_valid)
        ok = all(r[1] for r in res.values())
        log(f"chunk fwd vs twin  rows {rows} keys {cols} of {n_valid} valid "
            f"D={shape[3]} {str(dtype)[6:]:8s} {regime:5s} "
            + " ".join(f"{k}={v[0]:.2e}({v[2]:.1e})" for k, v in res.items())
            + f" tol(share of largest)={STREAM_TOL[dtype]:g} lse "
            f"{LSE_TOL:g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((regime, rows, cols, dtype))
        if dtype == torch.float32:
            worst = max(worst, res["out"][0])
        torch.cuda.empty_cache()
    for i, (dtype, regime) in enumerate(
            (dtype, regime) for dtype in (torch.float32, torch.bfloat16)
            for regime in ("none", "poly", "rel")):
        q, k, v, kw, _ = stream_inputs(fa, regime, (4, 4, 4097, 32), dtype,
                                       720 + i, device)
        pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
        whole, whole_lse = fa.attention_stream_fwd(q, k, v, 32 ** -0.5, **pe)
        got, lse = fa.streaming_chunk_fwd(q[:, :, 2048:], k, v, 32 ** -0.5,
                                          2048, 0, 4097, **pe)
        torch.cuda.synchronize()
        same = (torch.equal(got, whole[:, :, 2048:])
                and torch.equal(lse, whole_lse[:, :, 2048:]))
        log(f"chunk fwd at (2048, 0) vs attention_stream_fwd rows, N=4097 "
            f"{str(dtype)[6:]:8s} {regime:5s} bit-identical: "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            failed.append((regime, "bit identity", dtype))
    if failed:
        raise AssertionError(f"chunk forward kernel disagrees: {failed}")
    return worst


def bounded_inputs(vit, ts, datasets, cfg, batch, device, seed=15):
    """Seeded params, preprocess and a batch of random uint8 images at the
    model's size, labels 0, 1, ..."""
    mean, std = datasets.NORMALIZATION["cifar10"]
    pre = ts.make_preprocess(cfg, mean, std, cfg.img_size)
    params = vit.init_params(torch.Generator().manual_seed(seed), cfg,
                             device=device)
    images = np.random.default_rng(seed).integers(
        0, 256, (batch, cfg.img_size, cfg.img_size, 3), dtype=np.uint8)
    labels = torch.arange(batch, device=device) % 10
    return params, pre, torch.from_numpy(images).to(device), labels


def bounded_grads(modules, cfg, params, pre, images, labels, expected,
                  **kw):
    """One bounded step (AdamW on a copy of params) with the counts reset
    just before and read just after, held to `expected`. Returns (loss,
    gradients, counts)."""
    fa, fused_adamw, ts, make_bounded_step, TrainConfig = modules
    tcfg = TrainConfig(dataset="cifar10")
    copy = {k: v.detach().clone() for k, v in params.items()}
    init, update = ts.make_optimizer(tcfg, 100, copy)
    step = make_bounded_step(cfg, tcfg, update, pre, debug_grads=True, **kw)
    state = init(copy)
    expected = with_prologues(expected)
    reset_counts(fa, fused_adamw)
    _, _, metrics, grads = step(copy, state, 0, images, labels)
    counts = read_counts(fa, fused_adamw)
    if counts != expected:
        raise AssertionError(f"bounded step launches {counts} differ from "
                             f"{expected}")
    return float(metrics[0]), grads, counts


def monolithic_grads(ts, cfg, params, pre, images, labels):
    """The loss and gradients of the port's monolithic route (the
    whole-sequence streaming forward and the one-pass backward)."""
    p = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    mask = torch.ones(labels.shape, device=labels.device)
    loss_sum, _ = ts._loss_and_metrics(p, images, labels, mask, cfg, pre)
    loss = loss_sum / labels.shape[0]
    grads = torch.autograd.grad(loss, list(p.values()))
    return float(loss.detach()), dict(zip(p, grads))


def compare_grads(label, loss, grads, want_loss, want):
    """Loss relative error and the worst gradient share of its largest
    entry, held to BOUNDED_LOSS_TOL / BOUNDED_GRAD_TOL."""
    loss_err = abs(loss - want_loss) / abs(want_loss)
    shares = {key: share_err(grads[key], want[key], BOUNDED_GRAD_TOL)
              for key in want}
    worst_key = max(shares, key=lambda key: shares[key][2])
    worst = shares[worst_key][2]
    ok = (loss_err <= BOUNDED_LOSS_TOL and set(grads) == set(want)
          and all(r[1] for r in shares.values()) and math.isfinite(loss))
    log(f"  {label}: loss {loss:.6f} vs {want_loss:.6f} (rel {loss_err:.2e}, "
        f"tol {BOUNDED_LOSS_TOL:g}); worst gradient {worst_key} "
        f"{worst:.2e} of its largest entry (tol {BOUNDED_GRAD_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: the two steps disagree")
    return dict(loss=loss, want_loss=want_loss, loss_rel_err=loss_err,
                worst_grad_share=worst, worst_grad=worst_key)


def check_bounded_steps(modules, vit, datasets, ViTConfig, device):
    """Phase 15b-d. The bounded step against the monolithic step at
    N=65,537 (rope-axial, polynomial, relative), on the same batch and init,
    with exact launch counts; the relative step with key segments of 32,768
    against the unsegmented one; grad_accum 2 on two batches of 2 against
    one step on the batch of 4 at N=4,097."""
    fa, fused_adamw, ts, _, _ = modules
    out = {}
    heads, dh = BOUNDED["num_heads"], BOUNDED["embed_dim"] // BOUNDED[
        "num_heads"]
    for pe_name in ("rope-axial", "polynomial", "relative"):
        cfg = ViTConfig(**BOUNDED, pos_encoding=pe_name)
        params, pre, images, labels = bounded_inputs(vit, ts, datasets, cfg,
                                                     1, device)
        n_fwd, n_bwd = bounded_launches(fa, 1, heads, dh, cfg.seq_len,
                                        BOUNDED_Q_CHUNK)
        expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 1,
                    "attn_stream_chunk_fwd": cfg.depth * n_fwd,
                    "attn_stream_bwd_fused": cfg.depth * n_bwd}
        loss, grads, counts = bounded_grads(modules, cfg, params, pre, images,
                                            labels, expected,
                                            q_chunk=BOUNDED_Q_CHUNK)
        log(f"  bounded step {pe_name} N={cfg.seq_len}: launches {counts}")
        want_loss, want = monolithic_grads(ts, cfg, params, pre, images,
                                           labels)
        out[pe_name] = compare_grads(f"bounded vs monolithic {pe_name} "
                                     f"N={cfg.seq_len}", loss, grads,
                                     want_loss, want)
        out[pe_name]["launches"] = counts
        del want
        if pe_name == "relative":
            n_fwd, n_bwd = bounded_launches(fa, 1, heads, dh, cfg.seq_len,
                                            BOUNDED_Q_CHUNK, 32768)
            expected.update(attn_stream_chunk_fwd=cfg.depth * n_fwd,
                            attn_stream_bwd_fused=cfg.depth * n_bwd)
            seg_loss, seg_grads, counts = bounded_grads(
                modules, cfg, params, pre, images, labels, expected,
                q_chunk=BOUNDED_Q_CHUNK, kv_chunk=32768)
            log(f"  bounded step relative kv_chunk=32768: launches {counts}")
            out["relative kv_chunk=32768"] = compare_grads(
                "key segments of 32,768 vs unsegmented, relative", seg_loss,
                seg_grads, loss, grads)
            out["relative kv_chunk=32768"]["launches"] = counts
        del params, grads, images
        torch.cuda.empty_cache()
    cfg = ViTConfig(**LONGSEQ, pos_encoding="relative")
    params, pre, images, labels = bounded_inputs(vit, ts, datasets, cfg, 4,
                                                 device)
    n_fwd, n_bwd = bounded_launches(fa, 2, heads, dh, cfg.seq_len, 2048)
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 1,
                "attn_stream_chunk_fwd": 2 * cfg.depth * n_fwd,
                "attn_stream_bwd_fused": 2 * cfg.depth * n_bwd}
    accum_loss, accum_grads, counts = bounded_grads(
        modules, cfg, params, pre, images.reshape(2, 2, *images.shape[1:]),
        labels.reshape(2, 2), expected, q_chunk=2048, grad_accum=2)
    log(f"  bounded step grad_accum=2 N={cfg.seq_len}: launches {counts}")
    n_fwd, n_bwd = bounded_launches(fa, 4, heads, dh, cfg.seq_len, 2048)
    expected.update(attn_stream_chunk_fwd=cfg.depth * n_fwd,
                    attn_stream_bwd_fused=cfg.depth * n_bwd)
    loss, grads, _ = bounded_grads(modules, cfg, params, pre, images, labels,
                                   expected, q_chunk=2048)
    out["relative grad_accum=2 N=4097"] = compare_grads(
        "grad_accum 2 x batch 2 vs one batch of 4, relative N=4097",
        accum_loss, accum_grads, loss, grads)
    out["relative grad_accum=2 N=4097"]["launches"] = counts
    torch.cuda.empty_cache()
    return out


def measure_rope_axial_gap(modules, vit, datasets, ViTConfig, device):
    """Phase 15e: where the rope-axial gap between the bounded and the
    monolithic step comes from. At N=4,097 (batch 4) both steps' gradients
    against the unfused f32 oracle and against each other; and whether the
    bounded step's rotation of q and k in PyTorch (train/bounded.py `_pre`)
    differs from the kernels' own: the chunk forward on q and k rotated in
    PyTorch against the whole-sequence forward rotating them itself, on the
    same tensors, bit for bit."""
    from vit_rpe_rope_tpu_torch.ops.rotary import rotate_half_split

    fa, fused_adamw, ts, _, _ = modules
    cfg = ViTConfig(**LONGSEQ, pos_encoding="rope-axial")
    heads, dh = cfg.num_heads, cfg.head_dim
    params, pre, images, labels = bounded_inputs(vit, ts, datasets, cfg, 4,
                                                 device)
    n_fwd, n_bwd = bounded_launches(fa, 4, heads, dh, cfg.seq_len, 2048)
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 1,
                "attn_stream_chunk_fwd": cfg.depth * n_fwd,
                "attn_stream_bwd_fused": cfg.depth * n_bwd}
    b_loss, b_grads, _ = bounded_grads(modules, cfg, params, pre, images,
                                       labels, expected, q_chunk=2048)
    m_loss, m_grads = monolithic_grads(ts, cfg, params, pre, images, labels)
    o_loss, o_grads = monolithic_grads(
        ts, dataclasses.replace(cfg, attention_impl="reference"), params, pre,
        images, labels)
    out = {}
    for label, loss, grads, want_loss, want in (
            ("bounded vs f32 oracle", b_loss, b_grads, o_loss, o_grads),
            ("monolithic vs f32 oracle", m_loss, m_grads, o_loss, o_grads),
            ("bounded vs monolithic", b_loss, b_grads, m_loss, m_grads)):
        shares = {key: share_err(grads[key], want[key], 1.0)[2]
                  for key in want}
        worst = max(shares, key=shares.get)
        out[label] = dict(loss_rel_err=abs(loss - want_loss) / abs(want_loss),
                          worst_grad=worst, worst_grad_share=shares[worst],
                          norm1_weight_share=shares["blocks.0.norm1.weight"])
        log(f"  rope-axial N={cfg.seq_len} {label}: loss rel "
            f"{out[label]['loss_rel_err']:.3e}; worst gradient {worst} "
            f"{shares[worst]:.3e} of its largest entry; blocks.0.norm1.weight "
            f"{shares['blocks.0.norm1.weight']:.3e}")
    del b_grads, m_grads, o_grads
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(16)
    n = cfg.seq_len
    q, k, v = (torch.randn((4, heads, n, dh), generator=gen).to(device)
               for _ in range(3))
    from vit_rpe_rope_tpu_torch import pe as pe_registry

    cos, sin = fa._kernel_freqs(pe_registry.get("rope-axial").freqs_cis(
        params, cfg, device=device), heads, n, device)
    whole, whole_lse = fa.attention_stream_fwd(q, k, v, dh ** -0.5, cos=cos,
                                               sin=sin)
    rq = rotate_half_split(q, cos[None], sin[None])
    rk = rotate_half_split(k, cos[None], sin[None])
    chunk, chunk_lse = fa.streaming_chunk_fwd(rq, rk, v, dh ** -0.5, 0, 0, n)
    torch.cuda.synchronize()
    out["rotation_bit_identical"] = bool(torch.equal(whole, chunk)
                                         and torch.equal(whole_lse, chunk_lse))
    out["rotation_max_abs_diff"] = float((whole - chunk).abs().max())
    log(f"  q, k rotated in PyTorch then the chunk forward vs the "
        f"whole-sequence forward rotating in the kernel: bit-identical "
        f"{out['rotation_bit_identical']} (max |diff| "
        f"{out['rotation_max_abs_diff']:.3e})")
    return out


def chunk_bound_ms(shape, rows, keys, valid_keys, dtype, kw):
    """Least time for one chunk forward kernel: q and out (rows, in the
    input dtype), the prologue's bf16 k and v (keys), lse and the bias
    generator read or written once over the memory rate, against the two
    products over the keys this run needs (the valid ones) at the bf16
    tensor-core peak."""
    b, h, _, d = shape
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * rows * elem + 2 * keys * 2) * b * h * d + b * h * rows * 4
    for key in ("poly", "rel"):
        if kw.get(key) is not None:
            gen = kw[key][0] if key == "poly" else kw[key]
            nbytes += gen.numel() * 4
    flops = 4 * b * h * rows * valid_keys * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_chunk_kernel(fa, device):
    """Phase 15f: the chunk forward at the bounded step's shape at
    N=65,537 (the second q-chunk, 16,384 rows, against all 66,048 keys, f32)
    in three regimes, and at the shape of most launches of the --q_chunk
    2048 epoch (batch 4, the second q-chunk of 2,048 rows against the 4,608
    keys of N=4,097, no bias): the wrapper by CUDA events, its kernel and
    its prologue (the chunk's keys rounded once) by the profiler's device
    time, its twin, its bound, and SDPA on the same rows against the valid
    keys (no mask: the same function) as the yardstick for the plain
    regime. Returns {label: the kernel's row (the wrapper as its group),
    label + " prologue": the prologue's}."""
    import torch.nn.functional as F

    rows = {}
    bounded = ((1, 4, 66048, 32), 16384, BOUNDED_Q_CHUNK, 65537)
    for label, regime, (shape, r0, n_rows, n_valid) in (
            ("none", "none", bounded), ("poly", "poly", bounded),
            ("rel", "rel", bounded),
            ("epoch none", "none", ((4, 4, 4608, 32), 2048, 2048, 4097))):
        q, k, v, kw, _ = stream_inputs(fa, regime, shape, torch.float32, 730,
                                       device)
        pe = {key: kw[key] for key in ("poly", "rel") if key in kw}
        qc = q[:, :, r0:r0 + n_rows]
        scale = 32 ** -0.5

        def chunk():
            fa.streaming_chunk_fwd(qc, k, v, scale, r0, 0, n_valid, **pe)

        wrapper_ms = median_ms(chunk, iters=5, reps=5, warmup=2)
        by_name, _, _ = device_ms_by_kernel(
            chunk, 8, ("attn_stream_fwd_kernel",
                       "attn_stream_fwd_prologue_kernel"))
        ms = by_name["attn_stream_fwd_kernel"]
        prologue_ms = by_name["attn_stream_fwd_prologue_kernel"]
        plain_ms = median_ms(lambda: fa.attention_stream_plain(
            qc, k, v, scale, kv_tile=fa.STREAM_TILE, row0=r0,
            n_valid=n_valid, **pe), iters=1, reps=2, warmup=1)
        library_ms = None
        if regime == "none":
            kv, vv = k[:, :, :n_valid], v[:, :, :n_valid]
            library_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qc, kv, vv, scale=scale), iters=5, reps=5, warmup=2)
        bound_ms, bound_by = chunk_bound_ms(shape, n_rows, shape[2], n_valid,
                                            torch.float32, pe)
        group = dict(group="streaming_chunk_fwd", group_ms=wrapper_ms,
                     group_library_ms=library_ms)
        rows[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=bound_ms, bound_by=bound_by, **group)
        # the prologue: k and v read once in f32, written once in bf16
        pro_bound = 2 * k.numel() * (4 + 2) / HBM_BYTES_PER_S * 1e3
        pro_plain = median_ms(lambda: fa.attention_stream_fwd_prologue_plain(
            k, v), iters=5, reps=3, warmup=1)
        rows[label + " prologue"] = dict(
            ms=prologue_ms, plain_ms=pro_plain, library_ms=None,
            bound_ms=pro_bound, bound_by="bytes", **group)
        log(f"  chunk fwd ({shape[0]}, 4, {n_rows} rows, {shape[2]} keys, "
            f"32) f32 {regime:5s} kernel {ms:.4f} ms  prologue "
            f"{prologue_ms:.4f} ms (bound {pro_bound:.4f}, twin "
            f"{pro_plain:.4f})  wrapper {wrapper_ms:.4f} ms  twin "
            f"{plain_ms:.4f} ms  bound {bound_ms:.4f} ms ({bound_by})  sdpa "
            + (f"{library_ms:.4f} ms" if library_ms is not None
               else "not measured (it would need a 17 GB mask)"))
        del q, k, v, kw, pe, qc
        torch.cuda.empty_cache()
    return rows


def time_bounded_steps(modules, vit, datasets, ViTConfig, device, n_steps=3):
    """Phase 15g: wall time per train step (synchronized) of the bounded
    and the monolithic step at N=65,537, batch 1, f32, in rope-axial,
    polynomial and relative, each after one warm-up step, in turns (bounded,
    monolithic, monolithic, bounded); a profiler breakdown of one bounded
    rope-axial step. Returns ({label: {bounded_ms, monolithic_ms}},
    profile)."""
    fa, fused_adamw, ts, make_bounded_step, TrainConfig = modules
    tcfg = TrainConfig(dataset="cifar10")
    rows, trace = {}, {}
    for pe_name in ("rope-axial", "polynomial", "relative"):
        cfg = ViTConfig(**BOUNDED, pos_encoding=pe_name)
        params, pre, images, labels = bounded_inputs(vit, ts, datasets, cfg,
                                                     1, device)
        params = {k: v.requires_grad_() for k, v in params.items()}
        init, update = ts.make_optimizer(tcfg, 100, params)
        bounded = make_bounded_step(cfg, tcfg, update, pre,
                                    q_chunk=BOUNDED_Q_CHUNK)
        mono = ts.make_train_step(cfg, update, pre)
        idx = torch.zeros((1, 1), dtype=torch.int64, device=device)
        state = [params, init(params)]

        def run_bounded():
            state[0], state[1], m = bounded(state[0], state[1], 0, images,
                                            labels)
            return m

        def run_mono():
            state[0], state[1], m = mono(state[0], state[1], 0, images,
                                         labels, idx)
            return m

        times = {"bounded": [], "monolithic": []}
        for label, run in (("bounded", run_bounded), ("monolithic", run_mono),
                           ("monolithic", run_mono), ("bounded", run_bounded)):
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_steps):
                run()
            torch.cuda.synchronize()
            times[label].append((time.perf_counter() - t0) * 1e3 / n_steps)
        rows[f"N=65537 {pe_name} f32"] = {
            f"{label}_ms": statistics.mean(t) for label, t in times.items()}
        log(f"  train step N=65537 {pe_name} f32 batch 1: bounded "
            f"(q_chunk {BOUNDED_Q_CHUNK}) {times['bounded']} ms, monolithic "
            f"{times['monolithic']} ms (two turns each, {n_steps} steps a "
            f"turn)")
        if pe_name == "rope-axial":
            trace = profile_train_step(run_bounded, n_iter=1)
        del params, state, images, bounded, mono
        torch.cuda.empty_cache()
    return rows, trace


def block_stack(vit, cfg, device, seed, depth=None):
    """`depth` (default BLOCK_DEPTH) blocks' seeded params (the init with
    every parameter moved by 0.05 times a normal draw, so that the logits
    spread over several units and the attention is far from uniform) and
    the rope-axial tables, rope-mixed's per-head tables (its frequencies
    moved alike) or None."""
    depth = depth or BLOCK_DEPTH
    params = vit.init_params(torch.Generator().manual_seed(seed),
                             dataclasses.replace(cfg, depth=depth),
                             device=device)
    gen = torch.Generator().manual_seed(seed + 1)
    blocks = [{name: params[f"blocks.{i}.{name}"] + 0.05 * torch.randn(
                   params[f"blocks.{i}.{name}"].shape, generator=gen).to(device)
               for name in vit.BLOCK_PARAM_NAMES}
              for i in range(depth)]
    freqs = None
    if cfg.pos_encoding in ("rope-axial", "rope-mixed"):
        from vit_rpe_rope_tpu_torch import pe as pe_registry

        pe_mod = pe_registry.get(cfg.pos_encoding)
        pe_params = {name: t + 0.05 * torch.randn(t.shape, generator=gen)
                     for name, t in pe_mod.init_params(gen, cfg).items()}
        freqs = pe_mod.freqs_cis(pe_params, cfg, device=device)
    return blocks, freqs


def update_share(got, want, x):
    """max |got - want| and its share of the largest entry of the blocks'
    update want - x (the residual x alone would hide the update's errors
    under its own size). For bf16 outputs, only what lies beyond one bf16
    ulp of each entry: two float32 values a little apart may round to
    neighbouring bf16 values."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.bfloat16:
        _, exponent = torch.frexp(want.float())
        diff = (diff - torch.ldexp(torch.ones_like(diff), exponent - 8)
                ).clamp(min=0)
    err = float(diff.max())
    share = err / float((want.float() - x.float()).abs().max())
    return err, share if bool(torch.isfinite(got).all()) else math.inf


def check_block_fused(block_fused, vit, ViTConfig, device):
    """Phase 16a: row 12 against its twin on the card at ViT-tiny/4 (batch
    128, N=65, E=192, 6 heads of 32, hidden 768; one CTA an image) and at
    ViT-S/16@224 (batch 64, N=197, E=384, 6 heads of 64, hidden 1536; a
    cluster of CTAs an image), f32 and bf16 inputs, and at the CPU tests'
    shape (batch 2, N=17, E=64, 2 heads), in none and rope-axial, and at
    ViT-tiny/4 in f32 with rope-mixed's per-head tables (every head rotated
    by head 0's, as in the JAX package); every case launched twice,
    bit-identical; the weight prologue against its twin bit for bit at
    each configuration's plan. Returns the worst max |kernel - twin| at
    ViT-tiny/4 in f32, and the prologue's (0 when bit-identical)."""
    worst, prologue_err = 0.0, 0.0
    vit_s = dict(img_size=224, patch_size=16, embed_dim=384, num_heads=6)
    for label, kw, batch, dtypes, pe_names in (
            ("ViT-tiny/4", {}, 128, (torch.float32, torch.bfloat16),
             ("none", "rope-axial")),
            ("ViT-tiny/4", {}, 128, (torch.float32,), ("rope-mixed",)),
            ("ViT-S/16@224", vit_s, 64, (torch.float32, torch.bfloat16),
             ("none", "rope-axial")),
            ("CPU test shape", dict(img_size=16, embed_dim=64, num_heads=2),
             2, (torch.float32,), ("none", "rope-axial"))):
        for pe_name in pe_names:
            cfg = ViTConfig(**kw, pos_encoding=pe_name)
            blocks, freqs = block_stack(vit, cfg, device, 30)
            plan = block_fused.block_plan(cfg.seq_len, cfg.embed_dim,
                                          cfg.head_dim, cfg.mlp_hidden_dim)
            for dtype in dtypes:
                x = torch.randn((batch, cfg.seq_len, cfg.embed_dim),
                                generator=torch.Generator().manual_seed(31))
                x = x.to(device, dtype)
                got = block_fused.block_forward(x, blocks[0], cfg, freqs)
                again = block_fused.block_forward(x, blocks[0], cfg, freqs)
                want = block_fused.block_forward_plain(x, blocks[0], cfg,
                                                       freqs)
                tol = BLOCK_FUSED_TOL
                err, share = update_share(got, want, x)
                ok = share <= tol and torch.equal(got, again)
                log(f"  fused block vs twin {label} B={batch} N={cfg.seq_len} "
                    f"{pe_name} {str(dtype)[6:]} (cluster {plan['CLUSTER']}, "
                    f"{plan['TILES']} row tiles a CTA, {plan['SMEM']} bytes): "
                    f"max_abs_err={err:.3e} ({share:.2e} of the update's "
                    f"largest entry, tol {tol:g}); second launch "
                    f"bit-identical {torch.equal(got, again)} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"the fused block kernel disagrees "
                                         f"with its twin: {label} {pe_name}")
                if label == "ViT-tiny/4" and dtype == torch.float32:
                    worst = max(worst, err)
            tiles = block_fused.block_weights_bf16(blocks[0], device,
                                                   cfg.head_dim, plan["KT"])
            twin = block_fused.block_weights_bf16_plain(blocks[0],
                                                        cfg.head_dim,
                                                        plan["KT"])
            if not torch.equal(tiles, twin):
                prologue_err = float((tiles.float() - twin.float()).abs()
                                     .max())
                raise AssertionError(f"the weight prologue differs from its "
                                     f"twin at {label}: {prologue_err:.3e}")
        log(f"  weight prologue vs twin {label}: bit-identical")
    return worst, prologue_err


def encoder_layers(blocks, cfg, device):
    """torch.nn.TransformerEncoderLayer (pre-LN, exact GELU, eval) loaded
    with the blocks' weights: one PyTorch call per block, the yardstick of
    row 12 in `none` (the qkv product has no bias here: zeros)."""
    layers = []
    for bp in blocks:
        layer = torch.nn.TransformerEncoderLayer(
            cfg.embed_dim, cfg.num_heads, cfg.mlp_hidden_dim, dropout=0.0,
            activation="gelu", norm_first=True, batch_first=True,
            layer_norm_eps=cfg.layer_norm_eps).to(device).eval()
        with torch.no_grad():
            for dst, name in (
                    (layer.self_attn.in_proj_weight, "attn.qkv.weight"),
                    (layer.self_attn.out_proj.weight, "attn.proj.weight"),
                    (layer.self_attn.out_proj.bias, "attn.proj.bias"),
                    (layer.linear1.weight, "mlp.fc1.weight"),
                    (layer.linear1.bias, "mlp.fc1.bias"),
                    (layer.linear2.weight, "mlp.fc2.weight"),
                    (layer.linear2.bias, "mlp.fc2.bias"),
                    (layer.norm1.weight, "norm1.weight"),
                    (layer.norm1.bias, "norm1.bias"),
                    (layer.norm2.weight, "norm2.weight"),
                    (layer.norm2.bias, "norm2.bias")):
                dst.copy_(bp[name])
            layer.self_attn.in_proj_bias.zero_()
        layers.append(layer)
    return layers


def block_bound_ms(cfg, batch, depth):
    """Least time for `depth` blocks' forward: x read and the output written
    once, every block's weights read once over the memory rate, against the
    products (qkv, proj, fc1, fc2 and the two attention products) at the
    bf16 tensor-core peak."""
    e, n, h, dh = cfg.embed_dim, cfg.seq_len, cfg.num_heads, cfg.head_dim
    hid = cfg.mlp_hidden_dim
    rows = batch * n
    flops = depth * (2 * rows * (3 * e * e + e * e + 2 * e * hid)
                     + 2 * 2 * batch * h * n * n * dh)
    weights = (3 * e * e + e * e + 2 * e * hid) + (4 * e + hid + e)
    nbytes = 2 * rows * e * 4 + depth * weights * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_TENSOR_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def prologue_bound_ms(cfg):
    """Least time for one block's weight prologue: the four float32 matrices
    read once and each of their entries written once in bf16 (the tiles'
    padding is a layout of the kernel's, not work of the function)."""
    e, hid = cfg.embed_dim, cfg.mlp_hidden_dim
    nbytes = (4 * e * e + 2 * e * hid) * (4 + 2)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


# Row 12's timed forwards (phase 16b), f32: ViT-tiny/4 at its depth, batch
# 128, and ViT-S/16@224 (bench.py's STRETCH_KW) at its depth, batch 64.
BLOCK_TIMED = (("ViT-tiny/4", {}, 128, BLOCK_DEPTH, ("none", "rope-axial")),
               ("ViT-S/16@224", dict(img_size=224, patch_size=16,
                                     embed_dim=384, num_heads=6), 64, 12,
                ("none",)))


def time_block_fused(block_fused, fa, vit, ViTConfig, device):
    """Phase 16b: each BLOCK_TIMED forward (CUDA events, medians): the
    wrapper (exactly one kernel and one prologue launch per block), the
    kernel's and the prologue's device time by the profiler, the per-op
    block (models.vit._block_body with the row-1 kernel), the twin, and in
    none one TransformerEncoderLayer call per block; its bound. The weight
    prologue alone on one block (wrapper, twin, bound)."""
    out = {}
    for label, kw, batch, depth, pe_names in BLOCK_TIMED:
        for pe_name in pe_names:
            cfg = ViTConfig(**kw, pos_encoding=pe_name)
            blocks, freqs = block_stack(vit, cfg, device, 32, depth)
            x = torch.randn((batch, cfg.seq_len, cfg.embed_dim),
                            generator=torch.Generator().manual_seed(33))
            x = x.to(device)

            def chain(fn):
                def run():
                    y = x
                    for bp in blocks:
                        y = fn(y, bp)
                    return y
                return run

            fused = chain(lambda y, bp: block_fused.block_forward(y, bp, cfg,
                                                                  freqs))
            per_op = chain(lambda y, bp: vit._block_body(bp, y, cfg, None,
                                                         freqs, "flash"))
            twin = chain(lambda y, bp: block_fused.block_forward_plain(
                y, bp, cfg, freqs))
            plan = block_fused.block_plan(cfg.seq_len, cfg.embed_dim,
                                          cfg.head_dim, cfg.mlp_hidden_dim)
            with torch.inference_mode():
                block_fused.LAUNCHES_BLOCK_FUSED = fa.LAUNCHES = 0
                block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE = 0
                y = fused()
                torch.cuda.synchronize()
                launches = block_fused.LAUNCHES_BLOCK_FUSED
                prologues = block_fused.LAUNCHES_BLOCK_FUSED_PROLOGUE
                if launches != depth or prologues != depth or fa.LAUNCHES:
                    raise AssertionError(
                        f"{depth} blocks launched the fused kernel {launches}"
                        f" times, its prologue {prologues} (and attn_fwd "
                        f"{fa.LAUNCHES})")
                y_op = per_op()
                share = update_share(y, y_op, x)[1]
                device_ms, _, _ = device_ms_by_kernel(
                    fused, 8, ("block_fused_kernel",
                               "block_fused_prologue_kernel"))
                times = dict(ms=median_ms(fused),
                             device_ms=depth * device_ms["block_fused_kernel"],
                             prologue_device_ms=depth * device_ms[
                                 "block_fused_prologue_kernel"],
                             per_op_ms=median_ms(per_op),
                             plain_ms=median_ms(twin, iters=5, reps=3),
                             library_ms=None, launches=launches,
                             prologue_launches=prologues,
                             vs_per_op_share=share, cluster=plan["CLUSTER"],
                             active_clusters=block_fused.ACTIVE_CLUSTERS)
                if pe_name == "none":
                    layers = encoder_layers(blocks, cfg, device)

                    def library():
                        y_l = x
                        for layer in layers:
                            y_l = layer(y_l)
                        return y_l

                    times["vs_library_share"] = update_share(y, library(),
                                                             x)[1]
                    times["library_ms"] = median_ms(library)
                    if times["vs_library_share"] > LOGITS_TOL:
                        raise AssertionError("TransformerEncoderLayer "
                                             "computes another block")
                bp = blocks[0]
                times["prologue"] = dict(
                    ms=median_ms(lambda: block_fused.block_weights_bf16(
                        bp, device, cfg.head_dim, plan["KT"])),
                    plain_ms=median_ms(
                        lambda: block_fused.block_weights_bf16_plain(
                            bp, cfg.head_dim, plan["KT"]), iters=5, reps=3),
                    library_ms=None)
                (times["prologue"]["bound_ms"],
                 times["prologue"]["bound_by"]) = prologue_bound_ms(cfg)
            if share > LOGITS_TOL:
                raise AssertionError("the fused block and the per-op block "
                                     "compute different blocks")
            times["bound_ms"], times["bound_by"] = block_bound_ms(cfg, batch,
                                                                  depth)
            log(f"  {depth}-block forward {label} B={batch} {pe_name} f32 "
                f"(cluster {plan['CLUSTER']}, {times['active_clusters']} "
                f"resident): fused wrapper {times['ms']:.4f} ms ({launches} "
                f"launches), kernel device {times['device_ms']:.4f}, weight "
                f"prologue device {times['prologue_device_ms']:.4f}, per-op "
                f"block {times['per_op_ms']:.4f}, twin "
                f"{times['plain_ms']:.4f}, TransformerEncoderLayer "
                f"{times['library_ms']}, bound {times['bound_ms']:.4f} "
                f"({times['bound_by']}); vs the per-op block {share:.2e} of "
                f"the update's largest entry; the prologue alone "
                f"{times['prologue']['ms']:.4f} ms (twin "
                f"{times['prologue']['plain_ms']:.4f}, bound "
                f"{times['prologue']['bound_ms']:.4f})")
            out[f"{label} {pe_name}"] = times
    return out


def check_flash_block_grads(vit, ViTConfig, fa, fused_adamw, device):
    """Phase 16c: attention_impl="flash_block" against "flash" on the
    kernels, every gradient within FLASH_BLOCK_TOL, at ViT-tiny/4 rope-mixed
    (N=65, batch 128: the dense kernels, dqr/dkr for the frequencies) and
    the long-sequence model in rope-axial (N=4,097, batch 4: the streaming
    forward and the one-pass backward), one step each, with exact launch
    counts of the flash_block step."""
    out = {}
    for label, cfg, batch, expected in (
            ("ViT-tiny/4 rope-mixed N=65", ViTConfig(pos_encoding="rope-mixed"),
             128, {"attn_fwd": 6, "attn_bwd": 6, "adamw": 0}),
            ("long-sequence rope-axial N=4097",
             ViTConfig(**LONGSEQ, pos_encoding="rope-axial"), 4,
             {"attn_fwd": 0, "attn_bwd": 0, "adamw": 0,
              "attn_stream_fwd": 2, "attn_stream_bwd_fused": 2})):
        init = vit.init_params(torch.Generator().manual_seed(34), cfg,
                               device=device)
        x = torch.randn((batch, cfg.img_size, cfg.img_size, 3),
                        generator=torch.Generator().manual_seed(35)).to(device)
        y = torch.arange(batch, device=device) % 10
        grads = {}
        for impl in ("flash", "flash_block"):
            c = dataclasses.replace(cfg, attention_impl=impl)
            params = {k: v.clone().requires_grad_() for k, v in init.items()}
            reset_counts(fa, fused_adamw)
            loss = torch.nn.functional.cross_entropy(vit.apply(params, x, c),
                                                     y)
            grads[impl] = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            counts = read_counts(fa, fused_adamw)
            if impl == "flash_block" and counts != with_prologues(
                    expected):
                raise AssertionError(f"{label}: flash_block launches {counts}"
                                     f" differ from {expected}")
        rel = {key: float((grads["flash_block"][key] - want).norm()
                          / want.norm().clamp(min=1e-30))
               for key, want in grads["flash"].items()}
        worst = max(rel, key=rel.get)
        ok = rel[worst] <= FLASH_BLOCK_TOL
        log(f"  flash_block vs flash {label} batch {batch}: launches "
            f"{counts}; worst gradient {worst} {rel[worst]:.2e} relative "
            f"(tol {FLASH_BLOCK_TOL:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{label}: flash_block and flash gradients "
                                 f"differ")
        out[label] = dict(worst_grad=worst, worst_rel=rel[worst],
                          launches=counts)
        del grads
        torch.cuda.empty_cache()
    return out


def poly_terms_inputs(fa, shape, dtype, seed, device, terms):
    """stream_inputs of the poly regime with `terms` coefficients per head
    (scaled by grid^-k as there)."""
    q, k, v, kw, _ = stream_inputs(fa, "poly", shape, dtype, seed, device)
    grid = kw["poly"][1]
    gen = torch.Generator().manual_seed(seed + 2)
    powers = torch.arange(terms).float()
    coeff = 0.05 * torch.randn((shape[1], terms), generator=gen) \
        * float(grid) ** -powers
    return q, k, v, dict(kw, poly=(coeff.to(device), grid))


def per_term(got, want):
    """{dcoeff[t]: share_err} for every term t, each term's gradient as a
    share of its own largest entry (the terms differ by powers of the
    distance, so one share over all of them would hide the highest)."""
    return {f"dcoeff[{t}]": share_err(got[..., t], want[..., t], PARAM_TOL)
            for t in range(want.shape[-1])}


def check_repaired_shapes(fa, device):
    """Phase 16d: the shapes the kernels refused before this slice, against
    their twins at the limits of phases 2, 6 and 11b. Head dim 48 (the
    kernels on zero-padded 64-wide heads, each rope half padded on its own)
    at ViT-tiny/4 with 4 heads, rope-mixed: attention_fwd and
    attention_bwd with dqr/dkr. Nine polynomial terms at N=4,097: the
    streaming forward, the separate-pass prologue, dq / dk / dv with the
    dcoeff kernel (one launch each, counted), and the one-pass backward,
    dcoeff per term. Returns the worst
    f32 share by case."""
    worst, failed = {}, []

    def report(label, dtype, res):
        ok = all(r[1] for r in res.values())
        log(f"  {label} {str(dtype)[6:]}: "
            + " ".join(f"{k}={v[0]:.2e}({v[2]:.1e})" if len(v) == 3 else
                       f"{k}={v[0]:.2e}" for k, v in res.items())
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append((label, dtype))
        if dtype == torch.float32:
            worst[label] = max(v[0] for v in res.values())

    d48 = (128, 4, 65, 48)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, kw = attn_inputs("rope-mixed", d48, dtype, 600, device)
        bias, cos, sin = fa.prepare_pe(d48[1], d48[2], device, **kw)
        got = fa.attention_fwd(q, k, v, d48[-1] ** -0.5, bias, cos, sin)
        torch.cuda.synchronize()
        want = fa.attention_plain(q, k, v, d48[-1] ** -0.5, bias, cos, sin)
        report(f"attn_fwd D=48 rope-mixed (tol {KERNEL_TOL[dtype]:g} abs+rel)",
               dtype, {"out": worst_err(got, want, KERNEL_TOL[dtype])})
        report(f"attn_bwd D=48 rope-mixed (tol {BWD_TOL[dtype]:g} abs+rel)",
               dtype, bwd_case(fa, "rope-mixed", d48, dtype, 601, device))
    del q, k, v, got, want

    longseq = (4, 4, 4097, 32)
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        q, k, v, kw = poly_terms_inputs(fa, longseq, dtype, 610 + i, device,
                                        9)
        scale = longseq[-1] ** -0.5
        res = fwd_relaunch(fa, q, k, v, scale, kw)
        out, lse = res.pop("outputs")
        want_out, want_lse = fa.attention_stream_plain(
            q, k, v, scale, kv_tile=fa.STREAM_TILE, **kw)
        lse_err = float((lse - want_lse).abs().max())
        res.update({"out": share_err(out, want_out, STREAM_TOL[dtype]),
                    "lse": (lse_err, lse_err <= LSE_TOL, lse_err)})
        report(f"attn_stream_fwd 9 terms (tol {STREAM_TOL[dtype]:g} of the "
               f"largest, lse {LSE_TOL:g}; relaunched bit for bit)", dtype,
               res)
        del want_out, want_lse
        g = torch.randn(longseq, generator=torch.Generator().manual_seed(
            620 + i)).to(device, dtype)
        counts = (fa.LAUNCHES_STREAM_PROLOGUE, fa.LAUNCHES_STREAM_DQ,
                  fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DCOEFF)
        got = fa.attention_stream_bwd(q, k, v, out, g, lse, scale,
                                      want_dparam=True, **kw)
        torch.cuda.synchronize()
        launched = tuple(after - before for after, before in zip(
            (fa.LAUNCHES_STREAM_PROLOGUE, fa.LAUNCHES_STREAM_DQ,
             fa.LAUNCHES_STREAM_DKV, fa.LAUNCHES_STREAM_DCOEFF), counts))
        want = fa.attention_stream_bwd_plain(
            q, k, v, out, g, lse, scale, kv_tile=FUSED_TWIN_TILES["kv_tile"],
            want_dparam=True, **kw)
        tol = STREAM_BWD_TOL[dtype]
        res = {name: share_err(x, y, tol)
               for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3])}
        res.update(per_term(got[6], want[6]))
        one_each = launched == (1, 1, 1, 1)
        res["launches (prologue, dq, dk/dv, dcoeff) 1 each"] = (
            0.0, one_each, 0.0 if one_each else 1.0)
        report(f"attn_stream_bwd + dcoeff 9 terms (tol {tol:g}, dcoeff "
               f"{PARAM_TOL:g} per term)", dtype, res)
        del got, want
        delta = (g.float() * out.float()).sum(dim=-1)
        args = (q, k, v, g, lse, delta, scale)
        got = fa.attention_stream_bwd_fused(*args, **kw)
        again = fa.attention_stream_bwd_fused(*args, **kw)
        torch.cuda.synchronize()
        want = fa.attention_stream_bwd_fused_plain(*args, **FUSED_TWIN_TILES,
                                                   **kw)
        res = {name: share_err(x, y, FUSED_TOL)
               for name, x, y in zip(("dq", "dk", "dv"), got[:3], want[:3])}
        res.update(per_term(got[3], want[3]))
        same = all(torch.equal(x, y) for x, y in zip(got[:4], again[:4]))
        res["two launches"] = (0.0, same, 0.0 if same else 1.0)
        report(f"attn_stream_bwd_fused 9 terms (tol {FUSED_TOL:g}, dcoeff "
               f"{PARAM_TOL:g} per term)", dtype, res)
        del q, k, v, g, out, lse, got, again, want, args
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"kernels disagree with their twins at the "
                             f"repaired shapes: {failed}")
    return worst


def check_regularised_training(train_modules, plain, plain_later, keep_dir):
    """Phase 17, path B: the ViT-tiny/4 train CLI at its defaults in
    rope-mixed with REGULARISED, twice with seed 0 and once with seed 1, then
    with --attn_drop_rate 0.1 as well; each run's launch counts are exact
    (train_through_cli; at the CLI's auto k, one CUDA graph of 25 steps a
    dispatch with the draws inside it). The first three launch the
    attention kernels and AdamW exactly as the unregularised epoch `plain`
    (phase 8) did; seed 0
    repeats its CSV row and seed 1 does not. The epochs' img/s are printed
    beside `plain`'s and `plain_later`'s (phase 16's, nearer in time: the
    epoch is host-bound). Returns the runs; the first one's best checkpoint
    is kept in keep_dir."""
    runs = {
        "seed 0": train_through_cli(
            "rope-mixed", train_modules, flags=REGULARISED,
            bar=REGULARISED_BAR,
            keep=os.path.join(keep_dir, "regularised.npz")),
        "seed 0 again": train_through_cli(
            "rope-mixed", train_modules, flags=REGULARISED,
            bar=REGULARISED_BAR),
        "seed 1": train_through_cli(
            "rope-mixed", train_modules, flags={**REGULARISED, "seed": 1},
            bar=REGULARISED_BAR),
        "attn_drop_rate 0.1": train_through_cli(
            "rope-mixed", train_modules,
            flags={**REGULARISED, "attn_drop_rate": 0.1},
            bar=REGULARISED_BAR)}
    keys = ("attn_fwd", "attn_bwd", "adamw", "adamw_table")
    want = {key: plain["launches"].get(key) for key in keys}
    log(f"  epoch img/s: unregularised (phase 8) "
        f"{plain['images_per_s']:.1f}, (phase 16) "
        f"{plain_later['images_per_s']:.1f}; "
        + "; ".join(f"{label} {run['images_per_s']:.1f}"
                    for label, run in runs.items()))
    log(f"  launches: unregularised {want}; "
        + "; ".join(f"{label} "
                    f"{dict((k, run['launches'].get(k)) for k in keys)}"
                    for label, run in runs.items()))
    for label in ("seed 0", "seed 0 again", "seed 1"):
        got = {key: runs[label]["launches"].get(key) for key in keys}
        if got != want:
            raise AssertionError(f"regularised epoch ({label}) launched "
                                 f"{got}, the unregularised one {want}")
    if runs["attn_drop_rate 0.1"]["launches"]["attn_bwd"] != 0:
        raise AssertionError("attention-prob dropout launched the backward "
                             "kernel")
    fields = ("train_loss", "train_acc", "test_loss", "test_acc")
    rows = {label: tuple(run["csv"][k] for k in fields)
            for label, run in runs.items()}
    log(f"  CSV rows {fields}: {rows}")
    if rows["seed 0"] != rows["seed 0 again"]:
        raise AssertionError("two regularised epochs with seed 0 differ")
    if rows["seed 0"] == rows["seed 1"]:
        raise AssertionError("seeds 0 and 1 gave the same regularised epoch")
    return runs


def figure_leaves(figures):
    """The arrays and the other values (kinds, names, grids, patterns) of a
    visualizer's figures(args), in order."""
    arrays, rest = [], []

    def walk(item):
        if isinstance(item, np.ndarray):
            arrays.append(item)
        elif isinstance(item, (tuple, list)):
            for x in item:
                walk(x)
        else:
            rest.append(item)

    walk(figures)
    return arrays, rest


def check_visualizers(modules, keep_dir, device, test_images):
    """Phase 17, path A: in a scratch directory whose checkpoints/ holds the
    regularised rope-mixed checkpoint and phase 8's relative one exported
    to .pth (utils.checkpoint.export_torch), each mode of both visualizer
    CLIs (auto-discovery, --load_model, --compare_models, --compare_thetas)
    computes its figures on the card, held to the same figures computed on
    the CPU (VIZ_TOL), and, where matplotlib is installed, draws them (every
    PNG written); then the exported .pth through the Predictor on the card
    against its .npz on one batch of test images (depth launches of
    attn_fwd)."""
    (fa, fused_adamw, serving, checkpoint, vit, ViTConfig, pe_cli,
     rope_cli) = modules
    drawing = importlib.util.find_spec("matplotlib") is not None
    cwd = os.getcwd()
    out = {"pngs": 0 if drawing else "not drawn: matplotlib is not "
                                     "installed"}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("checkpoints")
            mixed = shutil.copy(os.path.join(keep_dir, "regularised.npz"),
                                "checkpoints/cifar10_rope-mixed_best.npz")
            plain_mixed = os.path.join(keep_dir, "phase8_rope-mixed.npz")
            rel_npz = os.path.join(keep_dir, "phase8_relative.npz")
            rel_pth = checkpoint.export_torch(
                rel_npz, "checkpoints/cifar10_relative_best.pth")
            # rope-axial has no trained ViT-tiny/4 checkpoint in this run:
            # seeded random weights.
            axial_cfg = ViTConfig(pos_encoding="rope-axial")
            axial = checkpoint.save(
                "cifar10_rope-axial_seeded.npz",
                vit.init_params(torch.Generator().manual_seed(17), axial_cfg,
                                device="cpu"),
                vit.buffers(axial_cfg),
                aliases=vit.reference_alias_keys(axial_cfg))
            runs = [
                (pe_cli, []),  # auto-discovery of checkpoints/
                (pe_cli, ["--load_model", "--model_path", mixed,
                          "--model_config", "rope-mixed"]),
                (pe_cli, ["--compare_models", "--model_paths", plain_mixed,
                          mixed, rel_pth, "--model_configs", "rope-mixed",
                          "rope-mixed", "relative"]),
                (rope_cli, ["--compare_thetas"]),
                (rope_cli, ["--load_model", "--model_path", mixed,
                            "--model_config", "rope-mixed"]),
                (rope_cli, ["--compare_models", "--axial_model_path", axial,
                            "--mixed_model_path", mixed])]
            errs = []
            t0 = time.perf_counter()
            for i, (cli, argv) in enumerate(runs):
                name = cli.__name__.rsplit(".", 1)[-1]
                with contextlib.redirect_stdout(io.StringIO()) as text:
                    card = cli.figures(cli.get_args(
                        argv + ["--device", str(device)]))
                    cpu = cli.figures(cli.get_args(argv + ["--device", "cpu"]))
                if "Skipping" in text.getvalue():
                    raise AssertionError(f"{name} {argv}: {text.getvalue()}")
                (card_arrays, card_rest), (cpu_arrays, cpu_rest) = (
                    figure_leaves(card), figure_leaves(cpu))
                if card_rest != cpu_rest or len(card_arrays) != len(
                        cpu_arrays):
                    raise AssertionError(f"{name} {argv}: the card's figures "
                                         f"are not the CPU's: {card_rest} / "
                                         f"{cpu_rest}")
                err = max(float(np.max(np.abs(
                    a.astype(np.float64) - b.astype(np.float64))))
                    for a, b in zip(card_arrays, cpu_arrays))
                errs.append(err)
                drawn = []
                if drawing:
                    out_dir = os.path.join("visualizations", str(i))
                    with contextlib.redirect_stdout(io.StringIO()):
                        cli.main(argv + ["--device", str(device), "--dpi",
                                         "100", "--output_dir", out_dir])
                    drawn = sorted(os.listdir(out_dir))
                    if len(drawn) != len(card) or not all(
                            p.endswith(".png") for p in drawn):
                        raise AssertionError(f"{name} {argv}: {drawn} for "
                                             f"{len(card)} figures")
                    out["pngs"] += len(drawn)
                log(f"  {name} {' '.join(argv) or '(auto-discovery)'}: "
                    f"{len(card)} figure(s) {[kind for kind, _ in card]}, "
                    f"{len(card_arrays)} matrices, card vs CPU "
                    f"{err:.2e}; PNGs {drawn if drawing else out['pngs']}")
            out["seconds_cli"] = time.perf_counter() - t0
            out["card_vs_cpu"] = max(errs)
            if not max(errs) <= VIZ_TOL:
                raise AssertionError(f"the card's figures differ from the "
                                     f"CPU's by {max(errs)} (limit {VIZ_TOL})")

            # The exported .pth serves as its .npz does.
            predictors = {}
            for label, path in (("npz", rel_npz), ("pth", rel_pth)):
                params, cfg, mean, std, native, _ = \
                    serving.load_serving_state(path)
                predictors[label] = serving.Predictor.from_params(
                    params, cfg, mean, std, native)
            want = predictors["npz"].logits(test_images)
            reset_counts(fa, fused_adamw)
            got = predictors["pth"].logits(test_images)
            counts = read_counts(fa, fused_adamw)
            check_resident(fa, "Predictor on the exported .pth")
            same = bool(np.array_equal(got, want))
            log(f"  Predictor on the exported .pth: {len(test_images)} "
                f"images, logits equal to the .npz's: {same}, launches "
                f"{counts} (expected {cfg.depth} attn_fwd)")
            if not same or counts != {"attn_fwd": cfg.depth, "attn_bwd": 0,
                                      "adamw": 0}:
                raise AssertionError("the exported .pth does not serve as "
                                     "its .npz")
            out["pth_launches"] = counts
        finally:
            os.chdir(cwd)
    return out


# Phase 18 (a): the graph epochs. GRAPH_K: an explicit k beside the auto
# one (25 for the CLI's 100 steps).
GRAPH_K = 4
CSV_ROW_FIELDS = ("train_loss", "train_acc", "test_loss", "test_acc")


def steady_images_per_s(run) -> float:
    """A train CLI run's epoch img/s without its graph's warm-up and
    capture, which the train epoch's clock holds."""
    seconds = run["n_train"] / run["images_per_s"]
    return run["n_train"] / (seconds - (run["capture_seconds"] or 0.0))


def compare_epochs(label, runs):
    """Logs each run's img/s (with and without the graph's capture), k,
    capture seconds and peak device memory beside the others' (one call,
    one card) and raises unless every run's CSV row (train and test
    columns) is the first one's, bit for bit; returns the runs' record."""
    rows = {name: tuple(run["csv"][f] for f in CSV_ROW_FIELDS)
            for name, run in runs.items()}
    first = next(iter(rows.values()))
    diffs = {name: {f: abs(float(a) - float(b)) for f, a, b in
                    zip(CSV_ROW_FIELDS, row, first) if a != b}
             for name, row in rows.items()}
    log(f"  {label}: " + "; ".join(
        f"{name} (k {run['k']}, evaluation k {run['k_eval']}) "
        f"{run['images_per_s']:.1f} img/s ({steady_images_per_s(run):.1f} "
        f"without the capture), capture "
        f"{run['capture_seconds']} s, evaluation capture "
        f"{run['eval_capture_seconds']} s, peak "
        f"{run['peak_bytes'] / 2**30:.2f} GiB"
        for name, run in runs.items()))
    log(f"    CSV rows {CSV_ROW_FIELDS}: {rows}; differences from the "
        f"first {diffs}")
    if any(diffs.values()):
        raise AssertionError(f"{label}: the CSV rows differ across the "
                             f"steps per dispatch: {diffs}")
    return {name: dict(k=run["k"], k_eval=run["k_eval"],
                       images_per_s=run["images_per_s"],
                       steady_images_per_s=steady_images_per_s(run),
                       capture_seconds=run["capture_seconds"],
                       eval_capture_seconds=run["eval_capture_seconds"],
                       peak_bytes=run["peak_bytes"], csv=run["csv"],
                       launches=run["launches"], seconds=run["seconds"])
            for name, run in runs.items()}


def check_eval_graph(train_modules, ckpt, csv_row, device, k=20):
    """Phase 18a: phase 8's best checkpoint (its only epoch's params)
    evaluated on the CLI's 2,560 synthetic test images in rows of 128,
    one row a call (make_eval_step, eager) and k rows a call (one CUDA
    graph replay): the metrics rows bit-equal, the CSV's test loss and
    accuracy recomputed from them as the loop does, and the launches (the
    graph's k captured forwards a replay plus one warm-up forward)."""
    fa, fused_adamw, _, serving, datasets = train_modules
    from vit_rpe_rope_tpu_torch.train import train_step as ts

    params, cfg, mean, std, native, _ = serving.load_serving_state(ckpt)
    params = {key: v.to(device) for key, v in params.items()}
    pre = ts.make_preprocess(cfg, mean, std, native)
    test = datasets.synthetic("cifar10", n_train=12800, n_test=2560, seed=0)
    x = torch.from_numpy(test.test_x).to(device)
    y = torch.from_numpy(test.test_y).to(device)
    idx = ts.epoch_indices(len(test.test_y), 128, False).to(device)
    out = {}
    for rows_a_call in (1, k):
        step = ts.make_eval_step(cfg, pre, k=rows_a_call)
        reset_counts(fa, fused_adamw)
        t0 = time.perf_counter()
        metrics = torch.cat([
            step(params, row, x, y, idx).reshape(-1, 3)
            for row in range(0, idx.shape[0], rows_a_call)]).cpu().numpy()
        seconds = time.perf_counter() - t0
        kept = metrics[metrics[:, 2] > 0]
        out[rows_a_call] = dict(
            metrics=metrics, launches=read_counts(fa, fused_adamw),
            seconds=seconds, capture_seconds=step.capture_seconds,
            test_loss=float(kept[:, 0].mean()),
            test_acc=100.0 * float(kept[:, 1].sum())
            / max(float(kept[:, 2].sum()), 1.0))
    one, graph = out[1], out[k]
    same = np.array_equal(one["metrics"], graph["metrics"])
    csv = (float(csv_row["test_loss"]), float(csv_row["test_acc"]))
    expected = {"attn_fwd": cfg.depth * (20 + 1), "attn_bwd": 0, "adamw": 0}
    log(f"  evaluation of phase 8's checkpoint, 20 rows of 128: k=1 "
        f"{one['seconds']:.3f} s, k={k} {graph['seconds']:.3f} s (capture "
        f"{graph['capture_seconds']} s); metrics bit-equal {same}; test "
        f"loss / accuracy {one['test_loss']!r} / {one['test_acc']!r} and "
        f"{graph['test_loss']!r} / {graph['test_acc']!r} (CSV {csv}); "
        f"launches {one['launches']} / {graph['launches']} (expected "
        f"{expected} for k={k})")
    if not same or (graph["test_loss"], graph["test_acc"]) != csv \
            or (one["test_loss"], one["test_acc"]) != csv:
        raise AssertionError("the evaluation graph differs from one row a "
                             "call or from the CSV")
    if graph["launches"] != expected or graph["capture_seconds"] is None:
        raise AssertionError(f"evaluation graph: launches "
                             f"{graph['launches']}, expected {expected}")
    return dict(bit_equal=same, csv=csv,
                seconds={1: one["seconds"], k: graph["seconds"]},
                capture_seconds=graph["capture_seconds"],
                launches={1: one["launches"], k: graph["launches"]})


def check_graph_epochs(train_modules, auto, regularised, ckpt, device):
    """Phase 18a: the ViT-tiny/4 train CLI at its defaults (rope-mixed, 100
    steps of 128) with --steps_per_dispatch 1, at auto (25 steps a
    dispatch) and with GRAPH_K, in turns, beside phase 8's run at auto
    (`auto`), and the regularised epoch
    (REGULARISED, seed 0) at --steps_per_dispatch 1 beside phase 17's at
    auto (`regularised`: its draws inside the graph, from generators
    re-seeded per replay), each run with exact launch counts
    (train_through_cli); within each group the CSV rows must be equal bit
    for bit (compare_epochs). Then the evaluation graph against one row a
    call on phase 8's checkpoint `ckpt` (check_eval_graph)."""
    plain = {"auto (phase 8)": auto}
    for name, k in (("k=1", 1), ("auto", 0), (f"k={GRAPH_K}", GRAPH_K)):
        plain[name] = train_through_cli(
            "rope-mixed", train_modules, flags={"steps_per_dispatch": k})
    reg = {"auto": regularised, "k=1": train_through_cli(
        "rope-mixed", train_modules,
        flags={**REGULARISED, "steps_per_dispatch": 1}, bar=REGULARISED_BAR)}
    out = dict(plain=compare_epochs("graph epochs, ViT-tiny/4 rope-mixed",
                                    plain),
               regularised=compare_epochs(
                   "regularised graph epochs, ViT-tiny/4 rope-mixed", reg))
    for group in (plain, reg):
        for name, run in group.items():
            log(f"    {name} launches {run['launches']}")
    out["evaluation"] = check_eval_graph(train_modules, ckpt,
                                         auto["csv"], device)
    return out


def check_adamw_table(fused_adamw, vit, cfg, device):
    """Phase 18a': the AdamW kernel's device-table entry on the ViT-S/16
    params: three live steps and one not live, against the IEEE op-by-op
    reference (fused_adamw.adamw_exact) bit for bit and its twin to
    ADAMW_TOL; then its times (the wrapper by CUDA events, the kernel's
    device time by the profiler), its twin's, torch.optim.AdamW
    (fused=True) as the yardstick, and the bound (bytes: p, g, mu, nu read,
    p, mu, nu written, as the by-value entry)."""
    gen = torch.Generator().manual_seed(23)
    params = vit.init_params(gen, cfg, device=device)
    keys = list(params)
    p = [params[k] for k in keys]
    mu = [torch.zeros_like(t) for t in p]
    nu = [torch.zeros_like(t) for t in p]
    schedule = lambda step: 1e-3 * (0.9 ** step)  # noqa: E731
    _, update = fused_adamw.make_fused_adamw(params, schedule,
                                             weight_decay=0.05)
    rows = [(*update.hyper(c), 1.0) for c in (1, 2, 3)]
    rows.append((0.0, 1.0, 1.0, 0.0))
    table = fused_adamw.hyper_rows(rows, device)
    exact = ([t.clone() for t in p], [t.clone() for t in mu],
             [t.clone() for t in nu])
    twin = ([t.clone() for t in p], [t.clone() for t in mu],
            [t.clone() for t in nu])
    fused_adamw.LAUNCHES_ADAMW_TABLE = 0
    for j, (lr, c1, c2, live) in enumerate(rows):
        grads = [torch.randn(t.shape, generator=gen).to(device) for t in p]
        fused_adamw.adamw_update_table(p, grads, mu, nu, table[j], 0.9,
                                       0.999, 1e-8, 0.05)
        if live:
            new = fused_adamw.adamw_exact(exact[0], grads, exact[1],
                                          exact[2], lr, c1, c2, 0.9, 0.999,
                                          1e-8, 0.05)
            for old, x in zip(exact, new):
                for o, n in zip(old, x):
                    o.copy_(n)
            fused_adamw.adamw_plain(twin[0], grads, twin[1], twin[2], lr, c1,
                                    c2, 0.9, 0.999, 1e-8, 0.05)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for got, want in zip((p, mu, nu), exact)
                  for a, b in zip(got, want))
    worst, ok = 0.0, True
    for got, want in zip((p, mu, nu), twin):
        for a, b in zip(got, want):
            err, good = worst_err(a, b, ADAMW_TOL)
            worst, ok = max(worst, err), ok and good
    launches = fused_adamw.LAUNCHES_ADAMW_TABLE
    log(f"  AdamW table entry vs the IEEE op-by-op reference, "
        f"{vit.num_params(params):,} params, 3 live steps and 1 not live: "
        f"bit-identical {bitwise}; vs twin max_abs_err={worst:.3e}; "
        f"launches {launches}")
    if not (bitwise and ok and launches == 4):
        raise AssertionError("the AdamW table entry disagrees with its IEEE "
                             "reference or its twin")
    grads = [torch.randn(t.shape, generator=gen).to(device) for t in p]
    lists = (p, grads, mu, nu)

    def step():
        fused_adamw.adamw_update_table(*lists, table[0], 0.9, 0.999, 1e-8,
                                       0.01)

    ms = median_ms(step)
    by_name, recorded, calls = device_ms_by_kernel(step, 20,
                                                   ("adamw_kernel",))
    lr, c1, c2, _ = rows[0]
    plain_ms = median_ms(lambda: fused_adamw.adamw_plain(
        *lists, lr, c1, c2, 0.9, 0.999, 1e-8, 0.01), iters=5)
    torch_params = [torch.nn.Parameter(t.clone()) for t in p]
    for tp, g in zip(torch_params, grads):
        tp.grad = g
    opt = torch.optim.AdamW(torch_params, lr=1e-3, weight_decay=0.01,
                            fused=True)
    library_ms = median_ms(opt.step)
    n = vit.num_params(params)
    bound_ms = 7 * 4 * n / HBM_BYTES_PER_S * 1e3
    log(f"  AdamW table entry, {n:,} params: wrapper {ms:.4f} ms  kernel "
        f"device time {by_name['adamw_kernel']:.4f} ms (profiler, {recorded}"
        f" of {calls} launches recorded)  torch fused AdamW "
        f"{library_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes)  twin "
        f"{plain_ms:.4f} ms")
    return worst, dict(ms=ms, device_ms=by_name["adamw_kernel"],
                       plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by="bytes", num_params=n)


# Phase 18 (b): remat at ViT-S/16@224 (rope-mixed, batch 64, dense kernels)
# and at the long-sequence model at N = 16,385 (rope-axial, batch 2, the
# streaming forward and the one-pass backward).
REMAT_POLICIES = (None, "full", "dots", "softmax")
# (label, config fields, batch, image size fed: ViT-S/16@224 takes 32x32
# images upsampled on the device, as in phase 10)
REMAT_CASES = (
    ("ViT-S/16@224 rope-mixed", dict(VIT_S, pos_encoding="rope-mixed"), 64,
     32),
    ("longseq N=16385 rope-axial",
     dict(LONGSEQ, img_size=512, pos_encoding="rope-axial"), 2, 512))


def remat_runs(vit, ts, fa, fused_adamw, TrainConfig, base, batch, native,
               device, draw_seed=None, profiled=False):
    """Phases 18b and 25: for each of REMAT_POLICIES at config `base`, one
    forward and backward on the same params and images (uint8 images at
    `native` px, resized on the device): the attention launches, the peak
    device memory above what was allocated before, as the caching
    allocator's peak of requested bytes (the tensors the program holds:
    exact for the same allocations, where allocated bytes carry the
    rounding of whichever cached block served a request) and of allocated
    bytes (torch.cuda.max_memory_allocated), the loss, every gradient
    against remat off (bit for bit, and the largest difference as a share
    of the gradient's largest entry). Then the time of a whole train step
    (fwd, bwd, AdamW; its draws from the train row's generators) by CUDA
    events, the policies in turns, two rounds; profiled: a profiler pass
    of two steps each (the device's busy ms). draw_seed: the forward
    draws its dropout and drop-path masks from a generator of this seed
    (the same masks under every policy); None: no draws."""
    from vit_rpe_rope_tpu_torch.data import datasets

    mean, std = datasets.NORMALIZATION["cifar10"]
    rng = np.random.default_rng(18)
    images = torch.from_numpy(rng.integers(
        0, 256, (batch, native, native, 3), dtype=np.uint8)).to(device)
    labels = torch.from_numpy(np.arange(batch, dtype=np.int32) % 10).to(
        device)
    pre = ts.make_preprocess(base, mean, std, native)
    x = pre(images)
    params = {k: v.requires_grad_() for k, v in vit.init_params(
        torch.Generator().manual_seed(18), base, device=device).items()}
    reference = None
    out, steps = {}, {}
    for policy in REMAT_POLICIES:
        cfg = (base if policy is None else
               dataclasses.replace(base, remat=True, remat_policy=policy))

        def grads():
            gen = (None if draw_seed is None else
                   torch.Generator(device=device).manual_seed(draw_seed))
            logits = vit.apply(params, x, cfg, gen)
            loss = torch.nn.functional.cross_entropy(logits, labels.long())
            return loss.detach(), torch.autograd.grad(
                loss, list(params.values()))

        grads()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        base_requested = torch.cuda.memory_stats()[
            "requested_bytes.all.current"]
        reset_counts(fa, fused_adamw)
        loss, g = grads()
        counts = read_counts(fa, fused_adamw)
        peak = torch.cuda.max_memory_allocated() - base_bytes
        peak_requested = torch.cuda.memory_stats()[
            "requested_bytes.all.peak"] - base_requested
        if reference is None:
            reference, share = g, 0.0
            bitwise = True
        else:
            share = max(float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(g, reference))
            bitwise = all(torch.equal(a, b) for a, b in zip(g, reference))
        del g
        name = policy or "off"
        out[name] = dict(peak_bytes=peak, peak_requested=peak_requested,
                         launches=counts, loss=float(loss),
                         grad_share_vs_off=share, grads_bit_equal=bitwise)
        log(f"  remat {name:7s} {base.compute_dtype}, batch {batch}: peak "
            f"{peak_requested / 2**20:.1f} MiB requested ("
            f"{peak / 2**20:.1f} MiB allocated) above the params in "
            f"fwd+bwd, loss {float(loss)!r}, launches {counts}, gradients "
            f"vs remat off: largest share {share:.3e} (bit-equal {bitwise})")
        step_params = {k: v.detach().clone().requires_grad_()
                       for k, v in params.items()}
        init, update = ts.make_optimizer(TrainConfig(dataset="cifar10"),
                                         100, step_params)
        step = ts.make_train_step(cfg, update, pre)
        idx = torch.arange(batch, device=device)[None]
        state = [step_params, init(step_params)]

        def run(step=step, state=state):
            state[0], state[1], m = step(state[0], state[1], 0, images,
                                         labels, idx)
            return m

        run()
        steps[name] = run
    del params, reference, x
    torch.cuda.empty_cache()
    n_steps = 5 if batch == 64 else 3
    for round_ in range(2):
        for name, run in steps.items():
            run()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(n_steps):
                run()
            end.record()
            end.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
            out[name].setdefault("step_ms", []).append(wall_ms)
            out[name].setdefault("device_ms", []).append(
                start.elapsed_time(end) / n_steps)
    for name, run in steps.items():
        log(f"  remat {name:7s} {base.compute_dtype}: "
            f"{out[name]['step_ms'][0]:.2f} / {out[name]['step_ms'][1]:.2f}"
            f" ms a train step in turns ("
            f"{out[name]['device_ms'][0]:.2f} / "
            f"{out[name]['device_ms'][1]:.2f} ms between device events)")
        if profiled:
            out[name]["profile"] = profile_train_step(run)
    del steps
    torch.cuda.empty_cache()
    return out


def attention_fwd_name(runs):
    """The attention forward remat off's run launched (dense or
    streaming)."""
    off = runs["off"]["launches"]
    fwd = max(("attn_fwd", "attn_stream_fwd"), key=lambda k: off.get(k, 0))
    if not off.get(fwd):
        raise AssertionError("no attention forward launched")
    return fwd


def check_remat(vit, ts, fa, fused_adamw, ViTConfig, TrainConfig, device):
    """Phase 18b: remat_runs for each of REMAT_CASES, held by
    check_remat_policies: the recompute of "full" and "dots" launches the
    attention forward again, as JAX recomputes pallas_call; "softmax"
    keeps the kernels' outputs, as remat off does."""
    out = {}
    for label, fields, batch, native in REMAT_CASES:
        log(f"  {label}:")
        out[label] = remat_runs(vit, ts, fa, fused_adamw, TrainConfig,
                                ViTConfig(**fields), batch, native, device)
        check_remat_policies(label, out[label], attention_fwd_name(
            out[label]))
    return out


REMAT_FWD_TIMES = {"full": 2, "dots": 2, "softmax": 1}


def check_remat_policies(label, runs, fwd):
    """Phases 18b and 25: each policy's attention forward launches (twice
    remat off's under "full" and "dots", remat off's under "softmax"), its
    gradients bit-equal to remat off's, and its peak memory (below remat
    off's under "full" and "dots", at most remat off's under "softmax"; in
    requested bytes)."""
    off = runs["off"]
    for name, times in REMAT_FWD_TIMES.items():
        got = runs[name]
        if got["launches"].get(fwd) != times * off["launches"][fwd]:
            raise AssertionError(f"remat {name} {label}: {fwd} launched "
                                 f"{got['launches'].get(fwd)} times, "
                                 f"expected {times} x "
                                 f"{off['launches'][fwd]}")
        if not got["grads_bit_equal"]:
            raise AssertionError(f"remat {name} {label}: gradients differ "
                                 f"from remat off by "
                                 f"{got['grad_share_vs_off']:.3e}")
        peak, off_peak = got["peak_requested"], off["peak_requested"]
        if not (peak <= off_peak if name == "softmax" else peak < off_peak):
            raise AssertionError(f"remat {name} {label} holds "
                                 f"{got['peak_bytes']} bytes, remat off "
                                 f"{off['peak_bytes']}")


# Phase 25: the JAX package's remat configuration trained at full width:
# ViT-S/16@224 rope-mixed at batch 64 with dropout and drop-path, in bf16
# beside f32, under each remat policy (VALIDATION.md pairs "dots" with
# bf16), then through the train CLI.
BF16_REMAT_FIELDS = dict(VIT_S, pos_encoding="rope-mixed", drop_rate=0.1,
                         drop_path_rate=0.1)
# The first loss of the bf16 forward against the f32 one on the same
# params, images and masks, relative: bf16 activations carry a relative
# error near 2^-8 into every product (the CPU tests' bound against the JAX
# package's bf16 step).
BF16_LOSS_TOL = 2e-2
# The CLI epochs: 1,024 synthetic examples (16 steps of 64: auto k = 16,
# one CUDA graph a dispatch) and 256 test images (4 evaluation rows).
BF16_CLI_TRAIN = 1024
BF16_CLI_ARGV = ["--dataset", "cifar10", "--synthetic", "--epochs", "1",
                 "--pos_encoding", "rope-mixed", "--batch_size", "64",
                 "--img_size", "224", "--patch_size", "16",
                 "--embed_dim", "384", "--depth", "12", "--num_heads", "6",
                 "--compute_dtype", "bfloat16", "--drop_path_rate", "0.1",
                 "--remat"]


def bf16_cli_epoch(train_modules, policy, k):
    """One epoch of the train CLI (BF16_CLI_ARGV, --remat_policy policy,
    --steps_per_dispatch k: 0 is the CLI's auto) in a scratch directory,
    its stdout kept (and logged), the counts reset just before and read
    just after, and the k-step driver's CUDA-graph captures counted.
    Returns the CSV row, the launches, the k taken, the captures, the
    capture seconds, img/s, the peak device memory and the stdout."""
    from vit_rpe_rope_tpu_torch.train import train_step as ts

    fa, fused_adamw, train_cli, _, datasets = train_modules
    graph_of, captures = ts._graph_of, []

    def counted(device, warm_up, record, what, *args, **kw):
        captures.append(what)
        return graph_of(device, warm_up, record, what, *args, **kw)

    argv = BF16_CLI_ARGV + ["--remat_policy", policy,
                            "--steps_per_dispatch", str(k)]
    cwd = os.getcwd()
    stdout = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        ts._graph_of = counted
        try:
            reset_counts(fa, fused_adamw)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with small_dataset(datasets, n_train=BF16_CLI_TRAIN,
                               n_test=BF16_CLI_TRAIN // 4), \
                    contextlib.redirect_stdout(stdout):
                summary = train_cli.main(argv)
            counts = read_counts(fa, fused_adamw)
            seconds = time.perf_counter() - t0
            with open(summary["log_file"]) as f:
                row = list(f)[1].strip()
        finally:
            ts._graph_of = graph_of
            os.chdir(cwd)
    text = stdout.getvalue()
    log("    | " + "\n    | ".join(text.strip().splitlines()[-6:]))
    return dict(row=row, launches=counts, k=summary["steps_per_dispatch"],
                k_eval=summary["eval_rows_per_dispatch"],
                train_captures=sum(w.endswith("train steps")
                                   for w in captures),
                capture_seconds=summary.get("capture_seconds"),
                images_per_s=summary["history"][0]["images_per_sec"],
                peak_bytes=torch.cuda.max_memory_allocated(),
                seconds=seconds, eager_notice="eagerly" in text)


def bf16_cli_launches(policy, k, depth=12, steps=16, evals=4):
    """The launches of a bf16_cli_epoch run: k = 0 (auto, 16) replays one
    CUDA graph of 16 captured steps after one warm-up step; the
    evaluation's 4 rows one graph after one warm-up forward. The train
    steps launch the attention forward twice a block under "full" and
    "dots" (the recompute), once under "softmax"."""
    train_rows = steps + 1 if k != 1 else steps
    fwd = REMAT_FWD_TIMES[policy] * depth * train_rows + depth * (evals + 1)
    if k == 1:
        return {"attn_fwd": fwd, "attn_bwd": depth * steps, "adamw": steps}
    return {"attn_fwd": fwd, "attn_bwd": depth * train_rows, "adamw": 0,
            "adamw_table": train_rows}


def check_bf16_remat(vit, ts, fa, fused_adamw, ViTConfig, TrainConfig,
                     train_modules, device):
    """Phase 25: (a) remat_runs of BF16_REMAT_FIELDS in f32 and bf16, the
    masks drawn from one seed: per dtype, check_remat_policies (launches,
    gradients bit-equal to remat off's, peak memory); each bf16 loss
    within BF16_LOSS_TOL of the f32 one. (b) one train CLI epoch per
    policy with --compute_dtype bfloat16 --remat --drop_path_rate 0.1 at
    the CLI's auto k (one CUDA graph of 16 steps that draw, captured once,
    no eager notice on stdout) and at --steps_per_dispatch 1: the CSV rows
    bit-equal, the row finite, exact launches."""
    steps = {}
    for dtype in ("float32", "bfloat16"):
        log(f"  ViT-S/16@224 rope-mixed {dtype}, dropout and drop-path 0.1:")
        steps[dtype] = remat_runs(
            vit, ts, fa, fused_adamw, TrainConfig,
            ViTConfig(**BF16_REMAT_FIELDS, compute_dtype=dtype), 64, 32,
            device, draw_seed=25, profiled=True)
        check_remat_policies(f"ViT-S/16@224 {dtype}", steps[dtype],
                             "attn_fwd")
    for name, run in steps["bfloat16"].items():
        want = steps["float32"][name]["loss"]
        rel = abs(run["loss"] - want) / abs(want)
        run["loss_vs_f32"] = rel
        if not rel <= BF16_LOSS_TOL:
            raise AssertionError(f"bf16 remat {name}: loss {run['loss']} "
                                 f"against f32 {want} ({rel:.3e})")
    log("  bf16 losses against f32, relative: " + ", ".join(
        f"{name} {run['loss_vs_f32']:.3e}"
        for name, run in steps["bfloat16"].items()))
    cli = {}
    for policy in REMAT_FWD_TIMES:
        runs = {k: bf16_cli_epoch(train_modules, policy, k) for k in (0, 1)}
        auto, one = runs[0], runs[1]
        log(f"  train CLI bf16 --remat_policy {policy}: auto k "
            f"{auto['k']} ({auto['train_captures']} capture, "
            f"{auto['capture_seconds']} s) {auto['images_per_s']:.1f} img/s "
            f"in {auto['seconds']:.1f} s, k=1 {one['images_per_s']:.1f} img/s;"
            f" peak {auto['peak_bytes'] / 2**30:.2f} / "
            f"{one['peak_bytes'] / 2**30:.2f} GiB; CSV {auto['row']} / "
            f"{one['row']}; launches {auto['launches']} / {one['launches']}")
        for k, run in runs.items():
            want = with_prologues(bf16_cli_launches(policy, k))
            if run["launches"] != want:
                raise AssertionError(f"bf16 CLI {policy} k={k}: launches "
                                     f"{run['launches']}, expected {want}")
            if not all(math.isfinite(float(v))
                       for v in run["row"].split(",")):
                raise AssertionError(f"bf16 CLI {policy}: row {run['row']}")
        if auto["row"] != one["row"]:
            raise AssertionError(f"bf16 CLI {policy}: the CSV row at auto k "
                                 f"{auto['row']} differs from k=1's "
                                 f"{one['row']}")
        if auto["k"] != 16 or auto["train_captures"] != 1 \
                or auto["eager_notice"] or auto["capture_seconds"] is None:
            raise AssertionError(f"bf16 CLI {policy}: k {auto['k']}, "
                                 f"{auto['train_captures']} captures, eager "
                                 f"notice {auto['eager_notice']}")
        cli[policy] = runs
    return dict(steps=steps, cli=cli)


@contextlib.contextmanager
def small_dataset(datasets, n_train=1024, n_test=256, poison=False):
    """datasets.get_dataset (what the train CLI loads) swapped for the
    synthetic set at n_train / n_test examples; poison: a normalisation std
    of 0, so that the pre-processed images are infinite and the first
    product of the train step makes NaNs."""
    real = datasets.get_dataset

    def get_dataset(dataset, data_dir, use_synthetic, seed):
        bundle = datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                    seed=seed)
        if poison:
            bundle.std = np.zeros_like(bundle.std)
        return bundle

    datasets.get_dataset = get_dataset
    try:
        yield
    finally:
        datasets.get_dataset = real


# The train CLI at its defaults, one step a dispatch: the runs of phases
# 18c-d and 20-24 hold (and record) per-step launches and losses; a later
# --steps_per_dispatch in their argv takes precedence. Their evaluation
# keeps the CLI's auto rows per dispatch (one CUDA graph of 20 rows without
# a process group, eager rows under one).
TINY_ARGV = ["--dataset", "cifar10", "--synthetic", "--epochs", "1",
             "--pos_encoding", "rope-mixed", "--steps_per_dispatch", "1"]
# A run of TINY_ARGV without a process group: 100 steps of 128, each
# launching ViT-tiny/4's 6 blocks forward and backward, and 20 evaluation
# rows in one graph after one warm-up forward.
TINY_LAUNCHES = {"attn_fwd": 6 * (100 + 20 + 1), "attn_bwd": 6 * 100,
                 "adamw": 100}


def cli_row(train_cli, argv):
    """The CSV row of one run of the train CLI in a scratch directory."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            summary = train_cli.main(TINY_ARGV + argv)
            with open(summary["log_file"]) as f:
                return list(f)[1].strip()
        finally:
            os.chdir(cwd)


def check_debug_nans(train_cli, datasets, nan_check):
    """Phase 18c: the ViT-tiny/4 train CLI on 1,024 synthetic examples (8
    steps): poisoned (std 0), --debug_nans raises FloatingPointError; clean,
    the CSV row with --debug_nans equals the one without; the sanitizer is
    off after each run."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode

    def off():
        return (not nan_check.ACTIVE and not torch.is_anomaly_enabled()
                and _get_current_dispatch_mode() is None)

    with small_dataset(datasets, poison=True):
        t0 = time.perf_counter()
        try:
            cli_row(train_cli, ["--debug_nans"])
        except FloatingPointError as e:
            raised = str(e)
        else:
            raise AssertionError("a poisoned run under --debug_nans did not "
                                 "raise FloatingPointError")
        poisoned_s = time.perf_counter() - t0
    if not off():
        raise AssertionError("the sanitizer is still on after a raise")
    with small_dataset(datasets):
        t0 = time.perf_counter()
        plain = cli_row(train_cli, [])
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sanitized = cli_row(train_cli, ["--debug_nans"])
        sanitized_s = time.perf_counter() - t0
    log(f"  --debug_nans, poisoned: FloatingPointError '{raised}' after "
        f"{poisoned_s:.1f} s; clean: row {plain} in {plain_s:.1f} s, with "
        f"the sanitizer {sanitized} in {sanitized_s:.1f} s; equal "
        f"{plain == sanitized}; sanitizer off afterwards {off()}")
    if plain != sanitized or not off():
        raise AssertionError("--debug_nans changed a clean run's row or "
                             "stayed on")
    return dict(raised=raised, row=plain, seconds=dict(
        poisoned=poisoned_s, plain=plain_s, sanitized=sanitized_s))


PROFILED_KERNELS = ("attn_fwd_resident_kernel", "attn_bwd_resident_kernel",
                    "adamw_kernel")


def check_profile_dir(train_cli, datasets):
    """Phase 18d: one epoch of the ViT-tiny/4 train CLI on 1,024 synthetic
    examples with --profile_dir: a Chrome trace that names the train
    step's kernels (PROFILED_KERNELS) and its aten ops."""
    with tempfile.TemporaryDirectory() as prof, small_dataset(datasets):
        t0 = time.perf_counter()
        cli_row(train_cli, ["--profile_dir", prof])
        seconds = time.perf_counter() - t0
        paths = [os.path.join(prof, name) for name in os.listdir(prof)]
        traces = [p for p in paths if p.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"--profile_dir wrote {paths}")
        size = os.path.getsize(traces[0])
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    found = {k: sum(k in n for n in names) for k in PROFILED_KERNELS}
    device_events = sum(e.get("cat") == "kernel" for e in events)
    log(f"  --profile_dir: {os.path.basename(traces[0])}, {size:,} bytes, "
        f"{len(events):,} events ({device_events:,} kernel events) in "
        f"{seconds:.1f} s; kernel names found {found}; aten::mm "
        f"{'aten::mm' in names}")
    if not all(found.values()) or "aten::mm" not in names:
        raise AssertionError(f"the trace does not name the train step's "
                             f"kernels: {found}")
    return dict(bytes=size, events=len(events), kernel_events=device_events,
                kernels_found=found, seconds=seconds)


def write_idx(path, arr, gz=False):
    data = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape) + arr.tobytes()
    if gz:
        import gzip

        with gzip.open(path + ".gz", "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def check_decoders(datasets, native):
    """Phase 18e: MNIST IDX files (two raw, two .gz) and CIFAR-10 binary
    batches written here, decoded by data/datasets.py: which decoder ran
    (datasets.DECODERS: the C++ library of utils/native.py, or numpy where
    it could not be built) and the arrays against what was written."""
    rng = np.random.default_rng(18)
    mnist = {"train-images-idx3-ubyte": rng.integers(0, 256, (600, 28, 28)),
             "train-labels-idx1-ubyte": rng.integers(0, 10, (600,)),
             "t10k-images-idx3-ubyte": rng.integers(0, 256, (100, 28, 28)),
             "t10k-labels-idx1-ubyte": rng.integers(0, 10, (100,))}
    records = {name: rng.integers(0, 256, (200, 3073)) for name in
               [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]}
    t0 = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t0
    before = collections.Counter(datasets.DECODERS)
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, arr) in enumerate(mnist.items()):
            write_idx(os.path.join(tmp, name), arr.astype(np.uint8),
                      gz=i % 2 == 1)
        os.makedirs(os.path.join(tmp, "cifar-10-batches-bin"))
        for name, rec in records.items():
            rec = rec.astype(np.uint8)
            rec[:, 0] %= 10
            records[name] = rec
            rec.tofile(os.path.join(tmp, "cifar-10-batches-bin",
                                    f"{name}.bin"))
        t0 = time.perf_counter()
        got_m = datasets.load_mnist(tmp)
        got_c = datasets.load_cifar10(tmp)
        decode_s = time.perf_counter() - t0
    ran = dict(collections.Counter(datasets.DECODERS) - before)
    want_c = {name: (rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1),
                     rec[:, 0].astype(np.int32))
              for name, rec in records.items()}
    equal = (
        np.array_equal(got_m.train_x[..., 0], mnist["train-images-idx3-ubyte"])
        and np.array_equal(got_m.train_y, mnist["train-labels-idx1-ubyte"])
        and np.array_equal(got_m.test_x[..., 0], mnist["t10k-images-idx3-ubyte"])
        and np.array_equal(got_m.test_y, mnist["t10k-labels-idx1-ubyte"])
        and np.array_equal(got_c.train_x, np.concatenate(
            [want_c[f"data_batch_{i}"][0] for i in range(1, 6)]))
        and np.array_equal(got_c.train_y, np.concatenate(
            [want_c[f"data_batch_{i}"][1] for i in range(1, 6)]))
        and np.array_equal(got_c.test_x, want_c["test_batch"][0])
        and np.array_equal(got_c.test_y, want_c["test_batch"][1]))
    decoders = {f"{fmt} {dec}": n for (fmt, dec), n in ran.items()}
    log(f"  decoders: C++ library {'built at ' + str(native.library_path()) if lib is not None else 'NOT built (numpy ran)'} "
        f"({build_s:.2f} s); decodes by decoder {decoders}; arrays equal to "
        f"the numpy arrays written {equal} ({decode_s * 1e3:.1f} ms)")
    if not equal:
        raise AssertionError("the decoded datasets differ from the files")
    return dict(native_built=lib is not None, decoders=decoders,
                build_seconds=build_s, decode_ms=decode_s * 1e3)


# ---------------------------------------------------------------------------
# Phase 19: int8 serving and serving artifacts
# ---------------------------------------------------------------------------

INT8_MODES = ("w8a8", "w8a8-static", "w8a16")
# An int8 forward against the float32 forward of the same params, relative
# L2 of the logits: the JAX package's bounds (tests/test_quant.py).
INT8_F32_TOL = {"w8a8": 0.05, "w8a8-static": 0.08, "w8a16": 0.08}
# The card's int8 products against the same products on the CPU, each on
# the card's own inputs to it, relative L2: w8a8 and w8a8-static bit for bit
# (the same IEEE divide, round and clip, an exact int32 sum, the same
# float32 dequantization); w8a16 within one bf16 rounding of its output
# (2^-8: cuBLAS and the CPU sum the bf16 products in another order).
INT8_PRODUCT_TOL = {"w8a8": 0.0, "w8a8-static": 0.0, "w8a16": 2.0 ** -8}
# The card's int8 logits against the same mode's forward on the CPU: the
# attention kernel and cuBLAS sum in another order than the CPU, an
# activation that then lands on the other side of an int8 rounding boundary
# moves by a whole step, and the next blocks carry it on; over 12 blocks the
# two forwards differ as two int8 roundings of one float32 forward do
# (2.2e-2 in w8a8 at ViT-S/16@224 on an H100). So the logits are held
# to INT8_F32_TOL and the products, which do not cascade, to
# INT8_PRODUCT_TOL.
# Top-1 agreement of int8 with float32 on trained models (tests/test_quant.py).
INT8_AGREE = 0.95
INT8_BOPS = 1979e12           # H100 SXM dense int8 tensor-core peak
CALIB_IMAGES = 64             # w8a8-static calibration images
INT_MM_SHAPE = (12608, 384, 1536)  # fc1 at ViT-S/16@224, batch 64


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def int8_products(cfg, batches, mode):
    """torch._int_mm calls of `batches` int8 forwards: the patch embedding,
    four linears a block and the head; none in w8a16 (bf16 matmuls)."""
    return 0 if mode == "w8a16" else batches * (2 + 4 * cfg.depth)


def int8_product_errors(quant, ts, qparams, cfg, mode, images, mean, std,
                        native):
    """Every int8 product of one int8 forward on the card (8 images),
    recomputed on the CPU on the card's own inputs to it: {key: (relative
    L2, max abs)} of the worst product. No cascade: each product sees the
    same inputs on both devices."""
    records = []
    lin = quant._make_lin(qparams, mode)

    def recording(x, wkey, bias=None):
        y = lin(x, wkey, bias)
        records.append((wkey, x, bias, y))
        return y

    pre = ts.make_preprocess(cfg, mean, std, native)
    device = next(iter(qparams.values())).device
    with torch.inference_mode():
        quant._forward_with_lin(
            qparams, pre(torch.from_numpy(images[:8]).to(device)), cfg,
            recording, torch.float32 if mode == "w8a8" else torch.bfloat16)
    cpu = quant._make_lin({k: v.cpu() for k, v in qparams.items()}, mode)
    worst = (0.0, 0.0, None)
    for wkey, x, bias, y in records:
        want = cpu(x.cpu(), wkey, None if bias is None else bias.cpu())
        got = y.cpu()
        rel = rel_l2(got.float().numpy(), want.float().numpy())
        if rel >= worst[0]:
            worst = (rel, float((got.float() - want.float()).abs().max()),
                     wkey)
    return dict(products=len(records), worst_rel_l2=worst[0],
                worst_max_abs=worst[1], worst_key=worst[2])


def check_int8_cli(tmp, modules, cfg, images):
    """Phase 19a: phase 3's seeded ViT-S/16@224 rope-mixed checkpoint
    through the predict CLI with --int8 in each mode (w8a8-static
    calibrated with --calib on CALIB_IMAGES of the images), 256 images at
    batch 64, every count reset just before and read just after: attn_fwd
    exactly 12 a batch (and 12 for the calibration forward), all resident,
    torch._int_mm exactly 50 a batch. Then the same quantized state through
    the Predictor on the card: every product against the CPU's on the
    card's inputs (INT8_PRODUCT_TOL), the logits against the same mode's
    forward on the CPU (a batch of 8) and against the card's float32 logits
    (INT8_F32_TOL). Returns
    ({mode: result}, {mode: card Predictor}, the float32 Predictor,
    params)."""
    fa, vit, checkpoint, predict, serving, quant, fused_adamw, ts = modules
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ckpt = checkpoint.save(os.path.join(tmp, "vit_s16_rope-mixed.npz"), params,
                           vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    inputs = os.path.join(tmp, "int8_input.npz")
    calib_path = os.path.join(tmp, "int8_calib.npz")
    np.savez(inputs, images=images)
    np.savez(calib_path, images=images[:CALIB_IMAGES])
    grid = cfg.img_size // cfg.patch_size
    f32 = serving.Predictor.from_params(*serving.load_serving_state(
        ckpt, grid_size=grid, num_heads=cfg.num_heads)[:5])
    f32_logits = batched_logits(f32, images)
    batches = len(images) // 64
    results, predictors = {}, {}
    for mode in INT8_MODES:
        static = mode == "w8a8-static"
        argv = [ckpt, "--input", inputs, "--batch_size", "64",
                "--grid_size", str(grid), "--num_heads", str(cfg.num_heads),
                "--int8", "--int8_mode", mode]
        if static:
            argv += ["--calib", calib_path]
        torch.cuda.synchronize()
        reset_counts(fa, fused_adamw)
        quant.LAUNCHES_INT_MM = 0
        t0 = time.perf_counter()
        preds = predict.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(fa, fused_adamw)
        counts["int_mm"] = quant.LAUNCHES_INT_MM
        check_resident(fa, f"predict CLI --int8_mode {mode}")
        expected = {"attn_fwd": cfg.depth * (batches + int(static)),
                    "attn_bwd": 0, "adamw": 0,
                    "int_mm": int8_products(cfg, batches, mode)}
        qparams, qcfg, mean, std, native, _ = serving.load_serving_state(
            ckpt, grid_size=grid, num_heads=cfg.num_heads, int8=mode,
            calib_images_u8=images[:CALIB_IMAGES] if static else None)
        card = serving.Predictor.from_params(qparams, qcfg, mean, std, native,
                                             int8=mode)
        cpu = serving.Predictor.from_params(qparams, qcfg, mean, std, native,
                                            device="cpu", int8=mode)
        got = batched_logits(card, images)
        rel_cpu = rel_l2(got[:8], cpu.logits(images[:8]))
        products = int8_product_errors(
            quant, ts, {k: v.to(card.device) for k, v in qparams.items()},
            qcfg, mode, images, mean, std, native)
        rel_f32 = rel_l2(got, f32_logits)
        agree = float((np.argmax(got, -1) == np.argmax(f32_logits, -1)).mean())
        log(f"  predict CLI ViT-S/16@224 --int8_mode {mode}: {len(preds)} "
            f"images in {seconds:.2f} s, launches {counts} (expected "
            f"{expected}); each of the {products['products']} products vs the "
            f"CPU's on its inputs: worst rel L2 "
            f"{products['worst_rel_l2']:.3e} (max abs "
            f"{products['worst_max_abs']:.3e}, {products['worst_key']}; tol "
            f"{INT8_PRODUCT_TOL[mode]:g}); logits vs the CPU's forward (8 "
            f"images) rel L2 {rel_cpu:.3e} (tol {INT8_F32_TOL[mode]:g}), vs "
            f"float32 on the card rel L2 {rel_f32:.4f} (tol "
            f"{INT8_F32_TOL[mode]:g}), top-1 agreement {agree:.4f}")
        if counts != expected:
            raise AssertionError(f"{mode}: launch counts differ")
        if not np.array_equal(np.argmax(got, -1), preds):
            raise AssertionError(f"{mode}: CLI predictions differ from the "
                                 f"Predictor's")
        if not np.isfinite(got).all() or got.shape != (len(images), 10):
            raise AssertionError(f"{mode}: bad logits {got.shape}")
        if products["worst_rel_l2"] > INT8_PRODUCT_TOL[mode]:
            raise AssertionError(f"{mode}: an int8 product on the card "
                                 f"differs from the CPU's: {products}")
        if rel_cpu > INT8_F32_TOL[mode] or rel_f32 > INT8_F32_TOL[mode]:
            raise AssertionError(f"{mode}: int8 logits out of bounds")
        results[mode] = dict(seconds=seconds, launches=counts,
                             products_vs_cpu=products,
                             rel_l2_vs_cpu=rel_cpu, rel_l2_vs_f32=rel_f32,
                             top1_agreement_vs_f32=agree)
        predictors[mode] = card
    return results, predictors, f32, params


def check_int8_agreement(serving, datasets, keep_dir):
    """Phase 19b: phase 8's trained ViT-tiny/4 checkpoints (rope-mixed,
    relative) served in each int8 mode: top-1 agreement with float32 on
    256 test images of the synthetic CIFAR-10 at least INT8_AGREE
    (w8a8-static calibrated on 64 training images)."""
    data = datasets.synthetic("cifar10", seed=0)
    images, calib = data.test_x[:256], data.train_x[:CALIB_IMAGES]
    out = {}
    for pe_name in ("rope-mixed", "relative"):
        ckpt = os.path.join(keep_dir, f"phase8_{pe_name}.npz")
        state = serving.load_serving_state(ckpt)
        f32 = batched_logits(serving.Predictor.from_params(*state[:5]), images)
        for mode in INT8_MODES:
            q = serving.load_serving_state(
                ckpt, int8=mode,
                calib_images_u8=calib if mode == "w8a8-static" else None)
            got = batched_logits(serving.Predictor.from_params(
                *q[:5], int8=mode), images)
            agree = float((np.argmax(got, -1) == np.argmax(f32, -1)).mean())
            acc = 100.0 * float((np.argmax(got, -1) == data.test_y[:256])
                                .mean())
            f32_acc = 100.0 * float((np.argmax(f32, -1) == data.test_y[:256])
                                    .mean())
            log(f"  trained ViT-tiny/4 {pe_name} {mode}: top-1 agreement with "
                f"float32 {agree:.4f} (bar {INT8_AGREE}), accuracy {acc:.2f}% "
                f"(float32 {f32_acc:.2f}%)")
            if agree < INT8_AGREE:
                raise AssertionError(f"{pe_name} {mode}: int8 agrees with "
                                     f"float32 on {agree:.4f} of the images")
            out[f"{pe_name} {mode}"] = dict(agreement=agree, accuracy=acc,
                                            f32_accuracy=f32_acc)
    return out


def check_int8_streaming(fa, vit, serving, mean, std, device):
    """Phase 19c: the long-sequence model (N = 4,097) in rope-axial at batch
    4, w8a16 (bfloat16 q, k, v) through the Predictor: exactly one
    streaming forward and one prologue a block, finite logits within
    INT8_F32_TOL of float32; the forward's times against float32, the
    streaming wrapper alone with bfloat16 against float32 inputs; then the
    same model exported on the card (w8a16) and replayed: bit-equal to the
    live Predictor, the same launches."""
    from vit_rpe_rope_tpu_torch.configs import ViTConfig

    cfg = ViTConfig(**LONGSEQ, pos_encoding="rope-axial")
    params = vit.init_params(torch.Generator().manual_seed(12), cfg,
                             device="cpu")
    size = cfg.img_size
    images = np.random.default_rng(12).integers(
        0, 256, (4, size, size, 3), dtype=np.uint8)
    f32 = serving.Predictor.from_params(params, cfg, mean, std, size)
    q = serving.Predictor.from_params(params, cfg, mean, std, size,
                                      int8="w8a16")

    def counted(pred):
        torch.cuda.synchronize()
        fa.LAUNCHES = fa.LAUNCHES_STREAM_FWD = 0
        fa.LAUNCHES_STREAM_FWD_PROLOGUE = 0
        logits = pred.logits(images)
        return logits, {"attn_fwd": fa.LAUNCHES,
                        "attn_stream_fwd": fa.LAUNCHES_STREAM_FWD,
                        "attn_stream_fwd_prologue":
                            fa.LAUNCHES_STREAM_FWD_PROLOGUE}

    got, counts = counted(q)
    want = f32.logits(images)
    expected = {"attn_fwd": 0, "attn_stream_fwd": cfg.depth,
                "attn_stream_fwd_prologue": cfg.depth}
    rel = rel_l2(got, want)
    u8 = torch.from_numpy(images).to(device)
    times = {label: median_ms(lambda: pred.forward(u8), iters=3, reps=5,
                              warmup=2)
             for label, pred in (("f32", f32), ("w8a16", q))}
    shape = (4, cfg.num_heads, cfg.seq_len, cfg.head_dim)
    wrapper = {}
    for dtype in (torch.float32, torch.bfloat16):
        qq, kk, vv, kw, _ = stream_inputs(fa, "rope-axial", shape, dtype, 19,
                                          device)
        wrapper[str(dtype)[6:]] = median_ms(
            lambda: fa.attention_stream_fwd(qq, kk, vv, shape[-1] ** -0.5,
                                            **kw))
    t0 = time.perf_counter()
    exported = serving.export_model(params, cfg, mean, std, size,
                                    int8="w8a16")
    export_s = time.perf_counter() - t0
    replay = serving.Predictor(exported.module(), (size, size, 3),
                               device=device)
    again, replay_counts = counted(replay)
    log(f"  long-sequence rope-axial N={cfg.seq_len} batch 4 w8a16: launches "
        f"{counts} (expected {expected}), logits vs float32 rel L2 {rel:.4f} "
        f"(tol {INT8_F32_TOL['w8a16']:g}); forward {times['w8a16']:.3f} ms "
        f"(float32 {times['f32']:.3f} ms); the streaming wrapper at {shape} "
        f"bf16 {wrapper['bfloat16']:.4f} ms, f32 {wrapper['float32']:.4f} ms;"
        f" exported in {export_s:.1f} s, replay bit-equal "
        f"{np.array_equal(again, got)}, launches {replay_counts}")
    if counts != expected or replay_counts != expected:
        raise AssertionError("w8a16 streaming launches differ")
    if not np.isfinite(got).all() or rel > INT8_F32_TOL["w8a16"]:
        raise AssertionError(f"w8a16 streaming logits: rel L2 {rel}")
    if not np.array_equal(again, got):
        raise AssertionError("the streaming artifact differs from the live "
                             "Predictor")
    return dict(launches=counts, export_launches=replay_counts,
                rel_l2_vs_f32=rel, forward_ms=times, wrapper_ms=wrapper,
                export_seconds=export_s)


# Run in a fresh process by check_artifacts: imports only the serving module
# (which loads the kernels' custom ops with the artifact), replays each
# artifact at batches 64 and 37 and writes the logits and the attention
# launches counted during each replay.
ARTIFACT_REPLAY = """
import json, sys, time
import numpy as np
import torch
from vit_rpe_rope_tpu_torch import serving
images = np.load(sys.argv[1])
out = {}
for path in sys.argv[2:]:
    t0 = time.perf_counter()
    pred = serving.Predictor.from_artifact(path)
    fa = sys.modules["vit_rpe_rope_tpu_torch.ops.flash_attention"]
    out[path] = {"load_seconds": time.perf_counter() - t0}
    for b in (64, 37):
        torch.cuda.synchronize()
        fa.LAUNCHES = fa.LAUNCHES_RESIDENT = fa.LAUNCHES_WIDE = 0
        np.save(f"{path}.{b}.npy", pred.logits(images[:b]))
        out[path][b] = {"attn_fwd": fa.LAUNCHES,
                        "resident": fa.LAUNCHES_RESIDENT,
                        "wide": fa.LAUNCHES_WIDE}
print(json.dumps(out))
"""


def check_artifacts(tmp, serving, cfg, params, live, images, mean, std):
    """Phase 19d: ViT-S/16@224 rope-mixed exported on the card in float32
    and w8a8, saved, and replayed in a fresh process that imports only
    vit_rpe_rope_tpu_torch.serving, at batches 64 and 37: logits bit-equal
    to the live Predictors', attn_fwd launched 12 times a replay (all
    resident). Returns the results and the float32 artifact's program
    (replayed in this process for phase 19e)."""
    paths, out, programs = [], {}, {}
    for label, int8 in (("f32", False), ("w8a8", "w8a8")):
        t0 = time.perf_counter()
        exported = serving.export_model(params, cfg, mean, std, 32,
                                        int8=int8)
        export_s = time.perf_counter() - t0
        path = serving.save_artifact(os.path.join(tmp, f"vit_s16_{label}"),
                                     exported)
        paths.append(path)
        programs[label] = exported
        out[label] = dict(export_seconds=export_s,
                          bytes=os.path.getsize(path))
    np.save(os.path.join(tmp, "images.npy"), images[:64])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", ARTIFACT_REPLAY,
         os.path.join(tmp, "images.npy"), *paths],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=600)
    replay_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"artifact replay failed:\n{proc.stderr[-4000:]}")
    replayed = json.loads(proc.stdout.strip().splitlines()[-1])
    for (label, int8), path in zip((("f32", False), ("w8a8", "w8a8")), paths):
        pred = live[label]
        res = replayed[path]
        for b in (64, 37):
            got = np.load(f"{path}.{b}.npy")
            want = pred.logits(images[:b])
            counts = res[str(b)]
            same = np.array_equal(got, want)
            log(f"  artifact {label} ({out[label]['bytes']:,} bytes, exported "
                f"in {out[label]['export_seconds']:.1f} s, loaded in "
                f"{res['load_seconds']:.1f} s in a fresh process) batch {b}: "
                f"bit-equal to the live Predictor {same}, launches {counts}")
            if not same:
                raise AssertionError(f"artifact {label} batch {b} differs "
                                     f"from the live Predictor: max "
                                     f"{np.abs(got - want).max():.3e}")
            if counts != {"attn_fwd": cfg.depth, "resident": cfg.depth,
                          "wide": 0}:
                raise AssertionError(f"artifact {label}: launches {counts}")
        out[label].update(load_seconds=res["load_seconds"],
                          launches={b: res[str(b)] for b in (64, 37)})
    out["replay_process_seconds"] = replay_s
    return out, programs["f32"]


def int_mm_bound_ms(m, k, n):
    nbytes = m * k + k * n + 4 * m * n  # int8 in, int32 out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * k * n / INT8_BOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_int8_serving(serving, quant, predictors, f32, program, images,
                      device):
    """Phase 19e: device forward times at batch 64 (CUDA events, medians) of
    the float32, w8a8, w8a8-static and w8a16 Predictors and of the float32
    artifact's program; one int8 product at the fc1 shape (torch._int_mm
    alone and through quant._int_mm's padding) against the float32 and the
    bfloat16 torch.matmul (TF32 off), with its bound; a profiler breakdown
    of each int8 mode's forward (phase 5c does float32's)."""
    u8 = torch.from_numpy(images[:64]).to(device)
    artifact = serving.Predictor(program.module(), (32, 32, 3), device=device)
    rows = {}
    for label, pred in (("f32", f32), *predictors.items(),
                        ("f32 artifact", artifact)):
        ms = median_ms(lambda: pred.forward(u8), iters=5, reps=5, warmup=2)
        rows[label] = dict(forward_ms=ms, img_per_s=64e3 / ms)
        log(f"  serving ViT-S/16@224 bs64 {label:12s}: device forward "
            f"{ms:.3f} ms/batch ({64e3 / ms:.1f} img/s)")
    traces = {}
    for label, pred in predictors.items():
        log(f"  {label}:")
        traces[label] = profile_forward(pred, images)
    m, k, n = INT_MM_SHAPE
    gen = torch.Generator().manual_seed(19)
    a = torch.randint(-127, 128, (m, k), generator=gen,
                      dtype=torch.int8).to(device)
    w = torch.randint(-127, 128, (n, k), generator=gen,
                      dtype=torch.int8).to(device)
    a_pad = torch.cat([a, a.new_zeros((quant.INT_MM_PAD_ROWS, k))])
    xf, wf = a.float(), w.float()
    xb, wb = xf.bfloat16(), wf.bfloat16()
    if not torch.equal(quant._int_mm(a, w).cpu(), quant._int_mm(a.cpu(),
                                                                w.cpu())):
        raise AssertionError("torch._int_mm on the card differs from the CPU")
    products = dict(
        int_mm=median_ms(lambda: torch._int_mm(a_pad, w.t())),
        int_mm_padded=median_ms(lambda: quant._int_mm(a, w)),
        f32_matmul=median_ms(lambda: torch.matmul(xf, wf.t())),
        bf16_matmul=median_ms(lambda: torch.matmul(xb, wb.t())))
    bound, bound_by = int_mm_bound_ms(m + quant.INT_MM_PAD_ROWS, k, n)
    products.update(bound_ms=bound, bound_by=bound_by, shape=[m, k, n])
    log(f"  int8 product at fc1 ({m} x {k} x {n}): torch._int_mm "
        f"{products['int_mm']:.4f} ms, with the padding "
        f"{products['int_mm_padded']:.4f} ms, float32 matmul "
        f"{products['f32_matmul']:.4f} ms, bfloat16 matmul "
        f"{products['bf16_matmul']:.4f} ms, bound {bound:.4f} ms "
        f"({bound_by})")
    return dict(serving=rows, product=products, profiles=traces)


# Phase 20: data parallelism, ZeRO-1, antialiased downsampling.
DP_STEP_TOL = 1e-4       # two ranks vs one: relative, each loss of the
DP_EARLY_STEPS = 5       # first steps (the gradient summed over two half
#   batches: float32 sums in another order). The epoch's row is not held to
#   it: on the synthetic task the loss collapses within the epoch, and the
#   step at which it does amplifies any difference (both rows must learn).
DOWNSAMPLE_TOL = 1e-6    # make_preprocess 32 -> 16 px, card vs CPU
DP_WORKER_TIMEOUT = 300  # seconds for one two-rank launch
CSV_FIELDS = ("train_loss", "train_acc", "test_loss", "test_acc")

# One rank of phases 20b, 21 and 22b-d, in a process of its own: the train
# CLI under torchrun's environment (set by the caller) once per run of the
# JSON payload {label: [port, argv, n_train]}, each in {out}/{label} with
# the launch counts reset before it (n_train: the synthetic set cut to
# n_train / n_train // 5 examples, or null for the whole set); each run's
# final params (the rank's shard under tensor parallelism), launch counts,
# per-step losses (of the train step, or of the bounded step with
# --q_chunk), the seconds between the ends of consecutive steps (each
# step's end synchronized) and the batch sizes and head counts the
# attention wrappers saw (the dense ones, and the streaming ones where they
# ran) go to {out}/{label}/rank{RANK}.npz / .json.
DP_RANK = r"""
import json, os, sys, time
import numpy as np
import torch
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa, fused_adamw
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

out, runs = sys.argv[1], json.loads(sys.argv[2])
rank = os.environ["RANK"]
final, batches, heads, rows, losses, stamps = {}, {}, {}, {}, [], []
make, real_dataset = ts.make_train_step, datasets.get_dataset
make_bounded = loop.make_bounded_step

def make_train_step(*args, _make=make, **kw):
    step = _make(*args, **kw)

    def recorded(*a, **k):
        result = step(*a, **k)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        final["params"] = result[0]
        losses.append(result[2][0])
        return result

    recorded.evaluate = getattr(step, "evaluate", None)
    return recorded

STREAM = {"attn_stream_fwd": "STREAM_FWD",
          "attn_stream_fwd_prologue": "STREAM_FWD_PROLOGUE",
          "attn_stream_bwd_prologue": "STREAM_PROLOGUE",
          "attn_stream_bwd_dq": "STREAM_DQ",
          "attn_stream_bwd_dkv": "STREAM_DKV",
          "attn_stream_bwd_dbias": "STREAM_DBIAS",
          "attn_stream_bwd_fused": "STREAM_FUSED",
          "attn_stream_bwd_fused_prologue": "STREAM_FUSED_PROLOGUE",
          "attn_stream_chunk_fwd": "STREAM_CHUNK_FWD"}
ts.make_train_step = make_train_step
loop.make_bounded_step = lambda *a, **k: make_train_step(
    *a, _make=make_bounded, **k)
for name in ("fwd", "bwd", "stream_fwd", "stream_bwd", "stream_bwd_fused"):
    def wrapped(q, *a, _fn=getattr(fa, "attention_" + name), _n=name, **k):
        batches["attn_" + _n].add(int(q.shape[0]))
        heads["attn_" + _n].add(int(q.shape[1]))
        return _fn(q, *a, **k)
    setattr(fa, "attention_" + name, wrapped)
for name in ("streaming_chunk_fwd", "streaming_chunk_bwd"):
    def chunk(q, *a, _fn=getattr(fa, name), _n=name, **k):
        key = "attn_stream_chunk_" + _n[-3:]
        batches[key].add(int(q.shape[0]))
        heads[key].add(int(q.shape[1]))
        rows[key].add(int(q.shape[2]))
        return _fn(q, *a, **k)
    setattr(fa, name, chunk)
CHUNKS = ("stream_chunk_fwd", "stream_chunk_bwd")
for label, (port, argv, n_train) in runs.items():
    datasets.get_dataset = real_dataset if n_train is None else (
        lambda dataset, data_dir, use_synthetic, seed, _n=n_train:
        datasets.synthetic(dataset, n_train=_n, n_test=_n // 5, seed=seed))
    os.environ["MASTER_PORT"] = str(port)
    run_dir = os.path.join(out, label)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    fa.LAUNCHES = fa.LAUNCHES_BWD = 0
    fused_adamw.LAUNCHES_ADAMW = fused_adamw.LAUNCHES_ADAMW_TABLE = 0
    for name in STREAM.values():
        setattr(fa, "LAUNCHES_" + name, 0)
    for record in (batches, heads, rows):
        record.clear()
        record.update({"attn_" + n: set() for n in (
            "fwd", "bwd", "stream_fwd", "stream_bwd", "stream_bwd_fused")
            + CHUNKS})
    losses.clear()
    stamps.clear()
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    np.savez(f"rank{rank}.npz", **{k: v.detach().cpu().numpy()
                                   for k, v in final["params"].items()})
    with open(f"rank{rank}.json", "w") as f:
        json.dump(dict(seconds=seconds, history=summary["history"],
                       log_file=summary["log_file"],
                       num_devices=summary["num_devices"],
                       launches={"attn_fwd": fa.LAUNCHES,
                                 "attn_bwd": fa.LAUNCHES_BWD,
                                 "adamw": fused_adamw.LAUNCHES_ADAMW,
                                 "adamw_table":
                                     fused_adamw.LAUNCHES_ADAMW_TABLE,
                                 **{k: getattr(fa, "LAUNCHES_" + n)
                                    for k, n in STREAM.items()
                                    if getattr(fa, "LAUNCHES_" + n)}},
                       batches={k: sorted(v) for k, v in batches.items()
                                if v},
                       heads={k: sorted(v) for k, v in heads.items() if v},
                       rows={k: sorted(v) for k, v in rows.items() if v},
                       step_losses=[float(x) for x in losses],
                       step_seconds=np.diff(stamps).tolist()), f)
"""


def free_port() -> int:
    with contextlib.closing(__import__("socket").socket()) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(world: int, rank: int = 0):
    """torchrun's environment variables for one rank on this host, set for
    the body and removed after it."""
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield env
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def cli_epoch(train_modules, argv, world_env=None, keep_dir=None,
              resume_from=None):
    """One epoch of the train CLI (TINY_ARGV + argv) in a scratch directory
    with the counts reset just before and read just after; world_env: a
    torchrun_env to run it under (a process group of one, this process).
    Returns the CSV row, every array of `_last.npz`, the launches and the
    times; the best checkpoint is copied into keep_dir when one is given.
    resume_from: a `_last.npz` put into the scratch directory's
    checkpoints first (for argv with --resume)."""
    from vit_rpe_rope_tpu_torch.train import loop
    from vit_rpe_rope_tpu_torch.train import train_step as ts

    fa, fused_adamw, train_cli, _, _ = train_modules
    losses, stamps, make = [], [], ts.make_train_step
    make_bounded = loop.make_bounded_step

    def make_train_step(*args, _make=make, **kw):  # records each step's loss
        step = _make(*args, **kw)

        def recorded(*a, **k):
            result = step(*a, **k)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            losses.append(result[2][0])
            return result

        recorded.evaluate = getattr(step, "evaluate", None)
        return recorded

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        if resume_from:
            os.makedirs(os.path.join(tmp, "checkpoints"))
            shutil.copy(resume_from, os.path.join(tmp, "checkpoints"))
        os.chdir(tmp)
        ts.make_train_step = make_train_step
        loop.make_bounded_step = lambda *a, **k: make_train_step(
            *a, _make=make_bounded, **k)
        try:
            with (world_env or contextlib.nullcontext()):
                reset_counts(fa, fused_adamw)
                t0 = time.perf_counter()
                summary = train_cli.main(TINY_ARGV + argv)
                counts = read_counts(fa, fused_adamw)
                seconds = time.perf_counter() - t0
            routes = check_resident(fa, f"train CLI {argv}")
            with open(summary["log_file"]) as f:
                row = list(f)[1].strip()
            last_path, = glob.glob(os.path.join(tmp, "checkpoints",
                                                "cifar10_*_last.npz"))
            with np.load(last_path) as z:
                last = {k: z[k] for k in z.files}
            ckpt = None
            if keep_dir:
                ckpt = shutil.copy(os.path.abspath(summary["ckpt_path"]),
                                   keep_dir)
        finally:
            ts.make_train_step = make
            loop.make_bounded_step = make_bounded
            os.chdir(cwd)
    ips = summary["history"][0]["images_per_sec"]
    return dict(row=row, last=last, launches=counts, routes=routes,
                seconds=seconds, images_per_s=ips,
                step_ms=1000.0 * 128 / ips, num_devices=summary["num_devices"],
                ckpt=ckpt, step_losses=[float(x) for x in losses],
                step_seconds=np.diff(stamps).tolist())


def steady_ms(record: dict) -> float:
    """The median ms between the ends of consecutive train steps of a run
    (cli_epoch's or a gloo rank's record): its steps after the first, so a
    process's first-call costs are left out."""
    return 1000.0 * statistics.median(record["step_seconds"])


def state_differences(a: dict, b: dict) -> dict:
    """{key: largest |difference| relative to b's largest entry} of the
    arrays of two `_last.npz` that differ."""
    out = {}
    for key in b:
        if not np.array_equal(a[key], b[key]):
            want = np.asarray(b[key], np.float64)
            out[key] = float(np.abs(np.asarray(a[key], np.float64) - want)
                             .max() / max(np.abs(want).max(), 1e-30))
    return out


def csv_fields(row: str) -> dict:
    values = row.split(",")
    return dict(zip(("epoch",) + CSV_FIELDS + ("best_acc",),
                    map(float, values)))


def check_world_one(train_modules):
    """Phase 20a: the ViT-tiny/4 train CLI at its defaults for one epoch,
    plainly, then under torchrun's variables at world size 1 (an NCCL
    group of this process) without and with --zero1, then with --zero1 and
    --steps_per_dispatch GRAPH_K without a group (ZeRO-1's one slice
    through AdamW's device-table entry in the CUDA graph): each CSV row and
    `_last.npz` against the plain run's, bit for bit (the world-size-1 run
    repeats the plain one), the launches and the step times."""
    graphed = -(-100 // GRAPH_K) * GRAPH_K + 1  # captured steps + warm-up
    # Under the process group the 20 evaluation rows run eagerly (no
    # warm-up forward); without one, in a graph.
    eager_eval = dict(TINY_LAUNCHES, attn_fwd=6 * (100 + 20))
    cases = (("nccl", [], True, eager_eval),
             ("nccl_zero1", ["--zero1"], True, eager_eval),
             ("zero1_graph", ["--zero1", "--steps_per_dispatch",
                              str(GRAPH_K)], False,
              {"attn_fwd": 6 * (graphed + 21), "attn_bwd": 6 * graphed,
               "adamw": 0, "adamw_table": graphed}))
    runs = {"plain": cli_epoch(train_modules, [])}
    if runs["plain"]["launches"] != TINY_LAUNCHES:
        raise AssertionError(f"plain: launches {runs['plain']['launches']}, "
                             f"expected {TINY_LAUNCHES}")
    for label, argv, group, _ in cases:
        runs[label] = cli_epoch(train_modules, argv,
                                torchrun_env(1) if group else None)
        if runs[label]["num_devices"] != 1:
            raise AssertionError(f"{label}: {runs[label]['num_devices']} "
                                 f"devices")
    plain = runs["plain"]
    out = {}
    for label, _, _, expected in cases:
        run = runs[label]
        diffs = state_differences(run["last"], plain["last"])
        same = run["row"] == plain["row"] and not diffs
        out[label] = dict(bit_equal=same, row=run["row"], differences=diffs,
                          launches=run["launches"], step_ms=run["step_ms"],
                          images_per_s=run["images_per_s"])
        log(f"  world 1 {label}: CSV row {run['row']} (plain "
            f"{plain['row']}); _last.npz and row bit-equal to the plain "
            f"run: {same}{'' if same else f' (differences {diffs})'}; "
            f"launches {run['launches']} (expected {expected}); "
            f"{run['step_ms']:.3f} ms a step (plain "
            f"{plain['step_ms']:.3f}), {run['images_per_s']:.1f} img/s")
        if not same:
            raise AssertionError(f"{label} at world size 1 differs from the "
                                 f"plain run: {diffs}")
        if run["launches"] != expected:
            raise AssertionError(f"{label}: launches {run['launches']}, "
                                 f"expected {expected}")
    out["plain"] = dict(row=plain["row"], launches=plain["launches"],
                        step_losses=plain["step_losses"],
                        step_seconds=plain["step_seconds"],
                        step_ms=[plain["step_ms"]],
                        images_per_s=plain["images_per_s"])
    return out, runs


def rank_processes(script, args, world, timeout):
    """`script` (python -c) on `world` ranks of torchrun's environment on
    this host, each a process of its own; returns [(returncode, output)]
    per rank. A launch that outlasts `timeout` is killed (returncode
    None)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    out = []
    try:
        for p in procs:
            try:
                out.append((p.communicate(timeout=timeout)[0], p))
            except subprocess.TimeoutExpired:
                p.kill()
                out.append((p.communicate()[0], None))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(None if p is None else p.returncode, text) for text, p in out]


def gloo_ranks(runs, world=2, n_train=None, keep_dir=None,
               timeout=DP_WORKER_TIMEOUT):
    """Phases 20b to 24: the train CLI (TINY_ARGV + argv, for each
    label: argv of `runs`) on `world` ranks sharing the card over gloo,
    each rank a process of its own (DP_RANK) that trains every run in turn,
    in one scratch directory, on the synthetic set cut to n_train examples
    when given (one size for every run, or {label: size}); a rank that
    fails, or a launch that outlasts `timeout` seconds,
    fails the phase. Returns, per label, each rank's record with its final
    params, rank 0's CSV row and the CSVs written (and with keep_dir, the
    path of its `_last.npz`, copied to keep_dir/label/); and the launch's
    seconds."""
    sizes = n_train if isinstance(n_train, dict) else dict.fromkeys(
        runs, n_train)
    payload = json.dumps({label: [free_port(), TINY_ARGV + argv
                                  + ["--dist_backend", "gloo"], sizes[label]]
                          for label, argv in runs.items()})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        results = rank_processes(DP_RANK, [tmp, payload], world,
                                 timeout)
        seconds = time.perf_counter() - t0
        for r, (rc, text) in enumerate(results):
            if rc != 0:
                raise AssertionError(f"rank {r} of {list(runs)} failed "
                                     f"({rc}):\n{text[-4000:]}")
        out = {}
        for label in runs:
            run_dir = os.path.join(tmp, label)
            ranks = []
            for r in range(world):
                with open(os.path.join(run_dir, f"rank{r}.json")) as f:
                    record = json.load(f)
                with np.load(os.path.join(run_dir, f"rank{r}.npz")) as z:
                    record["params"] = {k: z[k] for k in z.files}
                ranks.append(record)
            with open(os.path.join(run_dir, ranks[0]["log_file"])) as f:
                row = list(f)[1].strip()
            out[label] = dict(ranks=ranks, row=row, csvs=os.listdir(
                os.path.join(run_dir, "logs")))
            if keep_dir:
                last, = glob.glob(os.path.join(run_dir, "checkpoints",
                                               "*_last.npz"))
                os.makedirs(os.path.join(keep_dir, label))
                out[label]["last"] = shutil.copy(
                    last, os.path.join(keep_dir, label))
    return out, seconds


def check_two_ranks(world_one):
    """Phase 20b: plain data parallelism and --zero1 on two gloo ranks that
    share the card: the ranks' params bit-equal, ZeRO-1's equal to plain
    data parallelism's, the first DP_EARLY_STEPS step losses within
    DP_STEP_TOL of the one-rank run's (phase 20a), both rows past the
    learning bar, each rank's launches of rows 1, 2 and 11 (the attention
    at the half batch, AdamW once a step)."""
    one = csv_fields(world_one["plain"]["row"])
    one_losses = np.asarray(world_one["plain"]["step_losses"])
    expected = {"attn_fwd": 6 * 120, "attn_bwd": 6 * 100, "adamw": 100,
                "adamw_table": 0}
    out = {}
    runs, seconds = shared_launch(2)  # the two-rank runs of phases 20-23
    for label in ("dp", "zero1"):
        run = runs[label]
        r0, r1 = run["ranks"]
        same = all(np.array_equal(r0["params"][k], r1["params"][k])
                   for k in r0["params"])
        fields = csv_fields(run["row"])
        rel = {k: abs(fields[k] - one[k]) / max(abs(one[k]), 1e-30)
               for k in ("train_loss", "test_loss")}
        pts = {k: abs(fields[k] - one[k]) for k in ("train_acc", "test_acc")}
        step_rel = (np.abs(np.asarray(r0["step_losses"]) - one_losses)
                    / np.abs(one_losses))
        apart = np.flatnonzero(step_rel > 1e-3)
        early = [float(f"{x:.3g}") for x in step_rel[:DP_EARLY_STEPS]]
        tenth = [float(f"{x:.3g}") for x in step_rel[::10]]
        log(f"    {label} step losses against one rank, relative: first "
            f"{DP_EARLY_STEPS} {early}, every 10th {tenth}; first step past "
            f"1e-3: {int(apart[0]) if apart.size else None}")
        rank_seconds = [round(r["seconds"], 1) for r in run["ranks"]]
        log(f"  two gloo ranks {label}: rank seconds {rank_seconds}; CSV row "
            f"{run['row']} (one rank: {world_one['plain']['row']}); "
            f"relative {rel}, points {pts}; ranks' params bit-equal {same}; "
            f"CSVs written {run['csvs']}")
        for r, rec in enumerate(run["ranks"]):
            ips = rec["history"][0]["images_per_sec"]
            log(f"    rank {r}: launches {rec['launches']} (expected "
                f"{expected}), attention batch sizes {rec['batches']}, "
                f"{1000.0 * 128 / ips:.3f} ms a step ({ips:.1f} img/s; "
                f"steps after the first {steady_ms(rec):.3f}, one rank "
                f"{steady_ms(world_one['plain']):.3f}), devices "
                f"{rec['num_devices']}")
            if rec["launches"] != expected:
                raise AssertionError(f"{label} rank {r}: launches "
                                     f"{rec['launches']}, expected "
                                     f"{expected}")
            if rec["batches"] != {"attn_fwd": [64], "attn_bwd": [64]}:
                raise AssertionError(f"{label} rank {r}: attention batches "
                                     f"{rec['batches']}, expected [64]")
            if rec["num_devices"] != 2:
                raise AssertionError(f"{label} rank {r}: "
                                     f"{rec['num_devices']} devices")
        if r1["log_file"] is not None or len(run["csvs"]) != 1:
            raise AssertionError(f"{label}: rank 1 wrote a CSV, or not one "
                                 f"CSV: {run['csvs']}")
        if not same:
            raise AssertionError(f"{label}: the ranks' params differ")
        if step_rel[:DP_EARLY_STEPS].max() > DP_STEP_TOL:
            raise AssertionError(f"{label}: the first step losses differ "
                                 f"from one rank's: {step_rel[:5]}")
        if not (fields["train_loss"] < LEARN_BAR["rope-mixed"]["train_loss"]
                and fields["test_acc"] > LEARN_BAR["rope-mixed"]["test_acc"]):
            raise AssertionError(f"{label}: two ranks did not learn: "
                                 f"{run['row']}")
        out[label] = dict(row=run["row"], relative=rel, points=pts,
                          step_relative=step_rel.tolist(),
                          seconds=[r["seconds"] for r in run["ranks"]],
                          launches=[r["launches"] for r in run["ranks"]],
                          step_ms=[1000.0 * 128
                                   / r["history"][0]["images_per_sec"]
                                   for r in run["ranks"]],
                          steady_step_ms=[steady_ms(r) for r in run["ranks"]],
                          params=r0["params"])
    zero1_same = all(np.array_equal(out["zero1"]["params"][k],
                                    out["dp"]["params"][k])
                     for k in out["dp"]["params"])
    log(f"  two ranks: --zero1 params bit-equal to plain data parallelism's: "
        f"{zero1_same}; rows {out['zero1']['row']} / {out['dp']['row']}")
    if not zero1_same:
        raise AssertionError("two ranks: ZeRO-1's params differ from plain "
                             "data parallelism's")
    for label in out:
        del out[label]["params"]
    out["zero1_bit_equal_to_dp"] = zero1_same
    out["launch_seconds"] = seconds
    return out


def check_downsampling(train_modules, ts, datasets, device, keep_dir):
    """Phase 20c: one epoch of the train CLI at its defaults with
    --img_size 16 on the synthetic 32 px CIFAR-10 (the antialiased resize
    in every step; N = 17, the dense kernels), exact launches, the learning
    bar, the best checkpoint served to its CSV accuracy, and make_preprocess
    on the card against the CPU on the same batch."""
    fa, fused_adamw, train_cli, serving, _ = train_modules
    run = cli_epoch(train_modules, ["--img_size", "16"], keep_dir=keep_dir)
    expected = TINY_LAUNCHES
    fields = csv_fields(run["row"])
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        run["ckpt"], grid_size=4)
    test = datasets.synthetic("cifar10", seed=0)
    predictor = serving.Predictor.from_params(params, cfg, mean, std, native)
    preds = np.concatenate([predictor.predict(test.test_x[s:s + 128])
                            for s in range(0, len(test.test_y), 128)])
    served = 100.0 * float((preds == test.test_y).mean())
    pre = ts.make_preprocess(cfg, mean, std, native)
    batch = torch.from_numpy(test.test_x[:128])
    card = pre(batch.to(device)).cpu()
    cpu = pre(batch)
    err = float((card - cpu).abs().max())
    log(f"  --img_size 16: CSV row {run['row']}, launches {run['launches']} "
        f"(expected {expected}), {run['step_ms']:.3f} ms a step; served "
        f"accuracy {served:.4f}% (CSV {fields['test_acc']}); make_preprocess "
        f"32 -> 16 on the card vs the CPU: {err:.3e} (tol {DOWNSAMPLE_TOL})")
    if run["launches"] != expected:
        raise AssertionError(f"--img_size 16: launches {run['launches']}")
    if (cfg.img_size, tuple(card.shape)) != (16, (128, 16, 16, 3)):
        raise AssertionError(f"--img_size 16: model {cfg.img_size} px, "
                             f"images {tuple(card.shape)}")
    for key, limit in REGULARISED_BAR.items():
        if not (fields[key] > limit if key == "test_acc"
                else fields[key] < limit):
            raise AssertionError(f"--img_size 16 did not learn: {key} "
                                 f"{fields[key]} (bar {limit})")
    if abs(served - fields["test_acc"]) > 1e-9 or err > DOWNSAMPLE_TOL:
        raise AssertionError("--img_size 16: served accuracy or the resize "
                             "on the card is off")
    return dict(row=run["row"], launches=run["launches"],
                step_ms=run["step_ms"], served_acc=served,
                preprocess_max_abs_err=err, ckpt=run["ckpt"])


def check_dp_serving(modules, ckpt, images):
    """Phase 20d: Predictor.from_params(mesh=make_mesh(num_devices=1)) on
    the card against the one-device Predictor (logits bit for bit, the
    attention launched once a block a batch), and --export_data_parallel 2
    through the predict CLI on a one-card machine exits with the JAX
    CLI's words."""
    fa, fused_adamw, serving, predict, make_mesh = modules
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        ckpt, grid_size=4)
    one = serving.Predictor.from_params(params, cfg, mean, std, native)
    mesh = make_mesh(num_devices=1)
    sharded = serving.Predictor.from_params(params, cfg, mean, std, native,
                                            mesh=mesh)
    want = one.logits(images)
    reset_counts(fa, fused_adamw)
    got = sharded.logits(images)
    launches = read_counts(fa, fused_adamw)
    same = bool(np.array_equal(got, want))
    with tempfile.TemporaryDirectory() as tmp:
        try:
            predict.main([ckpt, "--grid_size", "4", "--export",
                          os.path.join(tmp, "dp2.pt2"),
                          "--export_data_parallel", "2"])
        except SystemExit as e:
            refused = str(e.code)
        else:
            refused = None
    n_cards = torch.cuda.device_count()
    log(f"  data-parallel Predictor over {mesh.devices} (width "
        f"{mesh.size}): {len(images)} images, logits bit-equal to the "
        f"one-device Predictor {same}, launches {launches}; "
        f"--export_data_parallel 2 on {n_cards} card(s): {refused!r}")
    if not same or launches["attn_fwd"] != cfg.depth:
        raise AssertionError("the data-parallel Predictor differs from the "
                             "one-device one")
    if n_cards < 2 and (refused is None
                        or f"only {n_cards} devices visible" not in refused):
        raise AssertionError(f"--export_data_parallel 2 on {n_cards} "
                             f"card(s): {refused!r}")
    return dict(bit_equal=same, launches=launches, refused=refused)


# Phase 21: tensor parallelism (Megatron heads / MLP sharding, ZeRO-1 x TP).
TP_B_TRAIN = 2560        # run (b)'s synthetic examples: 20 steps of 128, and
#   512 test images (4 evaluation rows); run (a) trains on the whole set.
TP_STREAM_TRAIN = 20     # run (c)'s: 5 steps of 4 at N = 4,097, and 4 test
#   images (one evaluation row)


def tp_replicated(params: dict) -> list:
    """The keys of a rank's TP params that every model rank holds whole."""
    from vit_rpe_rope_tpu_torch.parallel import tensor_parallel

    return [k for k, d in tensor_parallel.tp_shard_dims(params).items()
            if d is None]


def check_tp_run(label, run, expected, batch, one_losses, one_step_ms,
                 twin_of, bar=None, heads=None, step_batch=128):
    """Phase 21's checks of one gloo launch of the train CLI under
    --model_parallel 2: every rank's replicated params bit-equal, the
    sharded ones equal across the data ranks of one model rank and not
    across model ranks, the launches exact, the attention wrappers at
    `heads` ({wrapper: head counts}; default the dense kernels, training
    at 3 heads, evaluation at 6 on the gathered params) and at `batch`,
    rank 0 alone writing a CSV, the first DP_EARLY_STEPS step losses
    within DP_STEP_TOL of the one-rank run's, the row past `bar` (when
    given); each rank's step time (of step_batch examples) beside the one
    rank's. twin_of[r]: the first rank with rank r's model position."""
    heads = heads or {"attn_fwd": [3, 6], "attn_bwd": [3]}
    ranks = run["ranks"]
    p0 = ranks[0]["params"]
    keys = tp_replicated(p0)
    replicated_same = all(np.array_equal(r["params"][k], p0[k])
                          for r in ranks for k in keys)
    shard_same = all(np.array_equal(r["params"][k],
                                    ranks[twin_of[i]]["params"][k])
                     for i, r in enumerate(ranks) for k in p0)
    shards_differ = not np.array_equal(
        ranks[0]["params"]["blocks.0.mlp.fc1.weight"],
        ranks[1]["params"]["blocks.0.mlp.fc1.weight"])
    step_rel = (np.abs(np.asarray(ranks[0]["step_losses"]) - one_losses)
                / np.abs(one_losses))
    fields = csv_fields(run["row"])
    step_ms = [1000.0 * step_batch / r["history"][0]["images_per_sec"]
               for r in ranks]
    early = [float(f"{x:.3g}") for x in step_rel[:DP_EARLY_STEPS]]
    log(f"  {label}: CSV row {run['row']}; CSVs written {run['csvs']}; "
        f"replicated params bit-equal on all {len(ranks)} ranks "
        f"{replicated_same} ({len(keys)} of {len(p0)} keys), shards equal "
        f"across data ranks {shard_same}, differ across model ranks "
        f"{shards_differ}; first {DP_EARLY_STEPS} step losses against one "
        f"rank, relative: {early}")
    for r, rec in enumerate(ranks):
        log(f"    rank {r}: launches {rec['launches']} (expected "
            f"{expected}), attention batch sizes {rec['batches']}, heads "
            f"{rec['heads']}, {step_ms[r]:.3f} ms a step (one rank in this "
            f"run: {one_step_ms:.3f}), {rec['seconds']:.1f} s, devices "
            f"{rec['num_devices']}")
        if rec["launches"] != expected:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{rec['launches']}, expected {expected}")
        if rec["heads"] != heads or \
                rec["batches"] != {k: [batch] for k in heads}:
            raise AssertionError(f"{label} rank {r}: attention at heads "
                                 f"{rec['heads']}, batches {rec['batches']}")
        if rec["num_devices"] != len(ranks) or (r and rec["log_file"]):
            raise AssertionError(f"{label} rank {r}: {rec['num_devices']} "
                                 f"devices, log file {rec['log_file']}")
    if len(run["csvs"]) != 1:
        raise AssertionError(f"{label}: CSVs {run['csvs']}")
    if not (replicated_same and shard_same and shards_differ):
        raise AssertionError(f"{label}: the ranks' params are not as the "
                             f"sharding says")
    if not all(math.isfinite(fields[k]) for k in fields):
        raise AssertionError(f"{label}: the CSV row is not finite")
    if step_rel[:DP_EARLY_STEPS].max() > DP_STEP_TOL:
        raise AssertionError(f"{label}: the first step losses differ from "
                             f"one rank's: {step_rel[:DP_EARLY_STEPS]}")
    for key, limit in (bar or {}).items():
        if not (fields[key] > limit if key == "test_acc"
                else fields[key] < limit):
            raise AssertionError(f"{label} did not learn: {run['row']}")
    return dict(row=run["row"], step_relative=step_rel.tolist(),
                launches=[r["launches"] for r in ranks], step_ms=step_ms,
                one_rank_step_ms=one_step_ms,
                seconds=[r["seconds"] for r in ranks])


def cp_argv():
    """Phase 22's train CLI runs by label, without --sequence_parallel:
    the long-sequence model at depth 1 in rope-mixed, relative and
    rope-axial with --q_chunk 2048."""
    return {"cp_rope-mixed": longseq_argv(1, "rope-mixed"),
            "cp_relative": longseq_argv(1, "relative"),
            "cp_q_chunk": longseq_argv(1, "rope-axial") + ["--q_chunk",
                                                           "2048"]}


def longseq_argv(depth, pe):
    """The train CLI's flags of the long-sequence model (LONGSEQ at
    `depth`, batch 4) in PE mode `pe`."""
    argv = []
    for key, value in dict(LONGSEQ, depth=depth).items():
        argv += [f"--{key}", str(value)]
    return argv + ["--pos_encoding", pe, "--batch_size", "4"]


# The train CLI runs of phases 20b to 24 on gloo ranks that share the card
# go in ONE launch per world size (a process's start-up and ~14 s of first
# calls paid once, not once a phase): the two-rank runs of phases 20b,
# 21a, 22b-d and 23a and the four-rank runs of phases 21b-c, 23b and
# 24a-b. Each launch is made where a phase first needs it; the later
# phases check their runs of it. Each run's counts are reset just before
# it and read just after, in the rank (DP_RANK).
SHARED_TIMEOUT = 600     # seconds for one shared launch
_SHARED = {}


def shared_runs(world: int) -> dict:
    """{label: (argv after TINY_ARGV, synthetic examples or None for the
    whole set)} of the shared launch of `world` ranks."""
    if world == 2:
        runs = {"dp": ([], None), "zero1": (["--zero1"], None),
                "tp": (["--model_parallel", "2"], None)}
        cp = ["--sequence_parallel", "2"]
        runs.update({label: (args + cp, CP_TRAIN)
                     for label, args in cp_argv().items()})
        runs["cp_zero1"] = (cp_argv()["cp_rope-mixed"] + cp + ["--zero1"],
                            CP_TRAIN)
        pp = ["--pipeline_parallel", "2"]
        runs["pp"] = (pp + ["--pp_microbatches", str(PP_MICRO)], PP_TRAIN)
        runs["pp_stream"] = (longseq_argv(2, "relative") + pp,
                             PP_STREAM_TRAIN)
        return runs
    tp = ["--model_parallel", "2", "--zero1"]
    runs = {"tp_dp_zero1": (tp + ["--pos_encoding", "relative"],
                            TP_B_TRAIN)}
    for pe in ("rope-mixed", "relative"):
        runs[f"tp_stream_{pe}"] = (longseq_argv(LONGSEQ["depth"], pe) + tp,
                                   TP_STREAM_TRAIN)
    runs["pp_tp"] = (["--pipeline_parallel", "2", "--model_parallel", "2",
                      "--pos_encoding", "relative"], PP_TRAIN)
    runs.update({label: (args, COMP_TRAIN)
                 for label, args in comp_argv().items()})
    return runs


def shared_launch(world: int):
    """(runs, seconds) of the shared launch of `world` ranks (gloo_ranks;
    the two-rank one keeps every run's `_last.npz` under a directory that
    phase 23 removes), made at the first call and returned as made at the
    later ones."""
    if world not in _SHARED:
        runs = shared_runs(world)
        keep = (tempfile.mkdtemp(prefix="chip_smoke_last_") if world == 2
                else None)
        out, seconds = gloo_ranks(
            {k: v[0] for k, v in runs.items()}, world=world,
            n_train={k: v[1] for k, v in runs.items()}, keep_dir=keep,
            timeout=SHARED_TIMEOUT)
        each = {k: round(max(r["seconds"] for r in v["ranks"]), 1)
                for k, v in out.items()}
        log(f"  the shared launch of {world} gloo ranks: {seconds:.1f} s "
            f"(seconds a run: {each})")
        _SHARED[world] = (out, seconds, keep)
    return _SHARED[world][:2]


def check_tensor_parallel(world_one, train_modules, datasets):
    """Phase 21. (a) The ViT-tiny/4 train CLI at its defaults (rope-mixed,
    batch 128) on two gloo ranks sharing the card with --model_parallel 2:
    each rank trains 3 of the 6 heads and half of the MLP rows, evaluates
    the gathered params at 6 heads; held to phase 20a's one-rank run. (b)
    The relative-PE epoch at full width on four gloo ranks (data 2 x model
    2) with --zero1 on TP_B_TRAIN examples (the bias sliced to each rank's
    heads through rows 1 and 2, ZeRO-1 x TP through row 11), held to a
    one-rank epoch of the same data in this process. (c) The long-sequence
    model (N = 4,097, 4 heads, batch 4) in rope-mixed and relative on the
    same four ranks, in the same launch (shared_launch(4), which also
    runs phase 23b's and 24's runs), on TP_STREAM_TRAIN examples: the
    streaming route at 2 heads a rank (the rope-mixed per-head tables and
    the relative table sliced, model rank 1's at a non-zero offset)
    through rows 3, 5, 6 and 7 and their prologues, held to one-rank
    epochs of the same data in this process."""
    one = world_one["plain"]
    runs, seconds_a = shared_launch(2)  # (a): a run of phase 20's launch
    out = {"tp": check_tp_run(
        "--model_parallel 2 (data 1 x model 2)", runs["tp"],
        {"attn_fwd": 6 * 120, "attn_bwd": 6 * 100, "adamw": 100,
         "adamw_table": 0}, 128, np.asarray(one["step_losses"]),
        one["step_ms"][0], twin_of=[0, 1], bar=LEARN_BAR["rope-mixed"])}
    out["tp"]["launch_seconds"] = seconds_a

    # (b) and (c): one-rank epochs of the same data first, then the one
    # launch of four ranks (shared_launch) for the three runs.
    stream_argv = {pe: longseq_argv(LONGSEQ["depth"], pe)
                   for pe in ("rope-mixed", "relative")}
    with small_dataset(datasets, n_train=TP_B_TRAIN,
                       n_test=TP_B_TRAIN // 5):
        one_b = cli_epoch(train_modules, ["--pos_encoding", "relative"])
    log(f"  one rank, relative, {TP_B_TRAIN} examples: CSV row "
        f"{one_b['row']}, launches {one_b['launches']}, "
        f"{one_b['step_ms']:.3f} ms a step")
    one_c = {}
    with small_dataset(datasets, n_train=TP_STREAM_TRAIN,
                       n_test=TP_STREAM_TRAIN // 5):
        for pe, args in stream_argv.items():
            one_c[pe] = cli_epoch(train_modules, args)
            log(f"  one rank, long-sequence {pe}, {TP_STREAM_TRAIN} "
                f"examples: CSV row {one_c[pe]['row']}, launches "
                f"{one_c[pe]['launches']}")
    runs, seconds_b = shared_launch(4)
    steps, evals = TP_B_TRAIN // 128, TP_B_TRAIN // 5 // 128
    out["tp_dp_zero1"] = check_tp_run(
        "--model_parallel 2 --zero1 relative (data 2 x model 2)",
        runs["tp_dp_zero1"],
        {"attn_fwd": 6 * (steps + evals), "attn_bwd": 6 * steps,
         "adamw": steps, "adamw_table": 0}, 64,
        np.asarray(one_b["step_losses"]), one_b["step_ms"],
        twin_of=[0, 1, 0, 1])
    out["tp_dp_zero1"].update(launch_seconds=seconds_b, one_rank=dict(
        row=one_b["row"], launches=one_b["launches"]))
    depth, steps = LONGSEQ["depth"], TP_STREAM_TRAIN // 4
    for pe in stream_argv:
        expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": steps,
                    "adamw_table": 0, "attn_stream_fwd": depth * (steps + 1)}
        if pe == "rope-mixed":  # separate passes, the freqs' gradient
            expected.update({name: depth * steps for name in STREAM_PASSES})
            bwd = "attn_stream_bwd"
        else:  # the one-pass backward with the table's gradient
            expected["attn_stream_bwd_fused"] = depth * steps
            bwd = "attn_stream_bwd_fused"
        one = one_c[pe]
        out[f"tp_stream_{pe}"] = check_tp_run(
            f"long-sequence {pe} --model_parallel 2 --zero1 (data 2 x "
            f"model 2)", runs[f"tp_stream_{pe}"], with_prologues(expected),
            2, np.asarray(one["step_losses"]),
            1000.0 * 4 / one["images_per_s"], twin_of=[0, 1, 0, 1],
            heads={"attn_stream_fwd": [2, 4], bwd: [2]}, step_batch=4)
        out[f"tp_stream_{pe}"].update(launch_seconds=seconds_b, one_rank=dict(
            row=one["row"], launches=one["launches"]))
    return out


# Phase 22: context parallelism.
# The kernel ring against the one-device kernels (the chunk entries at
# offsets (0, 0) over every key: the whole-sequence kernels, bit for bit,
# phase 15) on the same inputs, as a share of each output's largest entry
# (lse absolute). Same rounding points, but p is rounded against a chunk's
# running max instead of the whole row's, and two chunks are merged with
# logaddexp in float32. The polynomial coefficients' gradient sums ds times
# dist^m (up to 126^3) over every pair, terms that nearly cancel: 4.68e-3
# of its largest entry was seen on an H100 (out 9.5e-4, lse 1.9e-6, dq /
# dk / dv 3.5e-3), so it takes the gradients' limit.
CP_RING_TOL = {"out": 4e-3, "lse": 1e-4, "grad": 1.6e-2, "param": 1.6e-2}
# The kernel ring (bf16 products) against the plain ring (float32), as for
# the kernels against the unfused float32 oracle (LOGITS_TOL, AUTOGRAD_TOL).
CP_PLAIN_TOL = {"out": LOGITS_TOL, "lse": 1e-2, "grad": AUTOGRAD_TOL,
                "param": AUTOGRAD_TOL}
# Two gloo ranks (the kernel ring over the token shards) against one rank
# (the whole-sequence kernels) on the same data: each of the epoch's step
# losses, relative (bf16 products on both sides, merged over other tiles;
# the gradients summed over the ring in another order). An H100 showed
# 2.7e-5 at most over the six steps (relative), 4.9e-7 (rope-mixed) and
# 7.4e-7 (--q_chunk); the losses move by 1e-1 from step to step, so a wrong
# ring backward shows from the second step on.
CP_STEP_TOL = 1e-4
CP_TRAIN = 24            # examples of the CP runs: 6 steps of 4, 1 eval row
CP_WORKER_TIMEOUT = 300  # seconds for one launch of the CP runs

# One rank of phase 22a, in a process of its own under torchrun's
# environment (set by the caller): the ring cases of the JSON payload, each
# through the kernel ring (context_parallel.ring_flash_attention, its
# forward and backward under autograd), the one-device kernels (the chunk
# entries at offsets (0, 0) over every key, on the whole padded sequence)
# and the plain ring (context_parallel.ring_attention, float32, autograd);
# writes {out}/ring_rank{RANK}.json with each case's errors (over the
# rank's valid rows), finiteness, launches and times.
CP_RING = r"""
import json, os, sys, time
import torch
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.parallel import context_parallel as cp
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh

out, cases = sys.argv[1], json.loads(sys.argv[2])
distributed.initialize("gloo")
rank, world = distributed.rank(), distributed.world_size()
ring = make_mesh(seq_parallel=world).seq_ring
device = distributed.device()
B, H, D = 4, 4, 32
scale = D ** -0.5
record = {}

def share(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))

def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, 1000.0 * (time.perf_counter() - t0)

def counts():
    return {"attn_stream_chunk_fwd": fa.LAUNCHES_STREAM_CHUNK_FWD,
            "attn_stream_bwd_fused": fa.LAUNCHES_STREAM_FUSED,
            "attn_stream_fwd": fa.LAUNCHES_STREAM_FWD}

for case in cases:
    n, nl, n_valid, kind = case["n"], case["nl"], case["n_valid"], case["bias"]
    gen = torch.Generator().manual_seed(case["seed"])
    q, k, v, g = (torch.randn(B, H, n, D, generator=gen) for _ in range(4))
    arg, grid = None, case["grid"]
    if kind == "rel":
        arg = torch.randn(H, 2 * n - 1, generator=gen)
    elif kind == "poly":  # term m of size ~1 at distance ~ grid
        arg = torch.randn(H, 4, generator=gen) / torch.tensor(
            [float(grid) ** m for m in range(4)])
    elif kind == "rope-mixed":  # per-head tables, q and k rotated before
        angles = 3.0 * torch.randn(H, n - 1, D // 2, generator=gen)
        cos, sin = fa._prep_freqs((angles.cos(), angles.sin()), H, n,
                                  torch.float32)
        q, k = fa._rotate(q, cos[None], sin[None]), fa._rotate(
            k, cos[None], sin[None])
    g[:, :, n_valid:] = 0.0  # as in training: nothing reads padded rows
    pad = lambda t: fa._pad_seq(t, nl * world, 2).to(device)
    q, k, v, g = map(pad, (q, k, v, g))
    arg = None if arg is None else arg.to(device)
    bias_kind = kind if kind in ("rel", "poly") else None
    kw = cp._generated(bias_kind, arg, grid)
    rows = slice(rank * nl, (rank + 1) * nl)
    valid = (rank * nl + torch.arange(nl, device=device)) < n_valid
    mine = lambda t: t[:, :, rows]
    leaves = lambda: [mine(t).clone().requires_grad_() for t in (q, k, v)] \
        + ([arg.clone().requires_grad_()] if arg is not None else [])

    # the kernel ring, under autograd: a first pass (its launches counted),
    # then a second, timed, that must give the same bits
    def kernel_ring():
        lv = leaves()
        o, fwd_ms = timed(lambda: cp.ring_flash_attention(
            lv[0], lv[1], lv[2], scale, ring, n_valid, bias_kind,
            lv[3] if arg is not None else None, grid))
        grads, bwd_ms = timed(lambda: torch.autograd.grad(o, lv, mine(g)))
        return o.detach(), grads, fwd_ms, bwd_ms

    for name in ("LAUNCHES_STREAM_CHUNK_FWD", "LAUNCHES_STREAM_FWD",
                 "LAUNCHES_STREAM_FUSED"):
        setattr(fa, name, 0)
    o, grads, first_fwd_ms, first_bwd_ms = kernel_ring()
    launches = counts()
    o2, grads2, fwd_ms, bwd_ms = kernel_ring()
    relaunch = bool(torch.equal(o2, o)) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    with torch.no_grad():
        _, lse = cp.ring_flash_fwd(mine(q), mine(k), mine(v), scale, ring,
                                   n_valid, kw, torch.bfloat16)
    dparam = None
    if arg is not None:
        dparam = distributed.all_reduce_sum(grads[3].clone())

    # the one-device kernels on the whole padded sequence
    (ref_o, ref_lse), ref_fwd_ms = timed(lambda: fa.streaming_chunk_fwd(
        q, k, v, scale, 0, 0, n_valid, **kw))
    delta = (g.float() * ref_o.float()).sum(-1)
    ref, ref_bwd_ms = timed(lambda: fa.streaming_chunk_bwd(
        q, k, v, g, ref_lse, delta, scale, 0, 0, n_valid, **kw))

    # the plain ring, float32, under autograd
    lp = leaves()
    po = cp.ring_attention(lp[0], lp[1], lp[2], scale, ring, n_valid=n_valid,
                           bias_kind=bias_kind,
                           bias_arg=lp[3] if arg is not None else None,
                           bias_grid=grid)
    pgrads = torch.autograd.grad(po, lp, mine(g))
    plse = None
    pdparam = None if arg is None else distributed.all_reduce_sum(
        pgrads[3].clone())

    def errs(want_o, want_lse, want, want_dparam):
        e = {"dk": share(grads[1], want[1]), "dv": share(grads[2], want[2])}
        if valid.any():  # a shard of padding only has no row to compare
            e["out"] = share(o[:, :, valid], want_o[:, :, valid])
            e["dq"] = share(grads[0][:, :, valid], want[0][:, :, valid])
            if want_lse is not None:
                e["lse"] = float((lse - want_lse)[:, :, valid].abs().max())
        if want_dparam is not None:
            e["param"] = share(dparam, want_dparam)
        return e

    finite = all(bool(torch.isfinite(t).all()) for t in
                 [o, lse, *grads[:3]] + ([dparam] if dparam is not None
                                         else []))
    record[case["name"]] = dict(
        vs_kernels=errs(mine(ref_o), mine(ref_lse),
                        [mine(ref[0]), mine(ref[1]), mine(ref[2])], ref[3]),
        vs_plain=errs(po.detach(), None, pgrads, pdparam),
        finite=finite, relaunch_bit_equal=relaunch, launches=launches,
        ring_fwd_ms=fwd_ms, ring_bwd_ms=bwd_ms, first_fwd_ms=first_fwd_ms,
        first_bwd_ms=first_bwd_ms, one_device_fwd_ms=ref_fwd_ms,
        one_device_bwd_ms=ref_bwd_ms)
    del o, o2, lse, grads, grads2, ref, po, pgrads, lp
    torch.cuda.empty_cache()
with open(os.path.join(out, f"ring_rank{rank}.json"), "w") as f:
    json.dump(record, f)
distributed.finalize()
"""

# Phase 22a's probe: whether gloo's send / recv take CUDA tensors (the
# ring hop stages CUDA tensors through the host under gloo either way).
GLOO_P2P = r"""
import datetime, torch, torch.distributed as dist
dist.init_process_group("gloo", init_method="env://",
                        timeout=datetime.timedelta(seconds=20))
rank = dist.get_rank()
torch.cuda.set_device(0)
want = torch.arange(1024, dtype=torch.float32)
x = want.cuda() if rank == 0 else torch.zeros(1024, device="cuda")
try:
    if rank == 0:
        dist.send(x, 1)
    else:
        dist.recv(x, 0)
    torch.cuda.synchronize()
    ok = rank == 0 or bool(torch.equal(x.cpu(), want))
    print("RESULT", "delivered" if ok else "wrong values", flush=True)
except Exception as e:
    print("RESULT raised", type(e).__name__,
          (str(e).splitlines() or [""])[0][:160], flush=True)
"""


def probe_gloo_p2p():
    """Whether gloo's send and recv move CUDA tensors between two ranks
    sharing the card: "delivered", "wrong values", "raised ...", or the
    return codes of ranks that crashed or hung."""
    results = rank_processes(GLOO_P2P, [], 2, 60)
    lines = [next((line[7:] for line in text.splitlines()
                   if line.startswith("RESULT ")), None)
             for _, text in results]
    if lines[1] == "delivered" and all(rc == 0 for rc, _ in results):
        return "delivered"
    return "; ".join(f"rank {r}: {line or 'no result'} (return code {rc})"
                     for r, ((rc, _), line) in enumerate(zip(results, lines)))


def check_ring(tmp):
    """Phase 22a: the kernel ring at R = 2 on two gloo ranks sharing the
    card (B 4, H 4, N 4,097, D 32) in none, relative, polynomial and
    rope-mixed (q and k rotated before the ring), and a case whose second
    shard holds padding only (N 4,096, 1,948 valid: every row's hop over it
    is a key chunk masked whole): out, lse, dq, dk, dv and the bias
    parameters' gradient against the one-device kernels within
    CP_RING_TOL and against the plain float32 ring within CP_PLAIN_TOL,
    every value finite, a second pass (forward and backward, timed)
    bit-equal to the first, two chunk forwards and two one-pass backwards a
    rank and call."""
    cases = [dict(name=kind, bias=kind, n=4097, nl=2049, n_valid=4097,
                  grid=64, seed=22 + i)
             for i, kind in enumerate(("none", "rel", "poly", "rope-mixed"))]
    cases.append(dict(name="masked_hop", bias="rel", n=4096, nl=2048,
                      n_valid=1948, grid=64, seed=30))
    t0 = time.perf_counter()
    results = rank_processes(CP_RING, [tmp, json.dumps(cases)], 2,
                             CP_WORKER_TIMEOUT)
    seconds = time.perf_counter() - t0
    for r, (rc, text) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"ring rank {r} failed ({rc}):\n"
                                 f"{text[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"ring_rank{r}.json")) as f:
            ranks.append(json.load(f))
    out = {}
    for case in cases:
        name = case["name"]
        recs = [rk[name] for rk in ranks]
        worst = {side: {key: max(rec[side].get(key, 0.0) for rec in recs)
                        for key in recs[0][side]}
                 for side in ("vs_kernels", "vs_plain")}
        out[name] = dict(worst, ranks=recs)
        short = {side: json.dumps({k: float(f"{v:.3g}")
                                   for k, v in errs.items()})
                 for side, errs in worst.items()}
        log(f"  ring R=2 {name:10s} vs one-device kernels "
            f"{short['vs_kernels']}; vs plain ring {short['vs_plain']}"
            f"; finite {[rec['finite'] for rec in recs]}, relaunch "
            f"bit-equal {[rec['relaunch_bit_equal'] for rec in recs]}, "
            f"launches {recs[0]['launches']}, ring fwd "
            f"{[round(rec['ring_fwd_ms'], 2) for rec in recs]} ms, bwd "
            f"{[round(rec['ring_bwd_ms'], 2) for rec in recs]} ms (one "
            f"device {recs[0]['one_device_fwd_ms']:.2f} / "
            f"{recs[0]['one_device_bwd_ms']:.2f} ms)")
        for rec in recs:
            if not (rec["finite"] and rec["relaunch_bit_equal"]):
                raise AssertionError(f"ring {name}: finite {rec['finite']}, "
                                     f"relaunch {rec['relaunch_bit_equal']}")
            if rec["launches"] != {"attn_stream_chunk_fwd": 2,
                                   "attn_stream_bwd_fused": 2,
                                   "attn_stream_fwd": 0}:
                raise AssertionError(f"ring {name}: launches "
                                     f"{rec['launches']}")
        for side, tol in (("vs_kernels", CP_RING_TOL),
                          ("vs_plain", CP_PLAIN_TOL)):
            for key, err in worst[side].items():
                limit = tol[key if key in tol else "grad"]
                if not err <= limit:
                    raise AssertionError(f"ring {name} {side} {key}: {err} "
                                         f"(tol {limit})")
    out["seconds"] = seconds
    return out


def check_cp_run(label, run, expected, one, world=2):
    """Phase 22b-d's checks of one gloo launch of the train CLI under
    --sequence_parallel 2: every rank's params bit-equal (replicated), the
    launches exact, rank 0 alone writing a CSV, each step's loss within
    CP_STEP_TOL of the one-rank run's, a finite row; each rank's step time
    beside the one rank's."""
    ranks = run["ranks"]
    p0 = ranks[0]["params"]
    same = all(np.array_equal(r["params"][k], p0[k]) for r in ranks
               for k in p0)
    want = np.asarray(one["step_losses"])
    got = np.asarray(ranks[0]["step_losses"])
    step_rel = (np.abs(got - want) / np.abs(want) if got.shape == want.shape
                else np.full(max(len(want), 1), np.inf))
    step_ms = [1000.0 * 4 / r["history"][0]["images_per_sec"] for r in ranks]
    one_ms = 1000.0 * 4 / one["images_per_s"]
    fields = csv_fields(run["row"])
    log(f"  {label}: CSV row {run['row']} (one rank {one['row']}); params "
        f"bit-equal on both ranks {same}; step losses "
        f"{[round(float(x), 6) for x in got]} against one rank's "
        f"{[round(float(x), 6) for x in want]} (relative "
        f"{[float(f'{x:.3g}') for x in step_rel]}, tol {CP_STEP_TOL}); "
        f"CSVs {run['csvs']}")
    for r, rec in enumerate(ranks):
        log(f"    rank {r}: launches {rec['launches']} (expected {expected}),"
            f" {step_ms[r]:.3f} ms a step (one rank: {one_ms:.3f}), "
            f"{rec['seconds']:.1f} s, devices {rec['num_devices']}")
        if rec["launches"] != expected:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{rec['launches']}, expected {expected}")
        if rec["num_devices"] != world or (r and rec["log_file"]):
            raise AssertionError(f"{label} rank {r}: {rec['num_devices']} "
                                 f"devices, log file {rec['log_file']}")
    if len(run["csvs"]) != 1 or not same:
        raise AssertionError(f"{label}: CSVs {run['csvs']}, params bit-equal "
                             f"{same}")
    if not all(math.isfinite(v) for v in fields.values()):
        raise AssertionError(f"{label}: the CSV row is not finite")
    if not step_rel.max() <= CP_STEP_TOL:
        raise AssertionError(f"{label}: step losses {step_rel.tolist()} "
                             f"from one rank's (relative)")
    return dict(row=run["row"], step_loss_relative=step_rel.tolist(),
                launches=[r["launches"] for r in ranks], step_ms=step_ms,
                one_rank_step_ms=one_ms, one_rank_row=one["row"],
                step_losses=ranks[0]["step_losses"],
                one_rank_step_losses=one["step_losses"],
                seconds=[r["seconds"] for r in ranks])


def check_force_ring(modules, vit, datasets, ViTConfig, device):
    """Phase 22e: the bounded step of the long-sequence model (relative,
    N = 4,097, batch 4, --q_chunk 2048) on a process group of one rank over
    NCCL with force_ring (the ring of one rank: a hop that is no call, the
    logaddexp merge, the all_reduce of one) against the plain bounded step,
    one step each from the same params and batch: metrics, params and the
    AdamW moments bit for bit."""
    from vit_rpe_rope_tpu_torch.parallel import distributed
    from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh

    fa, fused_adamw, ts, make_bounded_step, TrainConfig = modules
    cfg = ViTConfig(**LONGSEQ, pos_encoding="relative")
    tcfg = TrainConfig(dataset="cifar10", batch_size=4, q_chunk=2048)
    mean, std = datasets.NORMALIZATION["cifar10"]
    pre = ts.make_preprocess(cfg, mean, std, 32)
    data = datasets.synthetic("cifar10", n_train=4, n_test=4, seed=22)
    images = torch.from_numpy(data.train_x).to(device)
    labels = torch.from_numpy(data.train_y).to(device)
    init = vit.init_params(torch.Generator().manual_seed(22), cfg,
                           device=device)
    out = {}
    with torchrun_env(1):
        distributed.initialize()
        try:
            mesh = make_mesh()
            for label, kw in (("plain", {}),
                              ("force_ring", dict(mesh=mesh,
                                                  force_ring=True))):
                params = {k: v.clone().requires_grad_()
                          for k, v in init.items()}
                opt_init, update = ts.make_optimizer(tcfg, 1, params)
                step = make_bounded_step(cfg, tcfg, update, pre,
                                         q_chunk=2048, **kw)
                state = opt_init(params)
                reset_counts(fa, fused_adamw)
                params, state, metrics = step(params, state, 0, images,
                                              labels)
                out[label] = dict(
                    launches=read_counts(fa, fused_adamw),
                    metrics=metrics.cpu().numpy(),
                    params={k: v.detach().cpu().numpy()
                            for k, v in params.items()},
                    mu=[m.cpu().numpy() for m in state[0].values()])
            backend = torch.distributed.get_backend()
        finally:
            distributed.finalize()
    a, b = out["force_ring"], out["plain"]
    same = (np.array_equal(a["metrics"], b["metrics"])
            and all(np.array_equal(a["params"][k], b["params"][k])
                    for k in b["params"])
            and all(np.array_equal(x, y) for x, y in zip(a["mu"], b["mu"])))
    log(f"  force_ring on one rank ({backend}) vs the plain bounded step, "
        f"relative N=4097: metrics {a['metrics'].tolist()} / "
        f"{b['metrics'].tolist()}, params and moments bit-equal {same}; "
        f"launches {a['launches']} / {b['launches']}")
    if not same or a["launches"] != b["launches"] or backend != "nccl":
        raise AssertionError(f"force_ring differs from the plain step "
                             f"({backend}): bit-equal {same}, launches "
                             f"{a['launches']} / {b['launches']}")
    return dict(bit_equal=same, backend=backend, launches=a["launches"],
                metrics=a["metrics"].tolist())


def check_context_parallel(train_modules, modules, vit, datasets, ViTConfig,
                           device):
    """Phase 22. (a) The kernel ring against the one-device kernels and the
    plain ring (check_ring), and whether gloo moves CUDA tensors. (b) The
    long-sequence model (LONGSEQ at depth 1, N = 4,097, batch 4) through the
    train CLI on two gloo ranks sharing the card with --sequence_parallel
    2, in rope-mixed and relative, on CP_TRAIN examples; (c) rope-mixed
    with --zero1, bit-equal to (b)'s; (d) rope-axial with --q_chunk 2048
    (the bounded driver's ring: two q-chunks of 2,048 and 512 rows a rank)
    -- all four runs of shared_launch(2), each held to a one-rank epoch of
    the same data in this process; (e) force_ring at world size 1 over
    NCCL (check_force_ring)."""
    fa = train_modules[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        out["gloo_p2p_cuda"] = probe_gloo_p2p()
        log(f"  gloo send / recv of a CUDA tensor between two ranks on the "
            f"card: {out['gloo_p2p_cuda']}")
        out["ring"] = check_ring(tmp)
    one = {}
    with small_dataset(datasets, n_train=CP_TRAIN, n_test=CP_TRAIN // 5):
        for label, args in cp_argv().items():
            one[label] = cli_epoch(train_modules, args)
            log(f"  one rank, {label[3:]}, {CP_TRAIN} examples: CSV row "
                f"{one[label]['row']}, launches {one[label]['launches']}")
    runs, seconds = shared_launch(2)  # (b)-(d): runs of phase 20's launch
    steps, evals = CP_TRAIN // 4, -(-(CP_TRAIN // 5) // 4)
    ring = {"attn_fwd": 0, "attn_bwd": 0, "adamw": steps, "adamw_table": 0,
            "attn_stream_chunk_fwd": 2 * (steps + evals),
            "attn_stream_bwd_fused": 2 * steps}
    bounded = dict(ring, attn_stream_chunk_fwd=2 * 2 * (steps + evals),
                   attn_stream_bwd_fused=2 * 2 * steps)
    for label, expected in (("cp_rope-mixed", ring), ("cp_relative", ring),
                            ("cp_q_chunk", bounded)):
        out[label] = check_cp_run(f"long-sequence {label[3:]} "
                                  f"--sequence_parallel 2", runs[label],
                                  with_prologues(expected), one[label])
    z, plain = runs["cp_zero1"], runs["cp_rope-mixed"]
    zero1_same = z["row"] == plain["row"] and all(
        np.array_equal(z["ranks"][r]["params"][k],
                       plain["ranks"][r]["params"][k])
        for r in range(2) for k in plain["ranks"][r]["params"])
    log(f"  --sequence_parallel 2 --zero1: CSV row {z['row']}; params and "
        f"row bit-equal to plain CP {zero1_same}; launches "
        f"{[r['launches'] for r in z['ranks']]}")
    if not zero1_same or any(r["launches"] != with_prologues(ring)
                             for r in z["ranks"]):
        raise AssertionError("ZeRO-1 x CP differs from plain CP")
    out["cp_zero1"] = dict(bit_equal=zero1_same, row=z["row"],
                           launches=[r["launches"] for r in z["ranks"]])
    out["launch_seconds"] = seconds
    torch.cuda.empty_cache()
    out["force_ring"] = check_force_ring(modules, vit, datasets, ViTConfig,
                                         device)
    return out


# Phase 23: pipeline parallelism (GPipe stages over gloo ranks, PP x TP).
PP_TRAIN = 1280          # runs (a) and (b): 10 steps of 128, and 256 test
#   images (2 evaluation rows of 128 on the gathered params)
PP_STREAM_TRAIN = 20     # run (c): 5 steps of 4 at N = 4,097, and 4 test
#   images (one evaluation row)
PP_MICRO = 4             # run (a)'s --pp_microbatches (b, c: the auto 2)


def pp_launches(blocks_a_stage, micro, steps, depth, evals, stream=False):
    """A rank's launches of one epoch under the GPipe schedule: each step
    runs the stage's blocks once per microbatch forward and backward (the
    bubble ticks launch nothing), AdamW once; each evaluation row runs
    every block on the gathered params."""
    fwd, bwd = blocks_a_stage * micro * steps, blocks_a_stage * micro * steps
    if stream:  # the long-sequence model in relative: rows 3 and 5
        return with_prologues({"attn_fwd": 0, "attn_bwd": 0, "adamw": steps,
                               "adamw_table": 0,
                               "attn_stream_fwd": fwd + depth * evals,
                               "attn_stream_bwd_fused": bwd})
    return {"attn_fwd": fwd + depth * evals, "attn_bwd": bwd,
            "adamw": steps, "adamw_table": 0}


def check_pp_run(label, run, expected, one, blocks_a_stage, heads, batches,
                 step_batch=128):
    """Phase 23's checks of one gloo launch of the train CLI under
    --pipeline_parallel: each rank's launches exact, the attention
    wrappers at `heads` and `batches` ({wrapper: sorted sizes}: the
    microbatch in training, the whole rank's batch in evaluation), each
    rank holding blocks_a_stage blocks (its stage's) and block shards of
    its own, the replicated params bit-equal on every rank, rank 0 alone
    writing a CSV, the first DP_EARLY_STEPS step losses within DP_STEP_TOL
    of one rank's on the same data (`one`: cli_epoch's record), the row
    finite; each rank's step time (of step_batch examples) beside the one
    rank's."""
    ranks = run["ranks"]
    p0 = ranks[0]["params"]
    replicated = [k for k in p0 if not k.startswith("blocks.")]
    replicated_same = all(np.array_equal(r["params"][k], p0[k])
                          for r in ranks for k in replicated)
    stage_blocks = {r["params"]["blocks.norm1.weight"].shape[0]
                    for r in ranks}
    fc1 = [r["params"]["blocks.mlp.fc1.weight"] for r in ranks]
    shards_distinct = all(not np.array_equal(fc1[i], fc1[j])
                          for i in range(len(fc1)) for j in range(i))
    one_losses = np.asarray(one["step_losses"])
    step_rel = (np.abs(np.asarray(ranks[0]["step_losses"]) - one_losses)
                / np.abs(one_losses))
    fields = csv_fields(run["row"])
    step_ms = [1000.0 * step_batch / r["history"][0]["images_per_sec"]
               for r in ranks]
    one_ms = 1000.0 * step_batch / one["images_per_s"]
    steady = [steady_ms(r) for r in ranks]
    early = [float(f"{x:.3g}") for x in step_rel[:DP_EARLY_STEPS]]
    log(f"  {label}: CSV row {run['row']} (one rank: {one['row']}); CSVs "
        f"written {run['csvs']}; blocks a rank {sorted(stage_blocks)}; "
        f"block shards distinct on all {len(ranks)} ranks "
        f"{shards_distinct}; replicated params bit-equal on all ranks "
        f"{replicated_same} ({len(replicated)} of {len(p0)} keys); first "
        f"{DP_EARLY_STEPS} step losses against one rank, relative: {early}")
    for r, rec in enumerate(ranks):
        log(f"    rank {r}: launches {rec['launches']} (expected "
            f"{expected}), attention batch sizes {rec['batches']}, heads "
            f"{rec['heads']}, {step_ms[r]:.3f} ms a step (one rank in this "
            f"run: {one_ms:.3f}; steps after the first {steady[r]:.3f}, one "
            f"rank {steady_ms(one):.3f}), {rec['seconds']:.1f} s, devices "
            f"{rec['num_devices']}")
        if rec["launches"] != expected:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{rec['launches']}, expected {expected}")
        if rec["heads"] != heads or rec["batches"] != batches:
            raise AssertionError(f"{label} rank {r}: attention at heads "
                                 f"{rec['heads']}, batches {rec['batches']}")
        if rec["num_devices"] != len(ranks) or (r and rec["log_file"]):
            raise AssertionError(f"{label} rank {r}: {rec['num_devices']} "
                                 f"devices, log file {rec['log_file']}")
    if len(run["csvs"]) != 1:
        raise AssertionError(f"{label}: CSVs {run['csvs']}")
    if stage_blocks != {blocks_a_stage} or not shards_distinct \
            or not replicated_same:
        raise AssertionError(f"{label}: the ranks' params are not as the "
                             f"stages say")
    if not all(math.isfinite(fields[k]) for k in fields):
        raise AssertionError(f"{label}: the CSV row is not finite")
    if step_rel[:DP_EARLY_STEPS].max() > DP_STEP_TOL:
        raise AssertionError(f"{label}: the first step losses differ from "
                             f"one rank's: {step_rel[:DP_EARLY_STEPS]}")
    return dict(row=run["row"], one_rank_row=one["row"],
                step_relative=step_rel.tolist(),
                launches=[r["launches"] for r in ranks], step_ms=step_ms,
                one_rank_step_ms=one_ms, steady_step_ms=steady,
                one_rank_steady_step_ms=steady_ms(one),
                seconds=[r["seconds"] for r in ranks])


def check_pp_resume(train_modules, datasets, vit, ViTConfig, last, one):
    """Phase 23a's `_last.npz` (rank 0's, written under --pipeline_parallel
    2) in the reference layout: every param at the one-device shape, the
    moments as the canonical flat vectors; resumed at world size 1 in this
    process for a second epoch of the same data."""
    from vit_rpe_rope_tpu_torch.train import loop

    cfg = ViTConfig(img_size=32, patch_size=4, in_chans=3, num_classes=10,
                    embed_dim=192, depth=6, num_heads=6,
                    pos_encoding="rope-mixed")
    ref = vit.init_params(torch.Generator(), cfg, device="cpu")
    total = loop.moment_flattener(ref, cfg).total
    with np.load(last) as z:
        shapes_ok = (all(z[k].shape == tuple(v.shape)
                         for k, v in ref.items())
                     and z["__opt.1"].shape == z["__opt.2"].shape
                     == (total,))
        count = int(z["__opt.0"])
    with small_dataset(datasets, n_train=PP_TRAIN, n_test=PP_TRAIN // 5):
        resumed = cli_epoch(train_modules, ["--epochs", "2", "--resume"],
                            resume_from=last)
    fields = csv_fields(resumed["row"])
    log(f"  --pipeline_parallel 2 _last.npz: reference shapes {shapes_ok}, "
        f"AdamW count {count}; resumed at world size 1: CSV row "
        f"{resumed['row']} (the first epoch's one-rank row {one['row']}), "
        f"launches {resumed['launches']}")
    if not shapes_ok or count != PP_TRAIN // 128 or fields["epoch"] != 2 \
            or not all(math.isfinite(v) for v in fields.values()):
        raise AssertionError(f"the pipeline-parallel _last.npz does not "
                             f"resume at world size 1: {resumed['row']}")
    return dict(reference_shapes=shapes_ok, count=count,
                resumed_row=resumed["row"], launches=resumed["launches"])


def check_pipeline_parallel(train_modules, datasets, vit, ViTConfig):
    """Phase 23. (a) The ViT-tiny/4 train CLI at its defaults (rope-mixed,
    embed 192, depth 6, 6 heads, batch 128) on two gloo ranks sharing the
    card with --pipeline_parallel 2 --pp_microbatches PP_MICRO, on
    PP_TRAIN examples: 3 blocks a stage, rows 1 and 2 at the microbatch of
    32 in training and at 128 in evaluation on the gathered params, row 11
    once a step; its `_last.npz` in the reference layout resumed at world
    size 1. (c) The long-sequence model (N = 4,097, batch 4) at depth 2 in
    relative with --pipeline_parallel 2 (one block a stage, 2
    microbatches) in the same launch, on PP_STREAM_TRAIN examples: rows 3
    and 5 (the generated bias) and their prologues. (b) The relative
    epoch of (a)'s data on four gloo ranks with --pipeline_parallel 2
    --model_parallel 2 (3 heads a rank, the bias sliced; 2 microbatches of
    64), a run of shared_launch(4). (a) and (c) are runs of
    shared_launch(2). Each held to a one-rank epoch of the same data in
    this process."""
    stream_argv = longseq_argv(2, "relative")
    one = {}
    with small_dataset(datasets, n_train=PP_TRAIN, n_test=PP_TRAIN // 5):
        for label, argv in (("pp", []),
                            ("pp_tp", ["--pos_encoding", "relative"])):
            one[label] = cli_epoch(train_modules, argv)
    with small_dataset(datasets, n_train=PP_STREAM_TRAIN,
                       n_test=PP_STREAM_TRAIN // 5):
        one["pp_stream"] = cli_epoch(train_modules, stream_argv)
    for label, rec in one.items():
        log(f"  one rank, {label}: CSV row {rec['row']}, launches "
            f"{rec['launches']}, {rec['step_ms']:.3f} ms a step")
    out = {}
    runs, seconds_a = shared_launch(2)  # (a), (c): runs of phase 20's launch
    steps, evals = PP_TRAIN // 128, PP_TRAIN // 5 // 128
    out["pp"] = check_pp_run(
        f"--pipeline_parallel 2 --pp_microbatches {PP_MICRO} (data 1 x "
        f"pipe 2)", runs["pp"],
        pp_launches(3, PP_MICRO, steps, 6, evals), one["pp"], 3,
        {"attn_fwd": [6], "attn_bwd": [6]},
        {"attn_fwd": [128 // PP_MICRO, 128],
         "attn_bwd": [128 // PP_MICRO]})
    out["pp"]["resume"] = check_pp_resume(
        train_modules, datasets, vit, ViTConfig, runs["pp"]["last"],
        one["pp"])
    shutil.rmtree(_SHARED[2][2])  # the two-rank runs' kept `_last.npz`
    out["pp"]["launch_seconds"] = seconds_a
    s_steps = PP_STREAM_TRAIN // 4
    out["pp_stream"] = check_pp_run(
        "long-sequence relative --pipeline_parallel 2 (data 1 x pipe 2)",
        runs["pp_stream"],
        pp_launches(1, 2, s_steps, 2, 1, stream=True), one["pp_stream"], 1,
        {"attn_stream_fwd": [4], "attn_stream_bwd_fused": [4]},
        {"attn_stream_fwd": [2, 4], "attn_stream_bwd_fused": [2]},
        step_batch=4)
    runs, seconds_b = shared_launch(4)  # (b): a run of phase 21's launch
    out["pp_tp"] = check_pp_run(
        "--pipeline_parallel 2 --model_parallel 2 relative (data 1 x pipe 2 "
        "x model 2)", runs["pp_tp"], pp_launches(3, 2, steps, 6, evals),
        one["pp_tp"], 3, {"attn_fwd": [3, 6], "attn_bwd": [3]},
        {"attn_fwd": [64, 128], "attn_bwd": [64]})
    table = "pos_embed.relative_position_bias_table"
    tables = [r["params"][table] for r in runs["pp_tp"]["ranks"]]
    same = all(np.array_equal(t, tables[0]) for t in tables)
    log(f"  --pipeline_parallel 2 --model_parallel 2: the relative table "
        f"bit-equal on all four ranks {same}")
    if not same:
        raise AssertionError("the relative table differs across ranks")
    out["pp_tp"].update(launch_seconds=seconds_b, table_bit_equal=same)
    return out


# Phase 24: the compositions with the sequence axis (TP x CP, PP x CP) on
# four gloo ranks sharing the card, and the trajectory-parity harness.
COMP_TRAIN = 24          # runs (a) and (b): 6 steps of 4, one eval row of 4
COMP_TRAJ_STEPS = 20     # (c): the harness's port side, card against CPU
COMP_TRAJ_TOL = 1e-4     # (c): each step's loss, card against CPU, relative
#   (float32 on both, no attention kernel: the unfused attention the
#   harness asks for; cuBLAS and the CPU's BLAS sum in other orders)


def comp_launches(stage_blocks, micro, steps, evals):
    """A rank's launches of one epoch of the long-sequence model under a
    composition with the sequence axis at R = 2: every block of the rank's
    stage runs the ring (two chunk forwards, one a hop) on each
    microbatch of each step and evaluation row (the evaluation runs the
    composed forward), and its backward (two one-pass chunk backwards) on
    each microbatch of each step; AdamW once a step."""
    hops = 2 * stage_blocks * micro
    return with_prologues({"attn_fwd": 0, "attn_bwd": 0, "adamw": steps,
                           "adamw_table": 0,
                           "attn_stream_chunk_fwd": hops * (steps + evals),
                           "attn_stream_bwd_fused": hops * steps})


def check_comp_run(label, run, expected, one, heads, batches, rows,
                   position):
    """Phase 24's checks of one launch of the train CLI on four gloo
    ranks: each rank's launches exact, the chunk kernels at `heads` heads,
    `batches` images and `rows` query rows a call (the rank's share), the
    replicated params bit-equal on every rank and the block shards as the
    grid says (equal on the ranks of one `position(rank)`, distinct
    across positions), rank 0 alone writing a CSV, the first
    DP_EARLY_STEPS step losses within CP_STEP_TOL of one rank's on the same
    data, the row finite; each rank's step time beside one rank's."""
    ranks = run["ranks"]
    p0 = ranks[0]["params"]
    replicated = [k for k in p0 if not k.startswith("blocks.")]
    same = all(np.array_equal(r["params"][k], p0[k]) for r in ranks
               for k in replicated)
    fc1 = next(k for k in p0 if k.endswith("mlp.fc1.weight"))
    shards = all(np.array_equal(ranks[i]["params"][fc1],
                                ranks[j]["params"][fc1])
                 == (position(i) == position(j))
                 for i in range(len(ranks)) for j in range(i))
    want = np.asarray(one["step_losses"])
    got = np.asarray(ranks[0]["step_losses"])
    step_rel = (np.abs(got - want) / np.abs(want) if got.shape == want.shape
                else np.full(max(len(want), 1), np.inf))
    early = step_rel[:DP_EARLY_STEPS]
    step_ms = [1000.0 * 4 / r["history"][0]["images_per_sec"] for r in ranks]
    one_ms = 1000.0 * 4 / one["images_per_s"]
    steady = [steady_ms(r) for r in ranks]
    fields = csv_fields(run["row"])
    log(f"  {label}: CSV row {run['row']} (one rank {one['row']}); "
        f"replicated params bit-equal on all {len(ranks)} ranks {same} "
        f"({len(replicated)} of {len(p0)} keys); block shards equal "
        f"within a position and distinct across {shards}; step losses "
        f"{[round(float(x), 6) for x in got]} against one rank's "
        f"{[round(float(x), 6) for x in want]} (relative "
        f"{[float(f'{x:.3g}') for x in step_rel]}, the first "
        f"{DP_EARLY_STEPS} held to {CP_STEP_TOL}); CSVs {run['csvs']}")
    for r, rec in enumerate(ranks):
        log(f"    rank {r}: launches {rec['launches']} (expected "
            f"{expected}), chunk kernels at heads {rec['heads']}, batches "
            f"{rec['batches']}, rows {rec['rows']}; {step_ms[r]:.3f} ms a "
            f"step (one rank: {one_ms:.3f}; steps after the first "
            f"{steady[r]:.3f}, one rank {steady_ms(one):.3f}), "
            f"{rec['seconds']:.1f} s, devices {rec['num_devices']}")
        if rec["launches"] != expected:
            raise AssertionError(f"{label} rank {r}: launches "
                                 f"{rec['launches']}, expected {expected}")
        chunk = {k: v for k, v in rec["heads"].items() if "chunk" in k}
        if (chunk != heads
                or {k: v for k, v in rec["batches"].items()
                    if "chunk" in k} != batches or rec["rows"] != rows):
            raise AssertionError(f"{label} rank {r}: chunk kernels at heads "
                                 f"{rec['heads']}, batches "
                                 f"{rec['batches']}, rows {rec['rows']}")
        if rec["num_devices"] != len(ranks) or (r and rec["log_file"]):
            raise AssertionError(f"{label} rank {r}: {rec['num_devices']} "
                                 f"devices, log file {rec['log_file']}")
    if len(run["csvs"]) != 1 or not same or not shards:
        raise AssertionError(f"{label}: CSVs {run['csvs']}, replicated "
                             f"params bit-equal {same}, block shards as "
                             f"the grid says {shards}")
    if not all(math.isfinite(v) for v in fields.values()):
        raise AssertionError(f"{label}: the CSV row is not finite")
    if not early.max() <= CP_STEP_TOL:
        raise AssertionError(f"{label}: step losses {step_rel.tolist()} "
                             f"from one rank's (relative)")
    return dict(row=run["row"], one_rank_row=one["row"],
                step_relative=step_rel.tolist(),
                launches=[r["launches"] for r in ranks], step_ms=step_ms,
                one_rank_step_ms=one_ms, steady_step_ms=steady,
                one_rank_steady_step_ms=steady_ms(one),
                step_losses=ranks[0]["step_losses"],
                one_rank_step_losses=one["step_losses"],
                seconds=[r["seconds"] for r in ranks])


def check_trajectory_parity(fa, fused_adamw, vit):
    """Phase 24c: the trajectory-parity harness's port side
    (utils/trajectory_parity.train_port at the JAX module's defaults:
    rope-axial, MNIST at 28 px, batch 64, the unfused attention) for
    COMP_TRAJ_STEPS steps on the card, AdamW's kernel (row 11) once a
    step, against the same steps on the CPU (the kernel's twin)."""
    from vit_rpe_rope_tpu_torch.utils import trajectory_parity as traj

    cfg = traj.trajectory_config()
    bundle, per_epoch = traj.synthetic_task(steps=COMP_TRAJ_STEPS)
    params = {k: v.numpy() for k, v in vit.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu").items()}
    plans = traj.port_plans(per_epoch * 64, 64, 2)
    reset_counts(fa, fused_adamw)
    card, card_s = timed_s(lambda: traj.train_port(  # default: the card
        params, cfg, bundle, plans, COMP_TRAJ_STEPS))
    launches = read_counts(fa, fused_adamw)
    cpu, cpu_s = timed_s(lambda: traj.train_port(
        params, cfg, bundle, plans, COMP_TRAJ_STEPS, device="cpu"))
    result = traj.compare(card["losses"], cpu["losses"], card["acc"],
                          cpu["acc"], cfg.pos_encoding, "mnist", 64)
    rel = np.abs(np.subtract(card["losses"], cpu["losses"])) / np.abs(
        cpu["losses"])
    log(f"  trajectory parity, port side, {COMP_TRAJ_STEPS} steps: card "
        f"losses {[round(x, 6) for x in card['losses']]}, relative to the "
        f"CPU's {[float(f'{x:.3g}') for x in rel]} (tol {COMP_TRAJ_TOL}); "
        f"early max |diff| {result['early_max_absdiff']:.3g}, smoothed max "
        f"rel {result['smoothed_max_reldiff']:.3g}; test accuracy card "
        f"{card['acc']:.2f}% CPU {cpu['acc']:.2f}%; launches {launches}; "
        f"{card_s:.1f} s on the card, {cpu_s:.1f} s on the CPU")
    expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": COMP_TRAJ_STEPS}
    if launches != expected:
        raise AssertionError(f"trajectory parity: launches {launches}, "
                             f"expected {expected}")
    if not rel.max() <= COMP_TRAJ_TOL or len(rel) != COMP_TRAJ_STEPS:
        raise AssertionError(f"trajectory parity: the card's losses differ "
                             f"from the CPU's by {rel.tolist()} (relative)")
    return dict(relative=rel.tolist(), launches=launches,
                card_losses=card["losses"], cpu_losses=cpu["losses"],
                card_acc=card["acc"], cpu_acc=cpu["acc"],
                early_max_absdiff=result["early_max_absdiff"],
                smoothed_max_reldiff=result["smoothed_max_reldiff"],
                card_seconds=card_s, cpu_seconds=cpu_s)


def timed_s(fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def comp_argv(flags=True):
    """Phase 24's train CLI runs by label: the long-sequence model at depth
    1 in rope-mixed and relative with --sequence_parallel 2
    --model_parallel 2, at depth 2 in relative with --pipeline_parallel 2
    --sequence_parallel 2 (without flags: the one-rank epochs)."""
    tpcp = ["--sequence_parallel", "2", "--model_parallel", "2"]
    ppcp = ["--pipeline_parallel", "2", "--sequence_parallel", "2"]
    return {"tpcp_rope-mixed": longseq_argv(1, "rope-mixed")
            + (tpcp if flags else []),
            "tpcp_relative": longseq_argv(1, "relative")
            + (tpcp if flags else []),
            "ppcp_relative": longseq_argv(2, "relative")
            + (ppcp if flags else [])}


def check_compositions(train_modules, datasets, vit):
    """Phase 24. Four gloo ranks sharing the card, in the launch of
    shared_launch(4): (a) the
    long-sequence model (N = 4,097, 4 heads) at depth 1 through the train
    CLI with --sequence_parallel 2 --model_parallel 2 (data 1 x seq 2 x
    model 2: 2 heads and 2,049 query rows a rank) in rope-mixed and in
    relative, and (b) at depth 2 in relative with --pipeline_parallel 2
    --sequence_parallel 2 (data 1 x pipe 2 x seq 2: one block a stage, 2
    microbatches of 2, 4 heads), each on COMP_TRAIN examples and held to a
    one-rank epoch of the same data in this process; (c) the trajectory-
    parity harness's port side on the card against the CPU."""
    fa, fused_adamw = train_modules[0], train_modules[1]
    one = {}
    with small_dataset(datasets, n_train=COMP_TRAIN,
                       n_test=COMP_TRAIN // 5):
        for label, args in comp_argv(flags=False).items():
            one[label] = cli_epoch(train_modules, args)
            log(f"  one rank, {label}, {COMP_TRAIN} examples: CSV row "
                f"{one[label]['row']}, launches {one[label]['launches']}")
    runs, seconds = shared_launch(4)  # (a), (b): runs of phase 21's launch
    labels = ("tpcp_rope-mixed", "tpcp_relative", "ppcp_relative")
    run_seconds = [max(r["seconds"] for r in runs[k]["ranks"])
                   for k in labels]
    log(f"  four gloo ranks, the compositions: {sum(run_seconds):.1f} s of "
        f"the shared launch's {seconds:.1f} ({run_seconds})")
    steps, evals = COMP_TRAIN // 4, -(-(COMP_TRAIN // 5) // 4)
    out = {"launch_seconds": seconds, "run_seconds": run_seconds}
    chunk = ("attn_stream_chunk_fwd", "attn_stream_chunk_bwd")
    for label in ("tpcp_rope-mixed", "tpcp_relative"):
        out[label] = check_comp_run(
            f"long-sequence {label[5:]} --sequence_parallel 2 "
            f"--model_parallel 2 (data 1 x seq 2 x model 2)", runs[label],
            comp_launches(1, 1, steps, evals), one[label],
            dict.fromkeys(chunk, [2]), dict.fromkeys(chunk, [4]),
            dict.fromkeys(chunk, [2049]), lambda r: r % 2)
    out["ppcp_relative"] = check_comp_run(
        "long-sequence relative --pipeline_parallel 2 --sequence_parallel 2 "
        "(data 1 x pipe 2 x seq 2)", runs["ppcp_relative"],
        comp_launches(1, 2, steps, evals), one["ppcp_relative"],
        dict.fromkeys(chunk, [4]), dict.fromkeys(chunk, [2]),
        dict.fromkeys(chunk, [2049]), lambda r: r // 2)
    torch.cuda.empty_cache()
    out["trajectory_parity"] = check_trajectory_parity(fa, fused_adamw, vit)
    return out


def kernel_line(name, source, replaces, launches, max_abs_err, times):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_abs_err, "ms": times["ms"],
            "plain_ms": times["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"], "library_ms": times["library_ms"],
            **{key: times[key] for key in ("group", "group_ms",
                                           "group_library_ms", "per_op_ms",
                                           "routes", "device_ms",
                                           "int8_launches",
                                           "export_launches",
                                           "dp_launches", "tp_launches",
                                           "cp_launches", "pp_launches",
                                           "comp_launches")
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
    from vit_rpe_rope_tpu_torch.ops import block_fused, cuda_build
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
                   fa.STREAM_BWD_SOURCE, fa.STREAM_FUSED_SOURCE,
                   fused_adamw.SOURCE, block_fused.SOURCE)
        spilled = []
        for lib_path in cuda_build.build_all(sources):
            log(f"    built {lib_path.name}")
            report = cuda_build.ptxas_report(
                lib_path.with_suffix(".log").read_text())
            names = demangle([name for name, _, _ in report])
            for name, (_, regs, spill) in zip(names, report):
                log(f"    ptxas: {name}: {regs} registers, {spill} bytes "
                    f"spilled")
                if spill:
                    spilled.append(f"{name} ({spill} bytes)")
        log(f"    instances that spill: {spilled or 'none'}")
        if any("block_fused" in name for name in spilled):
            raise AssertionError("the fused block kernel (row 12) spills")
        fa._library(), fa._bwd_library(), fused_adamw._library()
        fa._stream_library(), fa._stream_bwd_library()
        fa._stream_fused_library(), block_fused._library()

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
            check_resident(fa, "predict CLI ViT-S/16@224")
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
                check_resident(fa, f"predict CLI ViT-tiny/4 {pe_name}")
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

    # Phase 8's best checkpoints, for the visualizers of phase 17.
    keep_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    phase8_rope_mixed = os.path.join(keep_dir, "phase8_rope-mixed.npz")
    with phase("[8] training at full width through the train CLI", seconds):
        train_modules = (fa, fused_adamw, train_cli, serving, datasets)
        training = {pe_name: train_through_cli(
                        pe_name, train_modules,
                        keep=os.path.join(keep_dir, f"phase8_{pe_name}.npz"))
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
        check_dbias_vs_twin(fa, device)

    with phase("[11b] one-pass backward and parameter-gradient kernels vs "
               "twins on the card", seconds):
        fused_err = check_fused_vs_twin(fa, device)

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
                        "attn_stream_bwd_prologue": 5 * cfg.depth,
                        "attn_stream_bwd_dq": 5 * cfg.depth,
                        "attn_stream_bwd_dkv": 5 * cfg.depth}
            if dbias:
                expected["attn_stream_bwd_dbias"] = 5 * cfg.depth
            stream_paths[label] = check_kernel_vs_plain_training(
                vit, ts, fused_adamw, datasets, cfg, device, batch=batch,
                fa=fa, expected=expected)
            torch.cuda.empty_cache()
        # A generated bias above 2048 tokens: the one-pass backward, which
        # also sums the coefficients' / the table's gradient.
        for pe_name in ("polynomial", "relative"):
            cfg = ViTConfig(**LONGSEQ, pos_encoding=pe_name)
            expected = {"attn_fwd": 0, "attn_bwd": 0, "adamw": 5,
                        "attn_stream_fwd": 5 * cfg.depth,
                        "attn_stream_bwd_fused": 5 * cfg.depth}
            stream_paths[f"longseq_{pe_name}"] = (
                check_kernel_vs_plain_training(
                    vit, ts, fused_adamw, datasets, cfg, device, batch=4,
                    fa=fa, expected=expected))
            torch.cuda.empty_cache()
        dparam_launches = check_direct_dparam_path(fa, fused_adamw, device,
                                                   longseq.depth)
        torch.cuda.empty_cache()
        # The same routes through the train CLI (fit, eval, CSV, best
        # checkpoint, the Predictor on it): the long-sequence model with its
        # depth cut from 2 to 1, ViT-S/16@384 with its depth cut from 12 to
        # 1; the two long-sequence epochs held to no learning bar on
        # STREAM_EPOCH_TRAIN examples.
        # Every epoch at the CLI's auto k (32 steps and 32 evaluation rows
        # a CUDA graph); the rope-mixed and relative ones also at
        # --steps_per_dispatch 1 beside them, their CSV rows compared.
        longseq_1 = dict(LONGSEQ, depth=1)
        stream_graphs = {}
        for pe_name, label in (("rope-mixed", "longseq"),
                               ("relative", "longseq_relative")):
            stream_graphs[label] = {
                name: train_through_cli(
                    pe_name, train_modules, model=longseq_1, batch=4,
                    n_train=STREAM_EPOCH_TRAIN, flags=flags)
                for name, flags in (("auto", None),
                                    ("k=1", {"steps_per_dispatch": 1}))}
        stream_training = {
            "longseq": stream_graphs["longseq"]["auto"],
            "longseq_relative": stream_graphs["longseq_relative"]["auto"],
            "longseq_rope_axial": train_through_cli(
                "rope-axial", train_modules, model=longseq_1, batch=4,
                bar=LEARN_BAR["rope-axial"]),
            "vit_s_384": train_through_cli(
                "relative", train_modules, model=dict(VIT_S_384, depth=1),
                batch=16)}
        stream_training["graphs"] = {
            label: compare_epochs(f"streaming graph epochs, {label} at "
                                  f"depth 1", runs)
            for label, runs in stream_graphs.items()}

    with phase("[14] streaming times on the card", seconds):
        stream_times = time_stream_kernels(fa, device)
        fused_times, dparam_times = time_fused_kernels(fa, device)
        stream_steps, stream_traces = {}, {}
        step_cases = [(f"longseq N={n} {pe_name} f32",
                       ViTConfig(**dict(LONGSEQ, img_size=img),
                                 pos_encoding=pe_name), batch, n_steps)
                      for pe_name in ("rope-mixed", "rope-axial",
                                      "polynomial", "relative")
                      for n, img, batch, n_steps in ((4097, 256, 4, 10),
                                                     (16385, 512, 2, 3))]
        step_cases.append(("ViT-S/16@384 relative f32", vit_s_384_rel, 16, 5))
        for label, cfg, batch, n_steps in step_cases:
            run = vit_s_train_step(vit, ts, TrainConfig(dataset="cifar10"),
                                   mean, std, cfg, device, batch=batch)
            stream_steps[label] = time_train_step(
                run, fa, fused_adamw, n_steps=n_steps, batch=batch,
                label=label)
            if cfg.seq_len == 4097 and cfg.pos_encoding != "rope-axial":
                stream_traces[label] = profile_train_step(run)
            del run
            torch.cuda.empty_cache()
        stream_trace = stream_traces["longseq N=4097 rope-mixed f32"]

    with phase("[15] bounded-program stepping: chunk forward kernel, bounded "
               "vs monolithic steps, the train CLI with --q_chunk", seconds):
        from vit_rpe_rope_tpu_torch.train.bounded import make_bounded_step

        chunk_err = check_chunk_vs_twin(fa, device)
        bounded_modules = (fa, fused_adamw, ts, make_bounded_step,
                           TrainConfig)
        bounded_checks = check_bounded_steps(bounded_modules, vit, datasets,
                                             ViTConfig, device)
        # The slice's main path: one epoch of the long-sequence model
        # through the train CLI with --q_chunk 2048 (three q-chunks).
        bounded_training = train_through_cli(
            "rope-axial", train_modules, model=dict(LONGSEQ, depth=1),
            batch=4, bar=LEARN_BAR["rope-axial"], q_chunk=2048,
            lr=BOUNDED_EPOCH_LR)
        chunk_times = time_chunk_kernel(fa, device)
        bounded_steps, bounded_trace = time_bounded_steps(
            bounded_modules, vit, datasets, ViTConfig, device)
        rope_axial_gap = measure_rope_axial_gap(bounded_modules, vit,
                                                datasets, ViTConfig, device)

    with phase("[16] block-level paths: the fused block kernel (row 12), "
               "flash_block training, padded head dims, polynomial degree 8",
               seconds):
        block_err, block_prologue_err = check_block_fused(
            block_fused, vit, ViTConfig, device)
        block_times = time_block_fused(block_fused, fa, vit, ViTConfig,
                                       device)
        flash_block_grads = check_flash_block_grads(vit, ViTConfig, fa,
                                                    fused_adamw, device)
        # The slice's main path through the train CLI: ViT-tiny/4 with one
        # differentiation boundary per block, and at head dim 48 (4 heads:
        # the kernels run on zero-padded 64-wide heads); between them the
        # per-call boundary again, so that the epochs compare in one phase.
        block_training = {
            "flash_block": train_through_cli(
                "rope-mixed", train_modules,
                flags={"attention_impl": "flash_block"}),
            "flash": train_through_cli("rope-mixed", train_modules),
            "head_dim_48": train_through_cli("rope-mixed", train_modules,
                                             flags={"num_heads": 4})}
        poly8 = ViTConfig(**LONGSEQ, pos_encoding="polynomial",
                          poly_degree=8)
        poly8_paths = check_kernel_vs_plain_training(
            vit, ts, fused_adamw, datasets, poly8, device, batch=4, fa=fa,
            expected={"attn_fwd": 0, "attn_bwd": 0, "adamw": 5,
                      "attn_stream_fwd": 5 * poly8.depth,
                      "attn_stream_bwd_fused": 5 * poly8.depth})
        torch.cuda.empty_cache()
        repaired = check_repaired_shapes(fa, device)

    with phase("[17] regularised training through the train CLI, the "
               "visualizer CLIs on trained checkpoints", seconds):
        from vit_rpe_rope_tpu_torch.cli import pe_similarity_visualizer
        from vit_rpe_rope_tpu_torch.cli import rope_visualizer

        t0 = time.perf_counter()
        regularised = check_regularised_training(
            train_modules, training["rope-mixed"], block_training["flash"],
            keep_dir)
        regularised_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        visualizers = check_visualizers(
            (fa, fused_adamw, serving, checkpoint, vit, ViTConfig,
             pe_similarity_visualizer, rope_visualizer), keep_dir, device,
            datasets.synthetic("cifar10", seed=0).test_x[:128])
        visualizers["seconds"] = time.perf_counter() - t0
        log(f"  path B (four regularised epochs) {regularised_seconds:.1f} s,"
            f" path A (visualizers) {visualizers['seconds']:.1f} s")

    with phase("[18] the k-step driver on a CUDA graph, remat, --debug_nans, "
               "--profile_dir, the C++ decoders", seconds):
        from vit_rpe_rope_tpu_torch.utils import native, nan_check

        graph_epochs = check_graph_epochs(
            train_modules, training["rope-mixed"], regularised["seed 0"],
            phase8_rope_mixed, device)
        adamw_table_err, adamw_table = check_adamw_table(fused_adamw, vit,
                                                         vit_s, device)
        torch.cuda.empty_cache()
        remat = check_remat(vit, ts, fa, fused_adamw, ViTConfig, TrainConfig,
                            device)
        debug_nans = check_debug_nans(train_cli, datasets, nan_check)
        profile_dir = check_profile_dir(train_cli, datasets)
        decoders = check_decoders(datasets, native)

    with phase("[19] int8 serving (w8a8, w8a8-static, w8a16) and serving "
               "artifacts", seconds):
        from vit_rpe_rope_tpu_torch import quant

        t0 = time.perf_counter()
        images = np.random.default_rng(0).integers(
            0, 256, (256, 32, 32, 3), dtype=np.uint8)
        mean, std = datasets.NORMALIZATION["cifar10"]
        with tempfile.TemporaryDirectory() as tmp:
            int8_cli, int8_preds, f32_pred, vit_s_params = check_int8_cli(
                tmp, (fa, vit, checkpoint, predict, serving, quant,
                      fused_adamw, ts), vit_s, images)
            int8_agree = check_int8_agreement(serving, datasets, keep_dir)
            int8_stream = check_int8_streaming(fa, vit, serving, mean, std,
                                               device)
            torch.cuda.empty_cache()
            artifacts, f32_program = check_artifacts(
                tmp, serving, vit_s, vit_s_params,
                {"f32": f32_pred, "w8a8": int8_preds["w8a8"]}, images, mean,
                std)
            int8_times = time_int8_serving(serving, quant, int8_preds,
                                           f32_pred, f32_program, images,
                                           device)
        del int8_preds, f32_pred, f32_program
        torch.cuda.empty_cache()
        shutil.rmtree(keep_dir)
        int8_serving = dict(cli=int8_cli, agreement=int8_agree,
                            streaming=int8_stream, artifacts=artifacts,
                            times=int8_times,
                            seconds=time.perf_counter() - t0)

    with phase("[20] data parallelism and ZeRO-1 (world size 1 over NCCL, "
               "two gloo ranks sharing the card), antialiased downsampling, "
               "data-parallel serving", seconds):
        from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh

        t0 = time.perf_counter()
        world_one, _ = check_world_one(train_modules)
        two = check_two_ranks(world_one)
        p20_dir = tempfile.mkdtemp(prefix="chip_smoke_p20_")
        downsampling = check_downsampling(train_modules, ts, datasets,
                                          device, p20_dir)
        dp_serving = check_dp_serving(
            (fa, fused_adamw, serving, predict, make_mesh),
            downsampling["ckpt"],
            datasets.synthetic("cifar10", seed=0).test_x[:256])
        shutil.rmtree(p20_dir)
        data_parallel = dict(world_one=world_one, two_ranks=two,
                             downsampling=downsampling,
                             serving=dp_serving,
                             seconds=time.perf_counter() - t0)

    with phase("[21] tensor parallelism (two gloo ranks sharing the card "
               "with --model_parallel 2; four with --model_parallel 2 "
               "--zero1)", seconds):
        tensor_parallel = check_tensor_parallel(world_one, train_modules,
                                                datasets)

    with phase("[22] context parallelism (the KV ring at R = 2 against the "
               "one-device kernels and the plain ring; the train CLI with "
               "--sequence_parallel 2 on two gloo ranks sharing the card, "
               "with --zero1 and with --q_chunk; force_ring over NCCL)",
               seconds):
        context_parallel = check_context_parallel(
            train_modules, bounded_modules, vit, datasets, ViTConfig, device)

    with phase("[23] pipeline parallelism (the train CLI with "
               "--pipeline_parallel 2 on two gloo ranks sharing the card, "
               "ViT-tiny/4 and the long-sequence model; with "
               "--model_parallel 2 on four)", seconds):
        pipeline_parallel = check_pipeline_parallel(train_modules, datasets,
                                                    vit, ViTConfig)

    with phase("[24] the compositions with the sequence axis (the train "
               "CLI with --sequence_parallel 2 --model_parallel 2 and with "
               "--pipeline_parallel 2 --sequence_parallel 2 on four gloo "
               "ranks sharing the card) and the trajectory-parity "
               "harness", seconds):
        compositions = check_compositions(train_modules, datasets, vit)

    with phase("[25] bf16 training under remat at ViT-S/16@224 (each "
               "policy beside f32 with dropout and drop-path; the train CLI "
               "at auto k, one CUDA graph of steps that draw)", seconds):
        bf16_remat = check_bf16_remat(vit, ts, fa, fused_adamw, ViTConfig,
                                      TrainConfig, train_modules, device)

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
               "stream_train_profiles": stream_traces,
               "fused_kernels": fused_times, "dparam_kernels": dparam_times,
               "fused_max_abs_err": fused_err,
               "dparam_path_launches": dparam_launches,
               "chunk_max_abs_err": chunk_err,
               "bounded_vs_monolithic": bounded_checks,
               "bounded_training": bounded_training,
               "chunk_kernel": chunk_times,
               "bounded_train_steps": bounded_steps,
               "bounded_train_profile": bounded_trace,
               "rope_axial_gap": rope_axial_gap,
               "block_fused_max_abs_err": block_err,
               "block_fused": block_times,
               "flash_block_vs_flash": flash_block_grads,
               "block_training": block_training,
               "poly8_kernel_vs_plain_losses": poly8_paths,
               "repaired_shapes_vs_twins": repaired,
               "regularised_training": regularised,
               "regularised_seconds": regularised_seconds,
               "visualizers": visualizers,
               "graph_epochs": graph_epochs, "adamw_table": adamw_table,
               "remat": remat, "debug_nans": debug_nans,
               "profile_dir": profile_dir, "decoders": decoders,
               "int8_serving": int8_serving,
               "data_parallel": data_parallel,
               "tensor_parallel": tensor_parallel,
               "context_parallel": context_parallel,
               "pipeline_parallel": pipeline_parallel,
               "compositions": compositions, "bf16_remat": bf16_remat,
               "phase_seconds": seconds}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(summary, f, indent=1)

    # Launches: each slice's main path, through the train CLI for one epoch.
    # ViT-tiny/4 (rope-mixed) for the dense kernels and AdamW; the
    # long-sequence model (rope-mixed, N=4097, batch 4) for the streaming
    # forward and its prologue (k and v rounded once per call) and the
    # separate passes' prologue, dq and dk/dv kernels (the
    # prologue takes over the rotation and rounding that the JAX dq and
    # dk/dv kernels do in every tile); ViT-S/16@384 (relative, batch 16, depth
    # 3) for dbias (the dq kernel's dbias instance and the sum over its 16
    # slabs), whose error and time are taken at that batch;
    # the long-sequence model in relative for the one-pass backward; direct
    # calls of the separate-pass backward with a generated bias (phase 13)
    # for the dcoeff and dtable kernels, which no model reaches; the
    # long-sequence model with --q_chunk 2048 (phase 15) for the chunk
    # forward, timed at the bounded step's shape at N=65,537; the fused
    # block, which no train or serve path reaches (as in the JAX package),
    # and its weight prologue from its own BLOCK_DEPTH-block forward at
    # ViT-tiny/4 (phase 16).
    launches = training["rope-mixed"]["launches"]
    routes = training["rope-mixed"]["routes"]
    # Phase 20b's launches on each of two gloo ranks: plain data
    # parallelism, and --zero1 (AdamW over the rank's slice).
    dp_launches = {label: two[label]["launches"] for label in ("dp", "zero1")}
    # Phase 21's launches on each rank: --model_parallel 2 on two gloo
    # ranks, and with --zero1 on four (data 2 x model 2, relative), of the
    # dense kernels; the long-sequence model's on two ranks, of the
    # streaming ones.
    tp_launches = {label: run["launches"]
                   for label, run in tensor_parallel.items()
                   if not label.startswith("tp_stream")}
    tp_stream_launches = {label: run["launches"]
                          for label, run in tensor_parallel.items()
                          if label.startswith("tp_stream")}

    def tp_stream(name):
        return {k: [r.get(name, 0) for r in v]
                for k, v in tp_stream_launches.items()}

    # Phase 22's launches on each of two gloo ranks with --sequence_parallel
    # 2: the long-sequence model's kernel ring (rope-mixed, relative, with
    # --zero1) and the bounded driver's ring (--q_chunk 2048).
    def cp(name):
        runs = {k: v["launches"] for k, v in context_parallel.items()
                if k.startswith("cp_")}
        return {k: [r.get(name, 0) for r in v] for k, v in runs.items()}

    # Phase 23's launches on each rank: --pipeline_parallel 2 on two gloo
    # ranks (ViT-tiny/4, 4 microbatches; the long-sequence model in
    # relative, rows 3 and 5), and with --model_parallel 2 on four.
    def pp(name):
        return {k: [r.get(name, 0) for r in v["launches"]]
                for k, v in pipeline_parallel.items()}

    # Phase 24's launches on each of four gloo ranks: --sequence_parallel 2
    # --model_parallel 2 (the long-sequence model in rope-mixed and
    # relative) and --pipeline_parallel 2 --sequence_parallel 2 (relative),
    # of the chunk kernels and AdamW; AdamW's also in the trajectory-parity
    # harness's 20 steps on the card.
    def comp(name):
        out = {k: [r.get(name, 0) for r in v["launches"]]
               for k, v in compositions.items()
               if k.startswith(("tpcp_", "ppcp_"))}
        if name == "adamw":
            out["trajectory_parity"] = [
                compositions["trajectory_parity"]["launches"]["adamw"]]
        return out

    stream_launches = stream_training["longseq"]["launches"]
    dbias_launches = stream_training["vit_s_384"]["launches"][
        "attn_stream_bwd_dbias"]
    csrc = "vit_rpe_rope_tpu_torch/ops/csrc/"
    jax_fa = "vit_rpe_rope_tpu/ops/flash_attention.py"
    fused_launches = stream_training["longseq_relative"]["launches"]
    fused_rel = fused_times["longseq N=4097"]["rel"]
    t_long = stream_times["longseq N=4097 rope-mixed f32"]
    t_384 = stream_times["vit-s/16@384 rel-bias f32"]
    # Under the CLI's auto k the main path's AdamW runs through the table
    # entry (adamw_table, phase 8's count); the by-value entry's count is
    # the same epoch's at --steps_per_dispatch 1 (phase 18a).
    by_value_adamw = graph_epochs["plain"]["k=1"]["launches"]["adamw"]
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    log(f"card: {card}")
    kernels = {"kernels": [
        kernel_line("attn_fwd", "vit_rpe_rope_tpu_torch/ops/csrc/attn_fwd.cu",
                    "vit_rpe_rope_tpu/ops/flash_attention.py:70",
                    launches["attn_fwd"], max_abs_err,
                    dict(attn["rope-mixed f32"], routes=routes,
                         int8_launches=int8_cli["w8a8"]["launches"][
                             "attn_fwd"],
                         export_launches=artifacts["f32"]["launches"][64][
                             "attn_fwd"],
                         dp_launches={k: [r["attn_fwd"] for r in v]
                                      for k, v in dp_launches.items()},
                         tp_launches={k: [r["attn_fwd"] for r in v]
                                      for k, v in tp_launches.items()},
                         pp_launches=pp("attn_fwd"))),
        kernel_line("attn_bwd", "vit_rpe_rope_tpu_torch/ops/csrc/attn_bwd.cu",
                    "vit_rpe_rope_tpu/ops/flash_attention.py:130",
                    launches["attn_bwd"], bwd_err,
                    dict(bwd["rope-mixed f32"], routes=routes,
                         dp_launches={k: [r["attn_bwd"] for r in v]
                                      for k, v in dp_launches.items()},
                         tp_launches={k: [r["attn_bwd"] for r in v]
                                      for k, v in tp_launches.items()},
                         pp_launches=pp("attn_bwd"))),
        kernel_line("adamw", "vit_rpe_rope_tpu_torch/ops/csrc/adamw.cu",
                    "vit_rpe_rope_tpu/ops/fused_adamw.py:51",
                    by_value_adamw, adamw_err,
                    dict(adamw, dp_launches={k: [r["adamw"] for r in v]
                                             for k, v in dp_launches.items()},
                         tp_launches={k: [r["adamw"] for r in v]
                                      for k, v in tp_launches.items()},
                         cp_launches=cp("adamw"), pp_launches=pp("adamw"),
                         comp_launches=comp("adamw"))),
        kernel_line("adamw_table", "vit_rpe_rope_tpu_torch/ops/csrc/adamw.cu",
                    "vit_rpe_rope_tpu/ops/fused_adamw.py:51",
                    launches["adamw_table"], adamw_table_err, adamw_table),
        kernel_line("attn_stream_fwd", csrc + "attn_stream_fwd.cu",
                    jax_fa + ":873", stream_launches["attn_stream_fwd"],
                    stream_err["fwd"],
                    dict(t_long["fwd_kernel"],
                         tp_launches=tp_stream("attn_stream_fwd"),
                         pp_launches=pp("attn_stream_fwd"),
                         int8_launches=int8_stream["launches"][
                             "attn_stream_fwd"],
                         export_launches=int8_stream["export_launches"][
                             "attn_stream_fwd"])),
        kernel_line("attn_stream_fwd_prologue", csrc + "attn_stream_fwd.cu",
                    jax_fa + ":918",
                    stream_launches["attn_stream_fwd_prologue"],
                    stream_err["fwd_prologue"], t_long["fwd_prologue"]),
        kernel_line("attn_stream_bwd_dq", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1275", stream_launches["attn_stream_bwd_dq"],
                    stream_err["dq"],
                    dict(t_long["dq"],
                         tp_launches=tp_stream("attn_stream_bwd_dq"))),
        kernel_line("attn_stream_bwd_dkv", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1353", stream_launches["attn_stream_bwd_dkv"],
                    stream_err["dkv"],
                    dict(t_long["dkv"],
                         tp_launches=tp_stream("attn_stream_bwd_dkv"))),
        kernel_line("attn_stream_bwd_prologue", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1302",
                    stream_launches["attn_stream_bwd_prologue"],
                    stream_err["prologue"], t_long["prologue"]),
        kernel_line("attn_stream_bwd_dbias", csrc + "attn_stream_bwd.cu",
                    jax_fa + ":1437", dbias_launches, stream_err["dbias"],
                    t_384["dbias"]),
        kernel_line("attn_stream_bwd_fused", csrc + "attn_stream_bwd_fused.cu",
                    jax_fa + ":1649", fused_launches["attn_stream_bwd_fused"],
                    fused_err["fused"],
                    dict(fused_rel,
                         tp_launches=tp_stream("attn_stream_bwd_fused"),
                         cp_launches=cp("attn_stream_bwd_fused"),
                         pp_launches=pp("attn_stream_bwd_fused"),
                         comp_launches=comp("attn_stream_bwd_fused"))),
        kernel_line("attn_stream_bwd_fused_prologue",
                    csrc + "attn_stream_bwd_fused.cu", jax_fa + ":1736",
                    fused_launches["attn_stream_bwd_fused_prologue"],
                    fused_err["prologue"],
                    dict(ms=fused_rel["prologue_ms"],
                         plain_ms=fused_rel["prologue_plain_ms"],
                         bound_ms=fused_rel["prologue_bound_ms"],
                         bound_by="bytes", library_ms=None)),
        kernel_line("attn_stream_bwd_dcoeff",
                    csrc + "attn_stream_bwd_fused.cu", jax_fa + ":1489",
                    dparam_launches["attn_stream_bwd_dcoeff"],
                    fused_err["dcoeff"],
                    dparam_times["longseq N=4097"]["poly"]),
        kernel_line("attn_stream_bwd_dtable",
                    csrc + "attn_stream_bwd_fused.cu", jax_fa + ":1573",
                    dparam_launches["attn_stream_bwd_dtable"],
                    fused_err["dtable"],
                    dparam_times["longseq N=4097"]["rel"]),
        kernel_line("attn_stream_chunk_fwd", csrc + "attn_stream_fwd.cu",
                    jax_fa + ":1218",
                    bounded_training["launches"]["attn_stream_chunk_fwd"],
                    chunk_err, dict(chunk_times["none"],
                                    cp_launches=cp("attn_stream_chunk_fwd"),
                                    comp_launches=comp(
                                        "attn_stream_chunk_fwd"))),
        kernel_line("block_fused", csrc + "block_fused.cu",
                    "vit_rpe_rope_tpu/ops/block_fused.py:74",
                    block_times["ViT-tiny/4 none"]["launches"], block_err,
                    block_times["ViT-tiny/4 none"]),
        kernel_line("block_fused_prologue", csrc + "block_fused.cu",
                    "vit_rpe_rope_tpu/ops/block_fused.py:59",
                    block_times["ViT-tiny/4 none"]["prologue_launches"],
                    block_prologue_err,
                    block_times["ViT-tiny/4 none"]["prologue"]),
    ]}
    idle = [line["name"] for line in kernels["kernels"]
            if not line["launches"]]
    if idle:
        raise AssertionError(f"kernels launched no time on their path: "
                             f"{idle}")
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
