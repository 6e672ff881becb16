"""Host-side training loop on one device — the single-device branch of the
JAX package's train/loop.py.

Observable behavior is the reference orchestrator's: a timestamped CSV
{log_dir}/{dataset}_{pos_encoding}_{%Y%m%d_%H%M%S}.csv with header
`epoch,train_loss,train_acc,test_loss,test_acc,best_acc`, a live progress
line, a per-epoch stdout summary, and the best-accuracy checkpoint
{ckpt_dir}/{dataset}_{pos_encoding}_best.npz (with the reference's alias
keys). Extensions kept from the JAX package: `_last.npz` every epoch and
--resume, in the JAX package's file format (either package resumes the
other's file). With q_chunk > 0 the steps and the evaluation go through the
bounded-program driver (train/bounded.py), one step per dispatch, as in the
JAX package.

Metric semantics match the reference: epoch train/test loss is the MEAN OF
BATCH-MEAN losses; accuracy is 100 · correct / total examples. Metrics stay
on the device during the epoch (one host sync per epoch, plus one per
progress refresh).
"""

from __future__ import annotations

import csv
import os
import sys
import time
import warnings
from datetime import datetime

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.train.bounded import make_bounded_step
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.utils.device import resolve_device
from vit_rpe_rope_tpu_torch.utils.flatten import Flattener

POSTFIX_EVERY = 50  # progress refresh period in steps (forces a host sync)
N_OPT_LEAVES = 4    # the JAX optimizer state's leaves on disk


def _refuse_unported(tcfg: TrainConfig) -> None:
    asked = {
        "model_parallel > 1": tcfg.model_parallel > 1,
        # with q_chunk: the bounded driver's per-chunk KV ring
        ("sequence_parallel > 1 with q_chunk > 0" if tcfg.q_chunk > 0
         else "sequence_parallel > 1"): tcfg.sequence_parallel > 1,
        "pipeline_parallel > 1": tcfg.pipeline_parallel > 1,
        "zero1": tcfg.zero1,
        "steps_per_dispatch > 1": tcfg.steps_per_dispatch > 1,
        "profile_dir": tcfg.profile_dir is not None,
        "debug_nans": tcfg.debug_nans,
    }
    fields = [name for name, on in asked.items() if on]
    if fields:
        raise NotImplementedError(
            f"TrainConfig {', '.join(fields)}: not ported to the PyTorch "
            f"package yet")


def moment_flattener(params: dict, cfg: ViTConfig) -> Flattener:
    """The canonical flat order of the optimizer moments on disk: the JAX
    package flattens its depth-stacked params, whose non-block keys come in
    sorted order (JAX rebuilds dicts with sorted keys)."""
    return Flattener(vit.stack_block_params(dict(sorted(params.items())), cfg))


def opt_to_disk(opt_state, flattener: Flattener, cfg: ViTConfig) -> list:
    """(mu, nu, count) -> the leaves of the JAX optimizer state: [count,
    mu as one flat f32 vector, nu likewise, schedule count] — optax adamw's
    (ScaleByAdamState, EmptyState, ScaleByScheduleState)."""
    mu, nu, count = opt_state

    def flat(tree):
        return flattener.flatten(vit.stack_block_params(tree, cfg)).cpu()

    count = np.asarray(count, np.int32)
    return [count, flat(mu), flat(nu), count]


def opt_from_disk(leaves, flattener: Flattener, cfg: ViTConfig, device):
    """Inverse of opt_to_disk."""
    def tree(vec):
        vec = torch.as_tensor(np.asarray(vec, np.float32))
        if vec.shape != (flattener.total,):
            raise ValueError(f"stored moment vector has shape "
                             f"{tuple(vec.shape)}, expected "
                             f"({flattener.total},)")
        out = vit.unstack_block_params(flattener.unflatten(vec), cfg)
        return {k: v.to(device).clone() for k, v in out.items()}

    return tree(leaves[1]), tree(leaves[2]), int(np.asarray(leaves[0]))


def _progress(desc, done, total, stacked):
    seen = max(float(stacked[:, 2].sum()), 1.0)
    # Reference quirk preserved: the LIVE postfix divides the SUM OF
    # BATCH-MEAN losses by the SAMPLE count, while the returned epoch loss
    # divides it by the BATCH count.
    sys.stdout.write(f"\r{desc}: {done}/{total} "
                     f"loss={float(stacked[:, 0].sum()) / seen:.4f} "
                     f"acc={100.0 * float(stacked[:, 1].sum()) / seen:.2f}")
    sys.stdout.flush()


def _run_epoch(step_fn, state, data_x, data_y, epoch_idx, desc, train: bool,
               k: int = 1, verbose: bool = True, epoch: int = 0):
    """Drive one epoch; returns (state, avg_batch_loss, accuracy_pct,
    images_per_sec). k > 1: each train step consumes k index rows
    (gradient accumulation; epoch_idx is padded to a multiple of k). Train
    steps get `epoch`, which seeds their draws."""
    steps = epoch_idx.shape[0]
    metrics = []
    t0 = time.perf_counter()
    for i, s in enumerate(range(0, steps, k)):
        if train:
            params, opt_state, m = step_fn(state[0], state[1], s, data_x,
                                           data_y, epoch_idx, epoch=epoch)
            state = (params, opt_state)
        else:
            m = step_fn(state[0], s, data_x, data_y, epoch_idx)
        metrics.append(m)
        if verbose and i % POSTFIX_EVERY == 0 and i > 0:
            _progress(desc, i, -(-steps // k),
                      torch.stack(metrics[:-1]).cpu().numpy())
    stacked = torch.stack(metrics).cpu().numpy()
    if verbose and len(metrics) > POSTFIX_EVERY:
        sys.stdout.write("\n")
    # Drop fully-padded steps (count == 0) so the mean-of-batch-means
    # denominator stays exact.
    stacked = stacked[stacked[:, 2] > 0]
    dt = time.perf_counter() - t0
    total = stacked[:, 2].sum()
    avg_loss = float(stacked[:, 0].mean())  # mean of batch means (reference)
    acc = 100.0 * float(stacked[:, 1].sum()) / max(float(total), 1.0)
    return state, avg_loss, acc, float(total) / dt


def _bounded_fns(cfg: ViTConfig, tcfg: TrainConfig, update, preprocess):
    """(train_fn, eval_fn) with the signatures of make_train_step /
    make_eval_step over the bounded-program step: each gathers its index
    rows (grad_accum rows behind a leading accumulation axis) and hands the
    batch to the bounded driver."""
    accum = tcfg.grad_accum
    bounded_step = make_bounded_step(cfg, tcfg, update, preprocess,
                                     q_chunk=tcfg.q_chunk,
                                     kv_chunk=tcfg.kv_chunk, grad_accum=accum)

    def train_fn(params, opt_state, row, data_x, data_y, epoch_idx, epoch=0):
        del epoch  # the bounded driver draws nothing: no dropout, no augment
        imgs, labels, mask = ts._gather_batch(
            data_x, data_y, epoch_idx[row:row + accum].reshape(-1))
        if accum > 1:
            imgs = imgs.reshape(accum, -1, *imgs.shape[1:])
            labels, mask = labels.reshape(accum, -1), mask.reshape(accum, -1)
        return bounded_step(params, opt_state, row, imgs, labels, mask)

    def eval_fn(params, row, data_x, data_y, epoch_idx):
        imgs, labels, mask = ts._gather_batch(data_x, data_y, epoch_idx[row])
        return bounded_step.evaluate(params, row, imgs, labels, mask)

    return train_fn, eval_fn


def fit(cfg: ViTConfig, tcfg: TrainConfig, verbose: bool = True,
        device=None) -> dict:
    """Full training run on one device (default: the CUDA device; raises
    when there is none unless device="cpu"). Returns a summary dict
    (best_acc, log_file, ckpt_path, history, num_params, num_devices)."""
    _refuse_unported(tcfg)
    device = resolve_device(device)
    if cfg.attn_drop_rate > 0 and cfg.seq_len > 2048:
        warnings.warn(
            "attn_drop_rate > 0 materializes the attention probabilities "
            f"(the dropout mask lives on them), so at seq_len={cfg.seq_len} "
            "the streaming attention is bypassed and each block allocates "
            "O(B*H*N^2) memory", stacklevel=2)

    os.makedirs(tcfg.log_dir, exist_ok=True)
    os.makedirs(tcfg.ckpt_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = f"{tcfg.log_dir}/{tcfg.dataset}_{cfg.pos_encoding}_{timestamp}.csv"
    with open(log_file, "w", newline="") as f:
        csv.writer(f).writerow(
            ["epoch", "train_loss", "train_acc", "test_loss", "test_acc",
             "best_acc"])

    bundle = datasets.get_dataset(
        tcfg.dataset, tcfg.data_dir, tcfg.synthetic_data, tcfg.seed)
    train_x = torch.from_numpy(bundle.train_x).to(device)
    train_y = torch.from_numpy(bundle.train_y).to(device)
    test_x = torch.from_numpy(bundle.test_x).to(device)
    test_y = torch.from_numpy(bundle.test_y).to(device)

    # Index ROWS per epoch (one row = one batch of batch_size examples);
    # grad_accum > 1 folds `accum` consecutive rows into one optimizer step.
    accum = tcfg.grad_accum
    rows_per_epoch = -(-len(bundle.train_y) // tcfg.batch_size)
    steps_per_epoch = -(-rows_per_epoch // accum)  # optimizer steps
    preprocess = ts.make_preprocess(cfg, bundle.mean, bundle.std,
                                    bundle.train_x.shape[1],
                                    augment=tcfg.augment)

    params = vit.init_params(torch.Generator().manual_seed(tcfg.seed), cfg,
                             device=device)
    opt_init, opt_update = ts.make_optimizer(tcfg, steps_per_epoch, params)
    opt_state = opt_init(params)
    flattener = moment_flattener(params, cfg)

    last_path = f"{tcfg.ckpt_dir}/{tcfg.dataset}_{cfg.pos_encoding}_last.npz"
    start_epoch, best_acc = 0, 0.0
    if tcfg.resume and os.path.exists(last_path):
        loaded, leaves, start_epoch, best_acc = checkpoint.load_train_state(
            last_path, N_OPT_LEAVES)
        if set(loaded) != set(params):
            raise ValueError(
                f"{last_path} holds params {sorted(set(loaded) ^ set(params))}"
                f" that differ from this model's")
        params = {k: loaded[k].to(device=device, dtype=torch.float32)
                  for k in params}
        opt_state = opt_from_disk(leaves, flattener, cfg, device)
        if verbose:
            print(f"Resumed from {last_path} at epoch {start_epoch} "
                  f"(best {best_acc:.2f}%)")
    for v in params.values():
        v.requires_grad_(True)

    if tcfg.q_chunk > 0:
        train_fn, eval_fn = _bounded_fns(cfg, tcfg, opt_update, preprocess)
    else:
        train_fn = ts.make_train_step(cfg, opt_update, preprocess,
                                      accum=accum, seed=tcfg.seed)
        eval_fn = ts.make_eval_step(cfg, preprocess)
    eval_idx = ts.epoch_indices(len(bundle.test_y), tcfg.batch_size,
                                False).to(device)

    ckpt_path = None
    history = []
    for epoch in range(start_epoch, tcfg.epochs):
        if verbose:
            print(f"\nEpoch: {epoch + 1}/{tcfg.epochs}")
        epoch_idx = ts.pad_epoch_indices(
            ts.epoch_indices(len(bundle.train_y), tcfg.batch_size, True,
                             seed=tcfg.seed, epoch=epoch), accum).to(device)
        (params, opt_state), train_loss, train_acc, train_ips = _run_epoch(
            train_fn, (params, opt_state), train_x, train_y, epoch_idx,
            "Training", True, k=accum, verbose=verbose, epoch=epoch)
        _, test_loss, test_acc, _ = _run_epoch(
            eval_fn, (params, None), test_x, test_y, eval_idx, "Testing",
            False, verbose=verbose)

        host_params = {k: v.detach().cpu() for k, v in params.items()}
        if test_acc > best_acc:
            best_acc = test_acc
            ckpt_path = checkpoint.save(
                f"{tcfg.ckpt_dir}/{tcfg.dataset}_{cfg.pos_encoding}_best.npz",
                host_params, vit.buffers(cfg),
                aliases=vit.reference_alias_keys(cfg))
        if tcfg.save_last:
            checkpoint.save_train_state(
                last_path, host_params, opt_to_disk(opt_state, flattener, cfg),
                epoch, best_acc)

        with open(log_file, "a", newline="") as f:
            csv.writer(f).writerow(
                [epoch + 1, train_loss, train_acc, test_loss, test_acc,
                 best_acc])
        history.append(
            dict(epoch=epoch + 1, train_loss=train_loss, train_acc=train_acc,
                 test_loss=test_loss, test_acc=test_acc,
                 images_per_sec=train_ips))
        if verbose:
            print(f"Train Loss: {train_loss:.4f}, Train Acc: {train_acc:.2f}%")
            print(f"Test Loss: {test_loss:.4f}, Test Acc: {test_acc:.2f}%")
            print(f"Best Test Acc: {best_acc:.2f}% "
                  f"({train_ips:,.0f} images/sec train)")

    return dict(best_acc=best_acc, log_file=log_file, ckpt_path=ckpt_path,
                history=history, num_params=vit.num_params(params),
                num_devices=1)
