"""Host-side training loop on one device, or on each rank of a process
group (data, tensor, context and pipeline parallelism, their compositions,
ZeRO-1) — the data-, model-, sequence- and pipe-axis branches of the JAX
package's train/loop.py.

Observable behavior is the reference orchestrator's: a timestamped CSV
{log_dir}/{dataset}_{pos_encoding}_{%Y%m%d_%H%M%S}.csv with header
`epoch,train_loss,train_acc,test_loss,test_acc,best_acc`, a live progress
line, a per-epoch stdout summary, and the best-accuracy checkpoint
{ckpt_dir}/{dataset}_{pos_encoding}_best.npz (with the reference's alias
keys). Extensions kept from the JAX package: `_last.npz` every epoch and
--resume, in the JAX package's file format (either package resumes the
other's file); steps_per_dispatch k > 1, k steps per call of the k-step
driver (train_step.make_train_multi_step: one CUDA-graph replay on the
card) over the epoch-ordered feed; profile_dir, a torch.profiler trace of
the run; debug_nans, the NaN sanitizer (utils/nan_check.py). With q_chunk
> 0 the steps and the evaluation go through the bounded-program driver
(train/bounded.py), one step per dispatch, as in the JAX package, also
over data and sequence ranks (its per-q-chunk KV ring).
steps_per_dispatch 0 (auto) is the JAX loop's rule
(train_step.resolve_steps_per_dispatch): the largest divisor of the
epoch's steps up to 32 on the card, 1 on the CPU and with q_chunk; the
evaluation takes the same rule over its own rows (make_eval_step(k=), one
CUDA-graph replay of k forwards on the card).

Metric semantics match the reference: epoch train/test loss is the MEAN OF
BATCH-MEAN losses; accuracy is 100 · correct / total examples. Metrics stay
on the device during the epoch (one host sync per epoch, plus one per
progress refresh).
"""

from __future__ import annotations

import contextlib
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
from vit_rpe_rope_tpu_torch.parallel import distributed, pipeline_parallel
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.train.bounded import make_bounded_step
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.utils import nan_check
from vit_rpe_rope_tpu_torch.utils.device import resolve_device
from vit_rpe_rope_tpu_torch.utils.flatten import Flattener

POSTFIX_EVERY = 50  # progress refresh period in steps (forces a host sync)
N_OPT_LEAVES = 4    # the JAX optimizer state's leaves on disk


def _layout(mesh):
    """The module whose shard_reference / gather_reference turn the
    reference layout into a rank's train state and back: the pipeline's
    over a pipe axis, else the tensor-parallel one (the reference layout
    itself without a model axis)."""
    return (pipeline_parallel if pipeline_parallel.has_pipe_axis(mesh)
            else tensor_parallel)


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


def _zero1_full(vec, total: int, mesh):
    """A ZeRO-1 moment slice -> the whole flat vector [total] on its device
    (gathered over the rank's model column; the padding cut off)."""
    rank, world = ts._world(mesh)
    if world > 1:
        vec = distributed.all_gather_slices(vec, rank, world,
                                            mesh.data_group)
    return vec[:total]


def _zero1_slice(vec, mesh):
    """Inverse of _zero1_full: this data rank's slice of a flat vector,
    zero-padded to shard · world."""
    rank, world = ts._world(mesh)
    shard = ts.zero1_shard_size(vec.numel(), world)
    vec = torch.nn.functional.pad(vec, (0, shard * world - vec.numel()))
    return vec[rank * shard:(rank + 1) * shard].clone()


def mesh_opt_to_disk(opt_state, flattener: Flattener, cfg: ViTConfig,
                     mesh, local: dict, zero1: bool) -> list:
    """A train run's optimizer state over `mesh` (None: one device) ->
    opt_to_disk's leaves (the JAX loop's opt_to_disk): the moment dicts of
    the params `local` (a tensor-parallel rank's shard, or the reference
    params without a model axis), or under ZeRO-1 this data rank's slices
    of their flat vector (flat_layout of `local`), gathered into the
    reference layout and flattened canonically; the ZeRO-1 padding is cut
    off. Every rank takes part where the state is sharded."""
    mu, nu, count = opt_state
    if zero1:
        layout = ts.flat_layout(local, cfg)
        mu, nu = (layout.unflatten(_zero1_full(vec, layout.total, mesh))
                  for vec in (mu, nu))
    mu, nu = (_layout(mesh).gather_reference(m, cfg, mesh)
              for m in (mu, nu))
    return opt_to_disk((mu, nu, count), flattener, cfg)


def mesh_opt_from_disk(leaves, flattener: Flattener, cfg: ViTConfig, mesh,
                       local: dict, zero1: bool, device):
    """Inverse of mesh_opt_to_disk: each rank keeps its model (or stage)
    shard of the stored moments, and under ZeRO-1 its data rank's slice of
    that shard's flat vector, zero-padded to shard · world."""
    mu, nu, count = opt_from_disk(leaves, flattener, cfg, device)
    mu, nu = (_layout(mesh).shard_reference(m, cfg, mesh)
              for m in (mu, nu))
    if zero1:
        layout = ts.flat_layout(local, cfg)
        mu, nu = (_zero1_slice(layout.flatten(m), mesh) for m in (mu, nu))
    return mu, nu, count


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
    images_per_sec). k > 1: each call consumes k index rows (gradient
    accumulation and/or several steps per dispatch; epoch_idx is padded to
    a multiple of k) and returns one metrics row per optimizer step. Train
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
        metrics.append(m.reshape(-1, 3))
        if verbose and i % POSTFIX_EVERY == 0 and i > 0:
            _progress(desc, i, -(-steps // k),
                      torch.cat(metrics[:-1]).cpu().numpy())
    stacked = torch.cat(metrics).cpu().numpy()
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


def _bounded_fns(cfg: ViTConfig, tcfg: TrainConfig, update, preprocess,
                 mesh=None):
    """(train_fn, eval_fn) with the signatures of make_train_step /
    make_eval_step over the bounded-program step: each gathers its index
    rows (grad_accum rows behind a leading accumulation axis) and hands the
    batch to the bounded driver, over `mesh` when it is a process group's
    (each data rank's columns, the KV ring over its sequence axis)."""
    accum = tcfg.grad_accum
    ring = ({} if mesh is None else
            dict(mesh=mesh, seq_parallel=tcfg.sequence_parallel))
    bounded_step = make_bounded_step(cfg, tcfg, update, preprocess,
                                     q_chunk=tcfg.q_chunk,
                                     kv_chunk=tcfg.kv_chunk, grad_accum=accum,
                                     **ring)

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


@contextlib.contextmanager
def _profiled(tcfg: TrainConfig, device, trace_name: str):
    """torch.profiler over the body when tcfg.profile_dir is set (CPU
    activity, and CUDA activity on the card), stopped in a finally, as the
    JAX loop stops its trace; it writes {profile_dir}/{trace_name}.pt.trace
    .json, a Chrome trace."""
    if not tcfg.profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(tcfg.profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            tcfg.profile_dir, f"{trace_name}.pt.trace.json"))


def fit(cfg: ViTConfig, tcfg: TrainConfig, verbose: bool = True,
        device=None) -> dict:
    """Full training run on one device (default: the CUDA device; raises
    when there is none unless device="cpu"). Returns a summary dict
    (best_acc, log_file, ckpt_path, history, num_params, num_devices,
    capture_seconds: the k-step driver's CUDA-graph capture, else None;
    eval_capture_seconds: the evaluation graph's; steps_per_dispatch and
    eval_rows_per_dispatch: the k and k_eval the run took).
    With tcfg.debug_nans the whole run is under the NaN sanitizer, which is
    off again when fit returns or raises.

    Under a process group (parallel.distributed.initialize) every rank calls
    fit, and the group is the data axis (parallel.mesh.make_mesh; the world
    size must divide batch_size): each step splits its batch over the ranks
    and sums its gradients over them (train_step.make_train_step(mesh=)),
    rank 0's params are broadcast at the start and after a resume, and only
    rank 0 prints and writes the CSV and the checkpoints (log_file and
    ckpt_path are None on the other ranks). device None is the rank's
    device. tcfg.zero1 shards the AdamW moments over the ranks
    (train_step.make_zero1_adamw); `_last.npz` keeps the canonical flat
    moments either way, so a run resumes with --zero1 on or off and at
    another world size.

    tcfg.model_parallel T > 1 (the JAX fit's TP branch) needs a process
    group of D·T ranks (T dividing the world size and num_heads, with the
    JAX fit's ValueError otherwise): the ranks form a D x T mesh, each
    trains on its shard of the heads and MLP rows
    (parallel.tensor_parallel), evaluation and the checkpoints see the
    params gathered over the model axis in the reference layout, and the
    moments go to disk as the canonical flat vectors (also under --zero1,
    sharded over the data axis per model shard), so a run resumes under
    another T, world size or --zero1.

    tcfg.sequence_parallel R > 1 (the JAX fit's CP branch) needs a process
    group of D·R ranks: the ranks form a D x R mesh, each data row a KV
    ring over which every block's attention runs on the rank's token shard
    (parallel.context_parallel.apply_cp, in training and evaluation);
    params stay replicated, the gradients are summed over every rank, and
    --zero1 shards the moments over every rank. Dropout is refused, with
    the JAX fit's words. With q_chunk > 0 the bounded driver runs its
    per-q-chunk ring over the same mesh.

    tcfg.pipeline_parallel P > 1 (the JAX fit's PP branch, and with
    model_parallel T > 1 its PP x TP branch) needs a process group of D·P
    (D·P·T) ranks: the ranks form a D x P (D x P x T) mesh, each holds its
    stage's depth / P blocks (of its heads and MLP rows under T) and runs
    its part of the GPipe schedule over tcfg.pp_microbatches microbatches
    of its batch (0: P) (parallel/pipeline_parallel.py, pp_tp.py); the
    replicated params stay replicated. The JAX fit's ValueErrors, in its
    words: P dividing depth, M dividing the per-rank batch, dropout,
    grad_accum > 1; configs.TrainConfig refuses --zero1. Evaluation, the
    checkpoints and `_last.npz` see the params and moments gathered into
    the reference layout, as under tensor parallelism.

    The compositions with the sequence axis (the JAX fit's TP x CP and
    PP x TP x CP branches, use_tpcp and use_pptpcp): sequence_parallel R
    > 1 with model_parallel T > 1 needs D·R·T ranks on a D x R x T mesh
    (parallel/tp_cp.py: each rank trains its token shard of its heads and
    MLP rows); with pipeline_parallel P > 1 (and T >= 1), D·P·R·T ranks on
    a D x P x R x T mesh (parallel/pp_tp_cp.py: each stage's blocks run
    the ring, over T model ranks when T > 1). The params and moments are
    the rank's shards as under TP and PP; evaluation runs the composed
    forward on them (train_step.make_eval_step), while the CSV, the
    checkpoints and `_last.npz` see them gathered into the reference
    layout, so a run resumes at another world size. The JAX refusals, in
    its words: dropout; grad_accum > 1 with a pipe axis; configs.
    TrainConfig refuses --zero1 with TP x CP and with a pipe axis, and
    q_chunk > 0 with a model or a pipe axis (so the bounded driver only
    ever runs on a data x seq mesh)."""
    sanitizer = nan_check.debug_nans() if tcfg.debug_nans \
        else contextlib.nullcontext()
    with sanitizer:
        return _fit(cfg, tcfg, verbose, device)


def _fit(cfg: ViTConfig, tcfg: TrainConfig, verbose: bool, device) -> dict:
    t_par, r_seq = tcfg.model_parallel, tcfg.sequence_parallel
    p_pipe = tcfg.pipeline_parallel
    mesh = (make_mesh(batch_size=tcfg.batch_size, model_parallel=t_par,
                      seq_parallel=r_seq, pipe_parallel=p_pipe)
            if distributed.is_initialized() or t_par > 1 or r_seq > 1
            or p_pipe > 1 else None)
    if (r_seq > 1 or p_pipe > 1) and cfg.has_dropout:
        raise ValueError("sequence_parallel/pipeline_parallel do not support "
                         "dropout rates > 0")
    n_micro = tcfg.pp_microbatches or p_pipe
    if p_pipe > 1:
        if cfg.depth % p_pipe:
            raise ValueError(f"pipeline_parallel={p_pipe} must divide "
                             f"depth={cfg.depth}")
        local_bs = tcfg.batch_size // mesh.size
        if local_bs % n_micro:
            raise ValueError(f"per-device batch {local_bs} not divisible by "
                             f"pp_microbatches={n_micro}")
    if t_par > 1 and cfg.num_heads % t_par:
        raise ValueError(f"model_parallel={t_par} must divide "
                         f"num_heads={cfg.num_heads}")
    if p_pipe > 1 and tcfg.grad_accum > 1:
        raise ValueError("grad_accum > 1 is not supported with pipeline "
                         "parallelism (use --pp_microbatches — PP already "
                         "microbatches within the step)")
    if device is None and mesh is not None:
        device = distributed.device()
    device = resolve_device(device)
    lead = distributed.rank() == 0  # writes the files, prints the lines
    verbose = verbose and lead
    if cfg.attn_drop_rate > 0 and cfg.seq_len > 2048:
        warnings.warn(
            "attn_drop_rate > 0 materializes the attention probabilities "
            f"(the dropout mask lives on them), so at seq_len={cfg.seq_len} "
            "the streaming attention is bypassed and each block allocates "
            "O(B*H*N^2) memory", stacklevel=2)

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = None
    if lead:
        os.makedirs(tcfg.log_dir, exist_ok=True)
        os.makedirs(tcfg.ckpt_dir, exist_ok=True)
        log_file = (f"{tcfg.log_dir}/{tcfg.dataset}_{cfg.pos_encoding}_"
                    f"{timestamp}.csv")
        with open(log_file, "w", newline="") as f:
            csv.writer(f).writerow(
                ["epoch", "train_loss", "train_acc", "test_loss", "test_acc",
                 "best_acc"])

    bundle = datasets.get_dataset(
        tcfg.dataset, tcfg.data_dir, tcfg.synthetic_data, tcfg.seed)
    train_x, train_y, test_x, test_y = (
        distributed.stage_per_host(a, device) for a in
        (bundle.train_x, bundle.train_y, bundle.test_x, bundle.test_y))

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
    flattener = moment_flattener(params, cfg)

    last_path = f"{tcfg.ckpt_dir}/{tcfg.dataset}_{cfg.pos_encoding}_last.npz"
    start_epoch, best_acc, leaves = 0, 0.0, None
    if tcfg.resume and os.path.exists(last_path):
        loaded, leaves, start_epoch, best_acc = checkpoint.load_train_state(
            last_path, N_OPT_LEAVES)
        if set(loaded) != set(params):
            raise ValueError(
                f"{last_path} holds params {sorted(set(loaded) ^ set(params))}"
                f" that differ from this model's")
        params = {k: loaded[k].to(device=device, dtype=torch.float32)
                  for k in params}
        if verbose:
            print(f"Resumed from {last_path} at epoch {start_epoch} "
                  f"(best {best_acc:.2f}%)")
    if mesh is not None:  # every rank starts from rank 0's params
        distributed.broadcast_params(params)
    # Under TP or PP the train state is the rank's shard; evaluation and
    # the checkpoints see the params gathered back (gather_reference below).
    layout = _layout(mesh)
    train_params = layout.shard_reference(params, cfg, mesh)
    for v in train_params.values():
        v.requires_grad_(True)
    opt_init, opt_update = ts.make_optimizer(
        tcfg, steps_per_epoch, train_params, cfg=cfg, mesh=mesh)
    opt_state = opt_init(train_params)
    if leaves is not None:
        opt_state = mesh_opt_from_disk(leaves, flattener, cfg, mesh,
                                       train_params, tcfg.zero1, device)

    # Optimizer steps and evaluation rows per dispatch, by the JAX loop's
    # rule: auto (0) fuses them on the card and stays at 1 on the CPU; the
    # bounded driver is host-scheduled, one per dispatch.
    bounded = tcfg.q_chunk > 0
    k = ts.resolve_steps_per_dispatch(tcfg.steps_per_dispatch,
                                      steps_per_epoch, device, bounded)
    eval_steps = -(-len(bundle.test_y) // tcfg.batch_size)
    k_eval = ts.resolve_steps_per_dispatch(0, eval_steps, device, bounded)
    stride = k * accum  # index rows per dispatch
    if bounded:
        train_fn, eval_fn = _bounded_fns(cfg, tcfg, opt_update, preprocess,
                                         mesh)
    else:
        if k > 1:
            train_fn = ts.make_train_multi_step(
                cfg, opt_update, preprocess, k, accum=accum, seed=tcfg.seed,
                feed="ordered", mesh=mesh, n_micro=n_micro)
        else:
            train_fn = ts.make_train_step(cfg, opt_update, preprocess,
                                          accum=accum, seed=tcfg.seed,
                                          mesh=mesh, n_micro=n_micro)
        eval_fn = ts.make_eval_step(cfg, preprocess, mesh=mesh,
                                    n_micro=n_micro, k=k_eval)
    eval_idx = ts.pad_epoch_indices(
        ts.epoch_indices(len(bundle.test_y), tcfg.batch_size, False),
        k_eval).to(device)
    # Under a sequence axis the evaluation runs the train step's forward on
    # the rank's train params (make_eval_step); elsewhere it takes the
    # params gathered into the reference layout.
    seq_eval = mesh is not None and mesh.seq_parallel > 1

    ckpt_path = None
    history = []
    with _profiled(tcfg, device,
                   f"{tcfg.dataset}_{cfg.pos_encoding}_{timestamp}"):
        for epoch in range(start_epoch, tcfg.epochs):
            if verbose:
                print(f"\nEpoch: {epoch + 1}/{tcfg.epochs}")
            epoch_idx = ts.pad_epoch_indices(
                ts.epoch_indices(len(bundle.train_y), tcfg.batch_size, True,
                                 seed=tcfg.seed, epoch=epoch),
                stride).to(device)
            ep_x, ep_y = train_x, train_y
            if k > 1:  # one gather per epoch; each dispatch takes a slice
                ep_x, ep_y = ts.epoch_order_data(train_x, train_y, epoch_idx)
            (train_params, opt_state), train_loss, train_acc, train_ips = \
                _run_epoch(train_fn, (train_params, opt_state), ep_x, ep_y,
                           epoch_idx, "Training", True, k=stride,
                           verbose=verbose, epoch=epoch)
            del ep_x, ep_y
            params = layout.gather_reference(train_params, cfg, mesh)
            _, test_loss, test_acc, _ = _run_epoch(
                eval_fn, (train_params if seq_eval else params, None),
                test_x, test_y, eval_idx, "Testing", False, k=k_eval,
                verbose=verbose)

            host_params = ({k: v.detach().cpu() for k, v in params.items()}
                           if lead else None)
            if test_acc > best_acc:  # the same on every rank
                best_acc = test_acc
                if lead:
                    ckpt_path = checkpoint.save(
                        f"{tcfg.ckpt_dir}/{tcfg.dataset}_{cfg.pos_encoding}"
                        f"_best.npz", host_params, vit.buffers(cfg),
                        aliases=vit.reference_alias_keys(cfg))
            if tcfg.save_last:
                opt_leaves = mesh_opt_to_disk(opt_state, flattener, cfg,
                                              mesh, train_params, tcfg.zero1)
                if lead:
                    checkpoint.save_train_state(last_path, host_params,
                                                opt_leaves, epoch, best_acc)

            if lead:
                with open(log_file, "a", newline="") as f:
                    csv.writer(f).writerow(
                        [epoch + 1, train_loss, train_acc, test_loss,
                         test_acc, best_acc])
            history.append(
                dict(epoch=epoch + 1, train_loss=train_loss,
                     train_acc=train_acc, test_loss=test_loss,
                     test_acc=test_acc, images_per_sec=train_ips))
            if verbose:
                print(f"Train Loss: {train_loss:.4f}, "
                      f"Train Acc: {train_acc:.2f}%")
                print(f"Test Loss: {test_loss:.4f}, "
                      f"Test Acc: {test_acc:.2f}%")
                print(f"Best Test Acc: {best_acc:.2f}% "
                      f"({train_ips:,.0f} images/sec train)")

    return dict(best_acc=best_acc, log_file=log_file, ckpt_path=ckpt_path,
                history=history, num_params=vit.num_params(params),
                num_devices=(len(mesh.ranks) if mesh is not None
                             and mesh.distributed else 1),
                capture_seconds=getattr(
                    train_fn, "capture_seconds", None),
                eval_capture_seconds=getattr(
                    eval_fn, "capture_seconds", None),
                steps_per_dispatch=k, eval_rows_per_dispatch=k_eval)
