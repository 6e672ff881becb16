"""Training and eval steps on one device — the single-device body of the JAX
package's train/train_step.py.

* The whole dataset is staged on the device as uint8 NHWC once per run; each
  step gathers its batch by indices, converts, (bilinearly) resizes and
  normalizes on the device.
* Epochs are driven by a permutation reshaped to [steps, batch]; the final
  partial batch is padded with index -1 and masked (the reference trains on
  the partial batch; masking reproduces its batch-mean semantics exactly).
* Loss is cross-entropy summed over the real examples and divided by their
  count (torch nn.CrossEntropyLoss's mean); accuracy is argmax agreement.
* The optimizer is the fused multi-tensor AdamW kernel (ops/fused_adamw)
  with decoupled weight decay on ALL params, as torch AdamW with one param
  group does, and the per-epoch cosine schedule.
* Metrics stay on the device: one host sync per epoch, in the loop.
* Each train row (one batch) gets its own pair of generators on the device,
  seeded from (seed, epoch, row) as the JAX package folds its key: one for
  the augmentation draws, one for the dropout masks, as the JAX step splits
  its key in two.
* make_train_multi_step runs k optimizer steps per call: on the CUDA device
  as one replay of a CUDA graph that holds the k steps, fed from the
  epoch-ordered data (epoch_order_data) through static buffers; on the CPU,
  and wherever a step draws random numbers or --debug_nans reads values on
  the host, as the same k steps run eagerly.

The JAX package's k-step drivers (make_train_multi_step,
make_flat_train_multi_step over a flat depth-stacked vector,
make_fused_adamw_multi_step) exist to put k steps in one XLA program; the
flat vector was their device for cutting XLA's per-leaf work. The port keeps
its reference-keyed dict, whose AdamW already updates every leaf in one
launch from a device table, and ports their observable contract: k steps
per dispatch, padded steps as no-ops, the trajectory of the per-step
driver.

The JAX package shuffles, augments and drops out with jax.random, which the
port cannot reproduce without jax: epoch_indices shuffles with a
torch.Generator seeded from (seed, epoch), and the per-row draws come from
torch.Generators — differences by design (tests inject one index matrix
into both packages, and replay one package's draws in the other).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig, cosine_lr_by_epoch
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import launches
from vit_rpe_rope_tpu_torch.ops.fused_adamw import hyper_rows, make_fused_adamw
from vit_rpe_rope_tpu_torch.parallel import context_parallel, distributed
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel, pp_tp
from vit_rpe_rope_tpu_torch.parallel import pp_tp_cp, tensor_parallel
from vit_rpe_rope_tpu_torch.utils import nan_check
from vit_rpe_rope_tpu_torch.utils.flatten import Flattener


def make_optimizer(tcfg: TrainConfig, steps_per_epoch: int, template: dict,
                   cfg: ViTConfig | None = None, mesh=None):
    """(init, update) of the fused AdamW over the params dict `template`;
    with tcfg.zero1, its ZeRO-1 form over `mesh`'s ranks (make_zero1_adamw;
    cfg fixes the flat layout)."""
    schedule = cosine_lr_by_epoch(tcfg.lr, tcfg.epochs, steps_per_epoch)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=tcfg.weight_decay)
    if tcfg.zero1:
        return make_zero1_adamw(template, cfg, schedule, mesh=mesh, **hyper)
    return make_fused_adamw(template, schedule, **hyper)


def zero1_shard_size(total: int, n_data: int) -> int:
    """Per-rank length of the padded flat vector under ZeRO-1."""
    return -(-total // n_data)


def _world(mesh) -> tuple:
    """(rank, world) of ZeRO-1's shards over a process group's mesh: the
    data axis (a model column under tensor parallelism), or under context
    parallelism every rank, whose gradients the step sums over the whole
    group (the JAX init_cp_zero1_opt_state's data x seq product); (0, 1)
    otherwise."""
    if mesh is None or not mesh.distributed:
        return 0, 1
    if mesh.seq_parallel > 1:
        return distributed.rank(), distributed.world_size()
    return mesh.rank, mesh.size


def init_zero1_opt_state(flattener: Flattener, mesh, device):
    """ZeRO-1's optimizer state on this rank: (mu, nu, count) with mu and nu
    zeros for this rank's slice [r·shard, (r+1)·shard) of the flat vector
    (flattener's layout, zero-padded to shard·world), count 0."""
    shard = zero1_shard_size(flattener.total, _world(mesh)[1])
    return (torch.zeros(shard, device=device),
            torch.zeros(shard, device=device), 0)


def make_zero1_adamw(template: dict, cfg: ViTConfig, schedule, mesh=None,
                     b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01):
    """ZeRO stage 1 over a process group's ranks (the JAX
    make_flat_train_multi_step(zero1=True)): make_fused_adamw's contract
    (init, update, update.hyper, update.from_table) with the moments sharded.

    Each rank holds mu and nu for its slice of the flat vector of
    flat_layout(template, cfg), zero-padded to shard·world
    (init_zero1_opt_state). An update takes the step's (summed) gradients,
    slices its gradient and parameter slice, runs the AdamW kernel (row 11,
    ops/fused_adamw) over that slice as a one-leaf template, gathers the
    updated slices back into the full parameter vector
    (parallel.distributed.all_gather_slices, an exact all_reduce) and
    copies it into the params. The count and the schedule stay replicated.
    The update is elementwise, so the params are those of the replicated
    optimizer on the same gradients. Without a process group (mesh None) it
    is the one-device run: one slice, no collective. Under tensor
    parallelism (the JAX ZeRO-1 x TP update) template is the rank's local
    shard: each rank holds 1/D of its model shard's flat vector, and the
    slices are gathered over its model column (Mesh.data_group) only.
    Under context parallelism (the JAX ZeRO-1 x CP update, whose
    cp_zero1_flattener and init_cp_zero1_opt_state this covers) the params
    are replicated and the slices of flat_layout's vector are over every
    rank of the group (_world)."""
    layout = flat_layout(template, cfg)
    _, inner = make_fused_adamw({"flat": None}, schedule, b1=b1, b2=b2,
                                eps=eps, weight_decay=weight_decay)
    slices = {}  # this rank's parameter slice per device, kept for the
    #              AdamW kernel's device table (one set of storages)

    def init(params):
        device = next(iter(params.values())).device
        return init_zero1_opt_state(layout, mesh, device)

    def sliced(grads, state, params):
        rank, world = _world(mesh)
        shard = zero1_shard_size(layout.total, world)
        pad = shard * world - layout.total
        lo = rank * shard
        g = F.pad(layout.flatten(grads), (0, pad))[lo:lo + shard]
        p_full = F.pad(layout.flatten(params), (0, pad))
        if p_full.device not in slices:
            slices[p_full.device] = torch.empty(shard, device=p_full.device)
        p = slices[p_full.device]
        p.copy_(p_full[lo:lo + shard])
        mu, nu, count = state
        return {"flat": g}, ({"flat": mu}, {"flat": nu}, count), {"flat": p}

    def gather(p, params, world):
        full = p if world == 1 else distributed.all_gather_slices(
            p, _world(mesh)[0], world, mesh.data_group)
        views = layout.unflatten(full[:layout.total])
        keys = list(params)
        torch._foreach_copy_([params[k].detach() for k in keys],
                             [views[k] for k in keys])

    def update(grads, state, params):
        with torch.no_grad():
            g, inner_state, p = sliced(grads, state, params)
            _, (mu, nu, count) = inner(g, inner_state, p)
            gather(p["flat"], params, _world(mesh)[1])
        return params, (mu["flat"], nu["flat"], count)

    def from_table(grads, state, params, row):
        with torch.no_grad():
            g, inner_state, p = sliced(grads, state, params)
            inner.from_table(g, inner_state, p, row)
            gather(p["flat"], params, _world(mesh)[1])
        return params, state

    update.hyper = inner.hyper
    update.from_table = from_table
    return init, update


def make_preprocess(cfg: ViTConfig, mean, std, native_size: int,
                    augment: bool = False):
    """uint8 [B, h, w, C] -> normalized float32 [B, img, img, C], for images
    at the dataset's native size or already at the model's size.

    The resize is what jax.image.resize(..., "bilinear") computes: bilinear
    with half-pixel centers (align_corners=False), its triangle filter
    widened by the scale when it shrinks (antialias=True). When it enlarges
    the filter is plain bilinear interpolation, which the call without
    antialiasing computes in fewer roundings (antialias=True differs there
    by up to ~1e-6, enough to flip bf16 roundings in the kernels).

    augment=True adds a random horizontal flip and a 4px pad-and-crop after
    the resize, drawn from the generator that preprocess(images, generator)
    is given (train steps; without one, as in evaluation, nothing is
    drawn). Off by default: the reference trains without augmentation."""
    del native_size  # the resize follows each batch's own size
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)
    on_device = {}  # (mean, std) per device: no host copy inside a step

    def preprocess(images_u8, generator=None):
        x = images_u8.float() / 255.0
        if images_u8.shape[1] != cfg.img_size:
            x = F.interpolate(x.permute(0, 3, 1, 2),
                              size=(cfg.img_size, cfg.img_size),
                              mode="bilinear", align_corners=False,
                              antialias=images_u8.shape[1] > cfg.img_size)
            x = x.permute(0, 2, 3, 1)
        if augment and generator is not None:
            x = augment_apply(x, *augment_draws(generator, x.shape[0]))
        if x.device not in on_device:
            on_device[x.device] = (mean.to(x.device), std.to(x.device))
        mean_d, std_d = on_device[x.device]
        return (x - mean_d) / std_d

    preprocess.augment = augment
    return preprocess


AUGMENT_PAD = 4  # pixels of edge padding before the random crop


def augment_draws(generator, batch: int, pad: int = AUGMENT_PAD):
    """The random part of the augmentation, on the generator's device:
    (flip [B] bool, oy [B], ox [B] int64 crop offsets in [0, 2·pad])."""
    device = generator.device
    flip = torch.rand(batch, generator=generator, device=device) < 0.5
    oy = torch.randint(0, 2 * pad + 1, (batch,), generator=generator,
                       device=device)
    ox = torch.randint(0, 2 * pad + 1, (batch,), generator=generator,
                       device=device)
    return flip, oy, ox


def augment_apply(x, flip, oy, ox, pad: int = AUGMENT_PAD):
    """Batched flip + edge pad + crop of x [B, H, W, C]: where flip[b],
    image b is mirrored left-right; then each image is edge-padded by `pad`
    and cropped back to H x W at rows oy[b].., columns ox[b].. (the JAX
    package's _augment on given draws)."""
    b, hgt, wid, _ = x.shape
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="replicate").permute(0, 2, 3, 1)
    rows = oy[:, None] + torch.arange(hgt, device=x.device)  # [B, H]
    cols = ox[:, None] + torch.arange(wid, device=x.device)  # [B, W]
    batch = torch.arange(b, device=x.device)[:, None, None]
    return xp[batch, rows[:, :, None], cols[:, None, :]]


def step_generators(seed: int, epoch: int, row: int, device, rank: int = 0,
                    model_rank: int | None = None):
    """(augmentation generator, dropout generator) of one train row on
    `device`, seeded from (seed, epoch, row): the same row of the same
    epoch draws the same, other rows and epochs draw otherwise. A data rank
    r > 0 folds r into the seed (the JAX step folds its axis_index), so
    each rank draws for its own columns; rank 0 draws as one device does.

    model_rank (tensor parallelism): the dropout generator is a pair
    (shared, local) for parallel.tensor_parallel.apply_tp. The
    augmentation and `shared` are the data rank's, the same on every model
    rank; `local` is spawned from them with the model rank folded in (the
    JAX fold_in of the model index), for the masks on a rank's own heads
    and MLP rows."""
    entropy = [seed, epoch, row] + ([rank] if rank else [])
    seeds = list(np.random.SeedSequence(entropy).generate_state(
        2, dtype=np.uint64))
    if model_rank is not None:
        seeds += list(np.random.SeedSequence(
            entropy, spawn_key=(model_rank,)).generate_state(
                1, dtype=np.uint64))
    gens = tuple(torch.Generator(device=device).manual_seed(
        int(s) & ((1 << 63) - 1)) for s in seeds)
    return gens if model_rank is None else (gens[0], gens[1:])


def _columns(mesh, batch: int):
    """This data rank's columns of a batch of `batch`: [r·b, (r+1)·b) with
    b = batch / world (the JAX P(None, DATA_AXIS)); all of them without a
    process group."""
    if mesh is None or not mesh.distributed:
        return slice(None)
    b = batch // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def _real_count(rows):
    """The real examples (index >= 0) of whole index rows, as float32: the
    global count, which every rank can read from the rows it holds (the
    JAX step psums its shards' masks)."""
    return (rows >= 0).sum().float()


_LAYOUTS: dict = {}


def flat_layout(params: dict, cfg: ViTConfig) -> Flattener:
    """A Flattener over the reference-keyed params whose flat vector is the
    one of the optimizer moments on disk (train/loop.moment_flattener, the
    JAX package's flat vector of its depth-stacked params): the non-block
    keys sorted (JAX rebuilds dicts with sorted keys), then each block
    parameter over the depth. The gradient all-reduce and ZeRO-1's slices
    use it; cached per key set and shapes."""
    key = (cfg.depth, *((k, tuple(v.shape)) for k, v in params.items()))
    if key not in _LAYOUTS:
        order = sorted(k for k in params if not k.startswith("blocks."))
        order += [f"blocks.{i}.{name}" for name in vit.BLOCK_PARAM_NAMES
                  for i in range(cfg.depth)]
        _LAYOUTS[key] = Flattener({k: params[k] for k in order})
    return _LAYOUTS[key]


def _gather_batch(data_x, data_y, idx):
    """Masked gather: idx == -1 marks padding of the final partial batch."""
    mask = (idx >= 0).float()
    safe = idx.clamp(min=0)
    return data_x[safe], data_y[safe], mask


def _fetch_batch_ordered(data_x, data_y, idx, row):
    """A batch of EPOCH-ORDERED buffers (epoch_order_data): one contiguous
    slice at row·batch instead of a gather by index; idx, the row of the
    index matrix, is the padding mask's source only (the JAX package's
    fetch on one data shard)."""
    mask = (idx >= 0).float()
    b = idx.shape[0]
    return data_x[row * b:(row + 1) * b], data_y[row * b:(row + 1) * b], mask


def epoch_order_data(data_x, data_y, epoch_idx):
    """One epoch's batches laid out contiguously, in the order of the
    [steps, batch] index matrix: one gather per epoch, after which each
    step's batch is a slice (_fetch_batch_ordered). Padded entries (-1)
    take example 0, as _gather_batch does, and stay masked by the index
    matrix, so the steps see what the gather feed gives them."""
    perm = epoch_idx.reshape(-1).clamp(min=0)
    return data_x[perm], data_y[perm]


def _make_fetch(feed: str):
    """feed "gather" -> None (the masked gather by index, _gather_batch);
    "ordered" -> _fetch_batch_ordered, over data passed through
    epoch_order_data for the current index matrix."""
    if feed == "gather":
        return None
    if feed == "ordered":
        return _fetch_batch_ordered
    raise ValueError(f"unknown feed mode: {feed!r}")


def pick_steps_per_dispatch(steps_per_epoch: int, cap: int = 32) -> int:
    """Largest divisor of steps_per_epoch <= cap: a dispatch of that many
    steps needs no padded no-op steps."""
    best = 1
    for k in range(2, min(cap, steps_per_epoch) + 1):
        if steps_per_epoch % k == 0:
            best = k
    return best


def _loss_and_metrics(params, imgs, labels, mask, cfg, preprocess,
                      apply_fn=None, generators=None):
    """(sum over real examples of the cross-entropy, count of correct
    argmax predictions among them). generators: the train row's
    (augmentation, dropout) pair of step_generators; None in evaluation."""
    apply_fn = apply_fn or vit.apply
    if generators is None:
        logits = apply_fn(params, preprocess(imgs), cfg)
    else:
        aug_gen, drop_gen = generators
        logits = apply_fn(params, preprocess(imgs, aug_gen), cfg,
                          drop_gen if cfg.has_dropout else None)
    losses = F.cross_entropy(logits, labels.long(), reduction="none")
    loss_sum = (losses * mask).sum()
    correct = ((logits.argmax(dim=-1) == labels).float() * mask).sum()
    return loss_sum, correct


def _grads_and_metrics(params, cfg, preprocess, batches, count=None,
                       mesh=None, apply_fn=None):
    """One optimizer step's gradients over its rows. batches: one (imgs,
    labels, mask, generators) per row (generators: the row's pair of
    step_generators, or None where the step draws nothing); count: the
    real-example count of the step's whole rows (None: the masks' sum). One
    row: the gradient of the loss sum divided by the count (the batch-mean
    loss); more: raw gradients of the per-row loss sums, summed and divided
    by the count, which equals one step on the concatenated batch.

    mesh: a process group's mesh (the JAX _dp_step; None: one device, no
    collective): batches hold this rank's columns and count is the global
    count; _reduce_over_mesh sums the gradients and metrics before the
    division: the full batch's step. apply_fn: the forward (default
    models.vit.apply; tensor_parallel.apply_tp on a model axis). Returns
    (grads dict, metrics [loss, correct, count])."""
    keys = list(params.values())
    if count is None:
        count = sum(mask.sum() for _, _, mask, _ in batches)
    safe_count = count.clamp(min=1.0)
    if len(batches) == 1:
        imgs, labels, mask, gens = batches[0]
        loss_sum, correct = _loss_and_metrics(params, imgs, labels, mask, cfg,
                                              preprocess, apply_fn, gens)
        loss = loss_sum / safe_count
        grads = list(torch.autograd.grad(loss, keys))
        loss = loss.detach()
    else:
        grads, loss, correct = None, 0.0, 0.0
        for imgs, labels, mask, gens in batches:
            ls, cor = _loss_and_metrics(params, imgs, labels, mask, cfg,
                                        preprocess, apply_fn, gens)
            g = torch.autograd.grad(ls, keys)
            grads = g if grads is None else [x + y for x, y in zip(grads, g)]
            loss = loss + ls.detach()
            correct = correct + cor
    divisor = safe_count if len(batches) > 1 else None
    if mesh is not None and mesh.distributed:
        grads, loss, correct = _reduce_over_mesh(params, cfg, mesh, grads,
                                                 loss, correct, divisor)
    elif divisor is not None:
        grads = [g / divisor for g in grads]
    if divisor is not None:
        loss = loss / divisor
    return (dict(zip(params, grads)),
            torch.stack([loss, correct, count]))


def _reduce_over_mesh(params, cfg, mesh, grads, loss, correct, divisor):
    """The gradient sums of one step over a process group's mesh, then the
    division by `divisor` (None: none): the JAX reduce_grads.

    Over the data and sequence axes (skipped for a model axis of one data
    row and no sequence axis): the gradients, the loss and the correct
    count go into ONE flat vector (flat_layout's order of the rank's
    params, then the two metrics), summed over Mesh.data_group (the rank's
    model column; the whole group under context parallelism alone) by one
    all_reduce. Under a sequence axis every rank's gradients are partial
    over the ring, and the metrics, which every rank of a ring holds
    alike, count on its first rank only (_ring_metrics). Over the model
    axis (tensor parallelism, and TP x CP): the per-head PE params'
    gradients (tensor_parallel.model_sync_keys) are summed over the rank's
    model row by one small all_reduce; the sharded params' gradients are
    local, the replicated ones' identical on every model rank. Returns
    (grads list in params' order, loss, correct)."""
    if pipeline_parallel.has_pipe_axis(mesh):
        return _reduce_over_pipe(params, cfg, mesh, grads, loss, correct,
                                 divisor)
    by_key = dict(zip(params, grads))
    flat = layout = None
    if mesh.model_parallel == 1 or mesh.size * mesh.seq_parallel > 1:
        layout = flat_layout(params, cfg)
        flat = torch.cat([by_key[k].reshape(-1) for k in layout.keys]
                         + [_ring_metrics(mesh, torch.stack([loss,
                                                             correct]))])
        mesh.sum_over_data(flat)
        loss, correct = flat[layout.total], flat[layout.total + 1]
        by_key = layout.unflatten(flat[:layout.total])
    sync = (tensor_parallel.model_sync_keys(params, cfg)
            if mesh.model_parallel > 1 else [])
    if sync:
        pe = torch.cat([by_key[k].reshape(-1) for k in sync])
        distributed.all_reduce_sum(pe, mesh.model_group)
        pieces = pe.split([by_key[k].numel() for k in sync])
        torch._foreach_copy_([by_key[k] for k in sync],
                             [p.view_as(by_key[k])
                              for k, p in zip(sync, pieces)])
    if divisor is None:
        return [by_key[k] for k in params], loss, correct
    if flat is not None:
        flat[:layout.total].div_(divisor)
        return [by_key[k] for k in params], loss, correct
    return [by_key[k] / divisor for k in params], loss, correct


def _reduce_over_pipe(params, cfg, mesh, grads, loss, correct, divisor):
    """_reduce_over_mesh on a mesh with a pipe axis (the JAX
    make_pp_train_step's, make_pp_tp_train_step's and
    make_pp_tp_cp_train_step's reduce_grads), in three all_reduces, each
    of one flat vector in params' order: the block params' gradients
    (local to the rank's stage and model shard) with the loss and the
    correct count over the data and sequence axes (Mesh.data_group: every
    stage holds the same logits, so the data ranks of one stage count each
    example once, and under a sequence axis the ring's first rank alone,
    _ring_metrics); the replicated params' (partial per stage) over the
    stages, the data and the sequence axes (Mesh.replica_group); under a
    model axis the per-head PE params' (tensor_parallel.model_sync_keys,
    partial over the stages and the model axis too) over every rank.
    Every rank of a group ends with the same sums."""
    by_key = dict(zip(params, grads))
    sync = (tensor_parallel.model_sync_keys(params, cfg)
            if mesh.model_parallel > 1 else [])
    blocks = [k for k in params if k.startswith(pipeline_parallel.BLOCKS)]
    rest = [k for k in params
            if not k.startswith(pipeline_parallel.BLOCKS) and k not in sync]
    metrics = _ring_metrics(mesh, torch.stack([loss, correct]))
    for keys, group, extra in ((blocks, mesh.data_group, metrics),
                               (rest, mesh.replica_group, None),
                               (sync, None, None)):
        parts = [by_key[k].reshape(-1) for k in keys]
        if extra is not None:
            parts.append(extra)
        if not parts:
            continue
        flat = distributed.all_reduce_sum(torch.cat(parts), group)
        if extra is not None:
            loss, correct = flat[-2], flat[-1]
        if divisor is not None:
            flat = flat / divisor
        pieces = flat.split([by_key[k].numel() for k in keys]
                            + ([2] if extra is not None else []))
        by_key.update({k: piece.view_as(by_key[k])
                       for k, piece in zip(keys, pieces)})
    return [by_key[k] for k in params], loss, correct


def _ring_metrics(mesh, metrics):
    """metrics as they go into a sum over a context-parallel mesh's whole
    group: the ring's first rank's, zeros on the others (every rank of a
    ring holds the same logits, so the sum counts each data rank once,
    exactly); as they are on any other mesh."""
    if mesh.seq_parallel > 1 and mesh.seq_rank > 0:
        return torch.zeros_like(metrics)
    return metrics


def _cp_forward(mesh):
    """The forward over `mesh`'s sequence axis: this rank's token shard
    through parallel.context_parallel.apply_cp, with a model axis too its
    heads' share (the TP x CP forward; no dropout under context
    parallelism)."""

    def apply_cp(params, images, cfg, generator=None):
        del generator
        return context_parallel.apply_cp(params, images, cfg, mesh)

    return apply_cp


def _pp_forward(mesh, n_micro: int):
    """The forward over `mesh`'s pipe axis: this rank's stage of the GPipe
    schedule at n_micro microbatches (0: the stage count), with the heads
    of its model shard under a model axis and the ring over its token
    shard under a sequence axis (no dropout under pipeline
    parallelism)."""
    if mesh.seq_parallel > 1:
        fwd = pp_tp_cp.apply_pp_tp_cp
    elif mesh.model_parallel > 1:
        fwd = pp_tp.apply_pp_tp
    else:
        fwd = pipeline_parallel.apply_pp
    n_micro = n_micro or mesh.pipe_parallel

    def apply_pp(params, images, cfg, generator=None):
        del generator
        return fwd(params, images, cfg, mesh, n_micro)

    return apply_pp


def _mesh_forward(mesh, n_micro: int = 0):
    """(apply_fn, model_rank) of a train step over `mesh`: the PP forward
    (_pp_forward, with the ring under a sequence axis) and None over a
    pipe axis; the CP or TP x CP forward (_cp_forward) and None over a
    sequence axis; the TP forward and this rank's model position over a
    model axis; or (None, None) without any (models.vit.apply, two
    generators a row)."""
    if pipeline_parallel.has_pipe_axis(mesh):
        return _pp_forward(mesh, n_micro), None
    if mesh is not None and mesh.seq_parallel > 1:
        return _cp_forward(mesh), None
    if mesh is None or mesh.model_parallel == 1:
        return None, None

    def apply_fn(params, images, cfg, generator=None):
        return tensor_parallel.apply_tp(params, images, cfg, mesh, generator)

    return apply_fn, mesh.model_rank


def _step_batches(data_x, data_y, epoch_idx, rows, mesh, generators):
    """The (imgs, labels, mask, generators) of each index row in `rows`,
    this rank's columns only (_columns), gathered by index."""
    cols = _columns(mesh, epoch_idx.shape[1])
    return [(*_gather_batch(data_x, data_y, epoch_idx[r][cols]),
             generators(r)) for r in rows]


def make_train_step(cfg: ViTConfig, update, preprocess, accum: int = 1,
                    seed: int = 0, mesh=None, n_micro: int = 0):
    """Returns train_step(params, opt_state, row, data_x, data_y, epoch_idx,
    epoch=0) -> (params, opt_state, metrics [loss, correct, count]) for the
    optimizer `update` of make_optimizer. Row `row` of the [steps, batch]
    index matrix is the batch; accum > 1 consumes rows row..row+accum-1 as
    one optimizer step (_grads_and_metrics). Each row draws its augmentation
    and dropout from step_generators(seed, epoch, row). Params are leaf
    tensors that require grad; update changes them in place.

    mesh: a process group's mesh (parallel.mesh.make_mesh): each data rank
    takes its columns of the rows, and the step's gradients and metrics are
    summed over the data ranks by one all_reduce (_reduce_over_mesh); every
    rank then applies the same update. With a model axis (the JAX
    make_tp_train_step) params are the rank's local shard
    (parallel.tensor_parallel.shard_params), the forward is
    tensor_parallel.apply_tp, and the per-head PE params' gradients are
    also summed over the model axis. With a sequence axis (the JAX
    make_cp_train_step) params are replicated, the forward is
    context_parallel.apply_cp on this rank's token shard, and the
    gradients are summed over every rank. With a pipe axis (the JAX
    make_pp_train_step, and make_pp_tp_train_step with a model axis too)
    params are the rank's stage (and model shard) of the depth-stacked
    layout (parallel.pipeline_parallel.shard_reference), the forward is
    its GPipe schedule at n_micro microbatches (0: the stage count), and
    the gradients are summed as _reduce_over_pipe says. With a sequence
    and a model axis (the JAX make_tp_cp_train_step) params are the
    rank's tensor-parallel shard, the forward is context_parallel.apply_cp
    on its token shard and heads, and the gradients are summed over the
    data and sequence axes, the per-head PE params' over the model axis
    too; with a pipe and a sequence axis (make_pp_tp_cp_train_step) the
    forward is parallel.pp_tp_cp.apply_pp_tp_cp. None: one device, no
    collective."""
    dp = mesh is not None and mesh.distributed
    apply_fn, model_rank = _mesh_forward(mesh, n_micro)

    def train_step(params, opt_state, row, data_x, data_y, epoch_idx,
                   epoch=0):
        rank = mesh.rank if dp else 0
        rows = range(row, row + accum)
        batches = _step_batches(
            data_x, data_y, epoch_idx, rows, mesh,
            lambda r: step_generators(seed, epoch, r, data_x.device, rank,
                                      model_rank))
        count = _real_count(epoch_idx[row:row + accum]) if dp else None
        grads, metrics = _grads_and_metrics(params, cfg, preprocess, batches,
                                            count, mesh if dp else None,
                                            apply_fn)
        params, opt_state = update(grads, opt_state, params)
        return params, opt_state, metrics

    return train_step


def make_train_multi_step(cfg: ViTConfig, update, preprocess, k: int,
                          accum: int = 1, seed: int = 0,
                          feed: str = "ordered", mesh=None,
                          n_micro: int = 0):
    """k optimizer steps per call: fn(params, opt_state, row, data_x,
    data_y, epoch_idx, epoch=0) -> (params, opt_state, metrics [k, 3]),
    each step taking `accum` index rows (rows row .. row + k·accum - 1;
    epoch_idx padded to a multiple of k·accum with pad_epoch_indices).
    feed "ordered": data_x, data_y are the epoch's ordered buffers
    (epoch_order_data); "gather": the staged dataset. A step whose rows are
    all padding is a no-op: it reports count 0 and leaves params, both
    moments and the AdamW count as they were, so the k-step driver follows
    the per-step driver's trajectory.

    On CUDA tensors the k steps are captured once, on the first call, into
    a torch.cuda.CUDAGraph, and every call replays it: before the replay,
    one device-to-device copy each fills static buffers with the call's
    k·accum batches (images, labels, index rows), and one copy the k rows
    of (lr, c1, c2, live) that the AdamW kernel's device-table entry reads
    (`update` is make_optimizer's, with .hyper and .from_table); the host
    advances the AdamW count by the live steps. The first call first runs
    one step, marked not live, on a side stream (it builds the AdamW
    table and what each kernel sets up once), then captures; a capture
    that fails raises. Launch counts (ops/launches) count the replays.
    fn.capture_seconds holds the warm-up and capture time.

    The same k steps run eagerly on CPU tensors (the graph's plain
    version), and on CUDA tensors where a step draws random numbers
    (dropout, drop-path, augmentation: the per-row generators of
    step_generators cannot be captured) or the NaN sanitizer is on (it
    reads values on the host); the first eager call on CUDA says so on
    stdout.

    mesh: a process group's mesh, as make_train_step's: each step takes this
    rank's columns of its rows and sums its gradients over the ranks (and
    runs the TP, CP or PP forward on a model, sequence or pipe axis; the
    PP one at n_micro microbatches). Then the k steps run eagerly on
    every device (gloo's collectives cannot be captured in a CUDA graph,
    and a multi-rank NCCL capture has not been verified), which the first
    call says on stdout."""
    fetch = _make_fetch(feed)
    dp = mesh is not None and mesh.distributed
    apply_fn, model_rank = _mesh_forward(mesh, n_micro)
    stride = k * accum
    draws = cfg.has_dropout or getattr(preprocess, "augment", False)
    live_rows = {"idx": None, "rows": None}  # host copy, once per epoch
    graph = {}

    def stage(data_x, data_y, epoch_idx, row):
        """(images, labels, index rows) of rows row .. row + stride - 1."""
        idx = epoch_idx[row:row + stride]
        if fetch is None:
            flat = idx.reshape(-1).clamp(min=0)
            return data_x[flat], data_y[flat], idx
        b = idx.shape[1]
        return (data_x[row * b:(row + stride) * b],
                data_y[row * b:(row + stride) * b], idx)

    def live(epoch_idx, row):
        if live_rows["idx"] is not epoch_idx:
            live_rows["idx"] = epoch_idx
            live_rows["rows"] = (epoch_idx >= 0).any(dim=1).tolist()
        rows = live_rows["rows"]
        return [any(rows[row + j * accum:row + (j + 1) * accum])
                for j in range(k)]

    def steps(params, opt_state, x, y, idx, step_update, gens=None, n=k):
        """n steps on staged rows; step_update(j, grads, state, params)."""
        metrics = []
        cols = _columns(mesh, idx.shape[1])
        for j in range(n):
            batches = []
            for a in range(accum):
                r = j * accum + a
                imgs, labels, mask = _fetch_batch_ordered(x, y, idx[r], r)
                batches.append((imgs[cols], labels[cols], mask[cols],
                                gens(r) if gens else None))
            count = (_real_count(idx[j * accum:(j + 1) * accum]) if dp
                     else None)
            grads, m = _grads_and_metrics(params, cfg, preprocess, batches,
                                          count, mesh if dp else None,
                                          apply_fn)
            params, opt_state = step_update(j, grads, opt_state, params)
            metrics.append(m)
        return params, opt_state, torch.stack(metrics)

    def eager(params, opt_state, row, data_x, data_y, epoch_idx, epoch):
        x, y, idx = stage(data_x, data_y, epoch_idx, row)
        is_live = live(epoch_idx, row)
        gens = None
        if draws:
            rank = mesh.rank if dp else 0

            def gens(r):
                return step_generators(seed, epoch, row + r, x.device, rank,
                                       model_rank)

        def step_update(j, grads, state, p):
            return update(grads, state, p) if is_live[j] else (p, state)

        return steps(params, opt_state, x, y, idx, step_update, gens)

    def table_update(j, grads, state, p):
        return update.from_table(grads, state, p, graph["hyper"][j])

    def capture(params, opt_state, x, y, idx):
        t0 = time.perf_counter()
        device = x.device
        graph.update(x=x.clone(), y=y.clone(), idx=idx.clone(),
                     hyper=hyper_rows([(0.0, 1.0, 1.0, 0.0)] * k, device))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # one step, its row not live
            steps(params, opt_state, graph["x"], graph["y"], graph["idx"],
                  table_update, n=1)
        torch.cuda.current_stream(device).wait_stream(side)
        before = launches.counts()
        g = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(g):
                _, _, metrics = steps(params, opt_state, graph["x"],
                                      graph["y"], graph["idx"], table_update)
        except Exception as e:
            raise RuntimeError(f"capturing {k} train steps in a CUDA graph "
                               f"failed: {e}") from e
        captured = launches.since(before)
        launches.add(captured, -1)  # recorded, not run
        graph.update(graph=g, metrics=metrics, launches=captured,
                     params=[p.data_ptr() for p in params.values()])
        fn.capture_seconds = time.perf_counter() - t0

    def replay(params, opt_state, row, data_x, data_y, epoch_idx):
        x, y, idx = stage(data_x, data_y, epoch_idx, row)
        mu, nu, count = opt_state
        rows = []
        for is_live in live(epoch_idx, row):
            if is_live:
                count += 1
                rows.append((*update.hyper(count), 1.0))
            else:
                rows.append((0.0, 1.0, 1.0, 0.0))
        if "graph" not in graph:
            capture(params, opt_state, x, y, idx)
        elif graph["params"] != [p.data_ptr() for p in params.values()]:
            raise ValueError("the k-step graph was captured on other "
                             "parameter storages")
        graph["x"].copy_(x)
        graph["y"].copy_(y)
        graph["idx"].copy_(idx)
        graph["hyper"].copy_(hyper_rows(rows, "cpu").pin_memory(),
                             non_blocking=True)
        graph["graph"].replay()
        launches.add(graph["launches"])
        return params, (mu, nu, count), graph["metrics"].clone()

    told = []

    def fn(params, opt_state, row, data_x, data_y, epoch_idx, epoch=0):
        if data_x.device.type == "cpu":
            return eager(params, opt_state, row, data_x, data_y, epoch_idx,
                         epoch)
        if dp or draws or nan_check.ACTIVE:
            if not told:
                told.append(True)
                axes = _axes(mesh)
                why = (f"the steps sum their gradients over a process group "
                       f"({axes} parallelism)" if dp else
                       "the train steps draw random numbers (dropout, "
                       "drop-path or augmentation)" if draws else
                       "the NaN sanitizer reads values on the host")
                print(f"steps_per_dispatch {k}: {why}, so the {k} steps of "
                      f"a dispatch run eagerly, without a CUDA graph")
            return eager(params, opt_state, row, data_x, data_y, epoch_idx,
                         epoch)
        return replay(params, opt_state, row, data_x, data_y, epoch_idx)

    fn.capture_seconds = None
    return fn


def _axes(mesh) -> str:
    """The parallelism a process group's mesh runs, in words."""
    names = ["data"] + [name for name, width in (
        ("pipeline", mesh.pipe_parallel), ("context", mesh.seq_parallel),
        ("tensor", mesh.model_parallel)) if width > 1]
    return (names[0] if len(names) == 1
            else ", ".join(names[:-1]) + " and " + names[-1])


def make_eval_step(cfg: ViTConfig, preprocess, mesh=None, n_micro: int = 0):
    """Returns eval_step(params, row, data_x, data_y, epoch_idx) -> metrics
    [loss, correct, count] of that index row (a fully padded row reports
    count 0 and loss 0). mesh: a process group's mesh: each data rank
    evaluates its columns and the loss and correct sums are summed over the
    data ranks (one all_reduce; the count is the whole row's), as the JAX
    eval step psums them. Under tensor parallelism it takes the whole
    (gathered) params, which every model rank evaluates alike, and so under
    pipeline parallelism does every stage (the sums over Mesh.data_group
    count each data rank once). Under context parallelism every rank of a
    ring evaluates its token shard with the train step's forward
    (_mesh_forward: context_parallel.apply_cp, the JAX eval step's
    apply_fn; under the compositions the composed forward, n_micro
    microbatches under a pipe axis) on the rank's train params (the
    replicated params themselves under context parallelism alone): the
    sums run over Mesh.data_group (the whole group without a model or pipe
    axis), each ring's metrics counted once."""
    dp = mesh is not None and mesh.distributed
    apply_fn = (_mesh_forward(mesh, n_micro)[0]
                if dp and mesh.seq_parallel > 1 else None)

    def eval_step(params, row, data_x, data_y, epoch_idx):
        with torch.no_grad():
            cols = _columns(mesh, epoch_idx.shape[1])
            imgs, labels, mask = _gather_batch(data_x, data_y,
                                               epoch_idx[row][cols])
            loss_sum, correct = _loss_and_metrics(params, imgs, labels, mask,
                                                  cfg, preprocess, apply_fn)
            if dp:
                count = _real_count(epoch_idx[row])
                loss_sum, correct = mesh.sum_over_data(_ring_metrics(
                    mesh, torch.stack([loss_sum, correct])))
            else:
                count = mask.sum()
            return torch.stack([loss_sum / count.clamp(min=1.0), correct,
                                count])

    return eval_step


def pad_epoch_indices(epoch_idx, k: int):
    """Pad the [steps, batch] index matrix with -1 rows to a multiple of k."""
    pad = (-epoch_idx.shape[0]) % k
    if pad == 0:
        return epoch_idx
    filler = torch.full((pad, epoch_idx.shape[1]), -1, dtype=epoch_idx.dtype,
                        device=epoch_idx.device)
    return torch.cat([epoch_idx, filler])


def epoch_indices(n_examples: int, batch_size: int, shuffle: bool,
                  seed: int = 0, epoch: int = 0):
    """[steps, batch_size] int64 index matrix covering all examples once;
    final partial batch padded with -1 (masked). shuffle draws the
    permutation from a torch.Generator seeded from (seed, epoch)."""
    steps = -(-n_examples // batch_size)
    if shuffle:
        gen = torch.Generator().manual_seed(
            (seed * 1_000_003 + epoch) % (1 << 63))
        perm = torch.randperm(n_examples, generator=gen)
    else:
        perm = torch.arange(n_examples)
    pad = steps * batch_size - n_examples
    perm = torch.cat([perm, torch.full((pad,), -1, dtype=perm.dtype)])
    return perm.reshape(steps, batch_size)
