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

The JAX package shuffles, augments and drops out with jax.random, which the
port cannot reproduce without jax: epoch_indices shuffles with a
torch.Generator seeded from (seed, epoch), and the per-row draws come from
torch.Generators — differences by design (tests inject one index matrix
into both packages, and replay one package's draws in the other).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig, cosine_lr_by_epoch
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops.fused_adamw import make_fused_adamw


def make_optimizer(tcfg: TrainConfig, steps_per_epoch: int, template: dict):
    """(init, update) of the fused AdamW over the params dict `template`."""
    schedule = cosine_lr_by_epoch(tcfg.lr, tcfg.epochs, steps_per_epoch)
    return make_fused_adamw(template, schedule, b1=0.9, b2=0.999, eps=1e-8,
                            weight_decay=tcfg.weight_decay)


def make_preprocess(cfg: ViTConfig, mean, std, native_size: int,
                    augment: bool = False):
    """uint8 [B, h, w, C] -> normalized float32 [B, img, img, C], for images
    at the dataset's native size or already at the model's size.

    Upsampling is bilinear with half-pixel centers (align_corners=False),
    which is what jax.image.resize(..., "bilinear") computes when it
    enlarges. Shrinking is refused: jax.image.resize antialiases when it
    shrinks, and that filter is not ported.

    augment=True adds a random horizontal flip and a 4px pad-and-crop after
    the resize, drawn from the generator that preprocess(images, generator)
    is given (train steps; without one, as in evaluation, nothing is
    drawn). Off by default: the reference trains without augmentation."""
    def refuse_downsampling(size):
        if cfg.img_size < size:
            raise NotImplementedError(
                f"img_size {cfg.img_size} < image size {size}: "
                f"antialiased downsampling is not ported")

    refuse_downsampling(native_size)
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)

    def preprocess(images_u8, generator=None):
        refuse_downsampling(images_u8.shape[1])
        x = images_u8.float() / 255.0
        if images_u8.shape[1] != cfg.img_size:
            x = F.interpolate(x.permute(0, 3, 1, 2),
                              size=(cfg.img_size, cfg.img_size),
                              mode="bilinear", align_corners=False)
            x = x.permute(0, 2, 3, 1)
        if augment and generator is not None:
            x = augment_apply(x, *augment_draws(generator, x.shape[0]))
        return (x - mean.to(x.device)) / std.to(x.device)

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


def step_generators(seed: int, epoch: int, row: int, device):
    """(augmentation generator, dropout generator) of one train row on
    `device`, seeded from (seed, epoch, row): the same row of the same
    epoch draws the same, other rows and epochs draw otherwise."""
    seeds = np.random.SeedSequence([seed, epoch, row]).generate_state(
        2, dtype=np.uint64)
    return tuple(torch.Generator(device=device).manual_seed(
        int(s) & ((1 << 63) - 1)) for s in seeds)


def _gather_batch(data_x, data_y, idx):
    """Masked gather: idx == -1 marks padding of the final partial batch."""
    mask = (idx >= 0).float()
    safe = idx.clamp(min=0)
    return data_x[safe], data_y[safe], mask


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


def make_train_step(cfg: ViTConfig, update, preprocess, accum: int = 1,
                    seed: int = 0):
    """Returns train_step(params, opt_state, row, data_x, data_y, epoch_idx,
    epoch=0) -> (params, opt_state, metrics [loss, correct, count]) for the
    optimizer `update` of make_optimizer. Row `row` of the [steps, batch]
    index matrix is the batch; accum > 1 consumes rows row..row+accum-1 as
    one optimizer step: raw gradients of the per-row loss sums are summed
    and divided by the total real-example count, which equals one step on
    the concatenated batch. Each row draws its augmentation and dropout from
    step_generators(seed, epoch, row). Params are leaf tensors that require
    grad; update changes them in place."""

    def row_loss(params, row, data_x, data_y, epoch_idx, epoch):
        imgs, labels, mask = _gather_batch(data_x, data_y, epoch_idx[row])
        loss_sum, correct = _loss_and_metrics(
            params, imgs, labels, mask, cfg, preprocess,
            generators=step_generators(seed, epoch, row, data_x.device))
        return loss_sum, correct, mask.sum()

    def train_step(params, opt_state, row, data_x, data_y, epoch_idx,
                   epoch=0):
        if accum == 1:
            loss_sum, correct, count = row_loss(params, row, data_x, data_y,
                                                epoch_idx, epoch)
            loss = loss_sum / count.clamp(min=1.0)
            grads = torch.autograd.grad(loss, list(params.values()))
        else:
            grads, loss_sum, correct, count = None, 0.0, 0.0, 0.0
            for a in range(accum):
                ls, cor, cnt = row_loss(params, row + a, data_x, data_y,
                                        epoch_idx, epoch)
                g = torch.autograd.grad(ls, list(params.values()))
                grads = g if grads is None else [x + y for x, y in zip(grads, g)]
                loss_sum = loss_sum + ls.detach()
                correct = correct + cor
                count = count + cnt
            safe_count = count.clamp(min=1.0)
            grads = [g / safe_count for g in grads]
            loss = loss_sum / safe_count
        params, opt_state = update(dict(zip(params, grads)), opt_state, params)
        return params, opt_state, torch.stack([loss.detach(), correct, count])

    return train_step


def make_eval_step(cfg: ViTConfig, preprocess):
    """Returns eval_step(params, row, data_x, data_y, epoch_idx) -> metrics
    [loss, correct, count] of that index row (a fully padded row reports
    count 0 and loss 0)."""

    def eval_step(params, row, data_x, data_y, epoch_idx):
        with torch.no_grad():
            imgs, labels, mask = _gather_batch(data_x, data_y, epoch_idx[row])
            loss_sum, correct = _loss_and_metrics(params, imgs, labels, mask,
                                                  cfg, preprocess)
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
