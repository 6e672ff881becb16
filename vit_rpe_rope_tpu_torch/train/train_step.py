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

The JAX package shuffles with jax.random.permutation, which the port cannot
reproduce without jax: epoch_indices shuffles with a torch.Generator seeded
from (seed, epoch) instead — a difference by design (tests inject one index
matrix into both packages). Augmentation is not ported.
"""

from __future__ import annotations

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


def make_preprocess(cfg: ViTConfig, mean, std, native_size: int):
    """uint8 [B, h, w, C] -> normalized float32 [B, img, img, C], for images
    at the dataset's native size or already at the model's size.

    Upsampling is bilinear with half-pixel centers (align_corners=False),
    which is what jax.image.resize(..., "bilinear") computes when it
    enlarges. Shrinking is refused: jax.image.resize antialiases when it
    shrinks, and that filter is not ported."""
    def refuse_downsampling(size):
        if cfg.img_size < size:
            raise NotImplementedError(
                f"img_size {cfg.img_size} < image size {size}: "
                f"antialiased downsampling is not ported")

    refuse_downsampling(native_size)
    mean = torch.as_tensor(mean, dtype=torch.float32)
    std = torch.as_tensor(std, dtype=torch.float32)

    def preprocess(images_u8):
        refuse_downsampling(images_u8.shape[1])
        x = images_u8.float() / 255.0
        if images_u8.shape[1] != cfg.img_size:
            x = F.interpolate(x.permute(0, 3, 1, 2),
                              size=(cfg.img_size, cfg.img_size),
                              mode="bilinear", align_corners=False)
            x = x.permute(0, 2, 3, 1)
        return (x - mean.to(x.device)) / std.to(x.device)

    return preprocess


def _gather_batch(data_x, data_y, idx):
    """Masked gather: idx == -1 marks padding of the final partial batch."""
    mask = (idx >= 0).float()
    safe = idx.clamp(min=0)
    return data_x[safe], data_y[safe], mask


def _loss_and_metrics(params, imgs, labels, mask, cfg, preprocess,
                      apply_fn=None):
    """(sum over real examples of the cross-entropy, count of correct
    argmax predictions among them)."""
    apply_fn = apply_fn or vit.apply
    logits = apply_fn(params, preprocess(imgs), cfg)
    losses = F.cross_entropy(logits, labels.long(), reduction="none")
    loss_sum = (losses * mask).sum()
    correct = ((logits.argmax(dim=-1) == labels).float() * mask).sum()
    return loss_sum, correct


def make_train_step(cfg: ViTConfig, update, preprocess, accum: int = 1):
    """Returns train_step(params, opt_state, row, data_x, data_y, epoch_idx)
    -> (params, opt_state, metrics [loss, correct, count]) for the optimizer
    `update` of make_optimizer. Row `row` of the [steps, batch] index matrix
    is the batch; accum > 1 consumes rows row..row+accum-1 as one optimizer
    step: raw gradients of the per-row loss sums are summed and divided by
    the total real-example count, which equals one step on the concatenated
    batch. Params are leaf tensors that require grad; update changes them
    in place."""

    def train_step(params, opt_state, row, data_x, data_y, epoch_idx):
        if accum == 1:
            imgs, labels, mask = _gather_batch(data_x, data_y, epoch_idx[row])
            count = mask.sum()
            loss_sum, correct = _loss_and_metrics(params, imgs, labels, mask,
                                                  cfg, preprocess)
            loss = loss_sum / count.clamp(min=1.0)
            grads = torch.autograd.grad(loss, list(params.values()))
        else:
            grads, loss_sum, correct, count = None, 0.0, 0.0, 0.0
            for a in range(accum):
                imgs, labels, mask = _gather_batch(data_x, data_y,
                                                   epoch_idx[row + a])
                ls, cor = _loss_and_metrics(params, imgs, labels, mask, cfg,
                                            preprocess)
                g = torch.autograd.grad(ls, list(params.values()))
                grads = g if grads is None else [x + y for x, y in zip(grads, g)]
                loss_sum = loss_sum + ls.detach()
                correct = correct + cor
                count = count + mask.sum()
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
