"""Training-trajectory parity: the port's training run beside another
framework's on the same task — the counterpart of the JAX package's
utils/trajectory_parity.py.

The recipe is the JAX module's (the reference train.py's): the synthetic
set at the dataset's native size (so no side resizes), the same init,
the same batch order (per-epoch index plans with no partial batch),
cross-entropy, AdamW(lr, weight_decay) on every param, the learning rate
cosine-annealed once per epoch; then the test accuracy of the final
params. It compares the per-step loss trajectories.

This module cannot import JAX, so it holds three parts:

* `train_port(params, cfg, bundle, plans, steps, ...)`: the port's train
  step (train_step.make_train_step, the fused AdamW of
  train_step.make_optimizer: row 11's kernel on the card, its twin on the
  CPU) from the given reference-layout params over the given index plans;
  returns its per-step losses and test accuracy;
* `train_reference(params, cfg, bundle, plans, steps, ...)`: the same for
  the reference model itself (its models/vit.py from the directory that
  VIT_PE_REFERENCE names, built through the timm stub of
  tests/golden/generate_fixtures.py), loaded strictly from the port's
  .pth export of the params (utils/checkpoint.export_torch) and trained
  with torch.optim.AdamW and CosineAnnealingLR, as the reference's
  train.py does. Without that directory it raises, naming it; nothing is
  fetched and nothing stands in for it;
* `compare(...)`: the JAX module's result dict of two trajectories.

`run_trajectory_parity` runs the port against the reference model with
the JAX module's defaults and its batch order's recipe (the port's own
epoch_indices plans, as the JAX module draws its own); the port-against-
JAX run (the JAX plans and init injected) lives in the tests.

Both sides compute the same float32 function: the port trains with
attention_impl="reference" (the unfused attention, float32 products, as
the JAX module asks of the JAX build), not with the kernels, whose bf16
products would part the trajectories from the first step.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils import checkpoint
from vit_rpe_rope_tpu_torch.utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REFERENCE_ENV = "VIT_PE_REFERENCE"


def trajectory_config(pe: str = "rope-axial", dataset: str = "mnist",
                      embed_dim: int = 64, depth: int = 2,
                      num_heads: int = 4, img_size: int | None = None,
                      patch_size: int = 4) -> ViTConfig:
    """The JAX module's model: the dataset's native size by default, the
    unfused float32 attention (module docstring), and rope-mixed with the
    reference's phase scramble (part of the function compared)."""
    return ViTConfig(
        img_size=img_size or datasets.NATIVE_SIZE[dataset],
        patch_size=patch_size, in_chans=1 if dataset == "mnist" else 3,
        embed_dim=embed_dim, depth=depth, num_heads=num_heads,
        pos_encoding=pe, attention_impl="reference",
        rope_mixed_compat_scramble=(pe == "rope-mixed"))


def synthetic_task(dataset: str = "mnist", steps: int = 200,
                   batch_size: int = 64, epochs: int = 2,
                   n_test: int = 512, seed: int = 0):
    """(bundle, steps_per_epoch): the JAX module's synthetic set, whose
    n_train = steps_per_epoch · batch_size leaves no partial batch."""
    steps_per_epoch = -(-steps // epochs)
    bundle = datasets.synthetic(dataset, n_train=steps_per_epoch * batch_size,
                                n_test=n_test, seed=seed)
    return bundle, steps_per_epoch


def port_plans(n_train: int, batch_size: int, epochs: int,
               seed: int = 0) -> list:
    """One shuffled [steps, batch] index plan per epoch (the port's
    epoch_indices, seeded as the JAX module keys its own: seed + 100)."""
    return [ts.epoch_indices(n_train, batch_size, True, seed=seed + 100,
                             epoch=e).numpy() for e in range(epochs)]


def _normalized(images, bundle) -> np.ndarray:
    x = images.astype(np.float32) / 255.0
    return (x - np.asarray(bundle.mean, np.float32)) / np.asarray(
        bundle.std, np.float32)


def _accuracy(logits, labels) -> float:
    return 100.0 * float((np.asarray(logits).argmax(-1) == labels).mean())


def train_port(params: dict, cfg: ViTConfig, bundle, plans, steps: int,
               lr: float = 1e-3, weight_decay: float = 0.01,
               device=None) -> dict:
    """The port's run: `steps` steps of train_step.make_train_step over
    the index plans (epoch e takes plans[e], row by row) from `params`
    (reference-keyed arrays), on `device` (utils.device.resolve_device:
    None is the card, "cpu" asks for the CPU). Returns {"losses": per-step
    batch-mean losses, "acc": test accuracy of the final params,
    "params": them}."""
    device = resolve_device(device)
    epochs, steps_per_epoch = len(plans), plans[0].shape[0]
    tcfg = TrainConfig(dataset="mnist" if cfg.in_chans == 1 else "cifar10",
                       batch_size=plans[0].shape[1], epochs=epochs, lr=lr,
                       weight_decay=weight_decay)
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std,
                             bundle.train_x.shape[1])
    p = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
         .to(device).requires_grad_() for k, v in params.items()}
    opt_init, update = ts.make_optimizer(tcfg, steps_per_epoch, p)
    state = opt_init(p)
    step = ts.make_train_step(cfg, update, pre)
    x = torch.from_numpy(bundle.train_x).to(device)
    y = torch.from_numpy(bundle.train_y).to(device)
    losses = []
    for e, plan in enumerate(plans):
        idx = torch.as_tensor(np.array(plan, dtype=np.int64),
                              device=device)
        for s in range(steps_per_epoch):
            if len(losses) >= steps:
                break
            p, state, m = step(p, state, s, x, y, idx, epoch=e)
            losses.append(float(m[0]))
    with torch.no_grad():
        test = torch.from_numpy(_normalized(bundle.test_x, bundle))
        logits = vit.apply(p, test.to(device), cfg).cpu().numpy()
    return dict(losses=losses, acc=_accuracy(logits, bundle.test_y),
                params={k: v.detach() for k, v in p.items()})


def reference_dir(reference: str | None = None) -> str:
    """The reference checkout's directory (its models/vit.py): `reference`,
    else the one VIT_PE_REFERENCE names. Raises, naming it, when it is not
    there."""
    reference = reference or os.environ.get(REFERENCE_ENV)
    if not reference:
        raise FileNotFoundError(
            f"the reference model's directory is not given: set "
            f"{REFERENCE_ENV} to the reference checkout (its models/vit.py)")
    if not os.path.isfile(os.path.join(reference, "models", "vit.py")):
        raise FileNotFoundError(
            f"the reference model's directory {reference!r} (from "
            f"{REFERENCE_ENV} or the caller) holds no models/vit.py")
    return reference


def load_reference_model(params: dict, cfg: ViTConfig,
                         reference: str | None = None, num_classes=10):
    """The reference VisionTransformer, built through the timm stub of
    tests/golden/generate_fixtures.py and loaded strictly from the port's
    .pth export of `params` (the whole reference key contract)."""
    reference = reference_dir(reference)
    sys.path.insert(0, os.path.join(REPO, "tests", "golden"))
    from generate_fixtures import install_timm_stub

    install_timm_stub()
    if reference not in sys.path:
        sys.path.insert(0, reference)
    from models.vit import VisionTransformer

    model = VisionTransformer(
        img_size=cfg.img_size, patch_size=cfg.patch_size,
        in_chans=cfg.in_chans, num_classes=num_classes,
        embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
        pos_encoding=cfg.pos_encoding, rope_theta=cfg.rope_theta,
        poly_degree=cfg.poly_degree, poly_shared_heads=cfg.poly_shared_heads)
    host = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    with tempfile.TemporaryDirectory() as d:
        npz = checkpoint.save(os.path.join(d, "init.npz"), host,
                              vit.buffers(cfg),
                              aliases=vit.reference_alias_keys(cfg))
        state = torch.load(checkpoint.export_torch(npz), map_location="cpu",
                           weights_only=True)
    model.load_state_dict(state, strict=True)
    return model


def train_reference(params: dict, cfg: ViTConfig, bundle, plans,
                    steps: int, lr: float = 1e-3,
                    weight_decay: float = 0.01, seed: int = 0,
                    reference: str | None = None) -> dict:
    """The reference model's run (the reference train.py's loop): the same
    init, plans and recipe as train_port. Returns {"losses", "acc"}."""
    model = load_reference_model(params, cfg, reference)
    torch.manual_seed(seed)
    epochs, steps_per_epoch = len(plans), plans[0].shape[0]
    criterion = torch.nn.CrossEntropyLoss()
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=epochs)

    def batch(idx):
        x = np.transpose(_normalized(bundle.train_x[idx], bundle),
                         (0, 3, 1, 2))  # NHWC -> NCHW
        return (torch.from_numpy(np.ascontiguousarray(x)),
                torch.from_numpy(bundle.train_y[idx].astype(np.int64)))

    losses = []
    model.train()
    for plan in plans:
        for s in range(steps_per_epoch):
            if len(losses) >= steps:
                break
            x, y = batch(np.asarray(plan[s]))
            opt.zero_grad()
            loss = criterion(model(x), y)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        sched.step()
    model.eval()
    test = np.ascontiguousarray(np.transpose(
        _normalized(bundle.test_x, bundle), (0, 3, 1, 2)))
    with torch.no_grad():
        logits = model(torch.from_numpy(test)).numpy()
    return dict(losses=losses, acc=_accuracy(logits, bundle.test_y))


def compare(build_losses, other_losses, build_acc: float, other_acc: float,
            pe: str, dataset: str, batch_size: int) -> dict:
    """The JAX module's result dict of two trajectories, its keys
    unchanged: the "_jax" entries are the build under test (here the port),
    the "_torch" ones the side it is held to (the reference model, or in
    the tests the JAX package). early_max_absdiff: the largest loss
    difference over the first 10 steps; smoothed_max_reldiff: the largest
    difference of the losses averaged over windows of steps // 8, relative
    to the other side's largest window; the last windows' losses; the
    accuracies."""
    jl, tl = np.asarray(build_losses), np.asarray(other_losses)
    n_early = min(10, len(jl))
    win = max(1, len(jl) // 8)
    smooth_j = np.array([jl[i:i + win].mean() for i in range(0, len(jl), win)])
    smooth_t = np.array([tl[i:i + win].mean() for i in range(0, len(tl), win)])
    return dict(
        pe=pe, dataset=dataset, steps=len(jl), batch_size=batch_size,
        early_max_absdiff=float(np.abs(jl[:n_early] - tl[:n_early]).max()),
        smoothed_max_reldiff=float(
            np.abs(smooth_j - smooth_t).max()
            / max(np.abs(smooth_t).max(), 1e-9)),
        final_window_loss_jax=float(smooth_j[-1]),
        final_window_loss_torch=float(smooth_t[-1]),
        acc_jax=build_acc, acc_torch=other_acc,
        acc_absdiff=abs(build_acc - other_acc),
        jax_losses=[float(v) for v in jl],
        torch_losses=[float(v) for v in tl])


def run_trajectory_parity(pe="rope-axial", dataset="mnist", steps=200,
                          batch_size=64, epochs=2, embed_dim=64, depth=2,
                          num_heads=4, img_size=None, patch_size=4,
                          n_test=512, lr=1e-3, weight_decay=0.01, seed=0,
                          reference=None, device=None,
                          verbose=True) -> dict:
    """The port against the reference model (the JAX module's
    run_trajectory_parity with the port in the JAX build's place): the
    port's init (its generator seeded with `seed`), its epoch plans; both
    trained for `steps` steps; compare's dict. The port runs on `device`
    (None: the card), the reference model on the CPU."""
    reference_dir(reference)  # before any work
    device = resolve_device(device)
    cfg = trajectory_config(pe, dataset, embed_dim, depth, num_heads,
                            img_size, patch_size)
    bundle, steps_per_epoch = synthetic_task(dataset, steps, batch_size,
                                             epochs, n_test, seed)
    params = {k: v.numpy() for k, v in vit.init_params(
        torch.Generator().manual_seed(seed), cfg, device="cpu").items()}
    plans = port_plans(steps_per_epoch * batch_size, batch_size, epochs,
                       seed)
    port = train_port(params, cfg, bundle, plans, steps, lr, weight_decay,
                      device)
    ref = train_reference(params, cfg, bundle, plans, steps, lr,
                          weight_decay, seed, reference)
    result = compare(port["losses"], ref["losses"], port["acc"], ref["acc"],
                     pe, dataset, batch_size)
    if verbose:
        print(f"[{dataset}/{pe}] {result['steps']} steps | "
              f"early max|Δloss| {result['early_max_absdiff']:.2e} | "
              f"smoothed max relΔ {result['smoothed_max_reldiff']:.3f} | "
              f"final loss port {result['final_window_loss_jax']:.4f} vs "
              f"reference {result['final_window_loss_torch']:.4f} | "
              f"acc port {result['acc_jax']:.2f}% vs reference "
              f"{result['acc_torch']:.2f}%")
    return result
