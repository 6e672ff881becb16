"""PyTorch port, the training-trajectory parity harness
(vit_rpe_rope_tpu_torch/utils/trajectory_parity.py,
scripts/torch_trajectory_parity.py), on the CPU.

The JAX side lives here: the JAX module's run_trajectory_parity
(vit_rpe_rope_tpu/utils/trajectory_parity.py) at its defaults (rope-axial,
MNIST at 28 px, batch 64, two epochs, embed 64, depth 2, 4 heads, AdamW at
1e-3, the unfused float32 attention), its JAX make_train_step over its
epoch_indices plans, for 20 steps; the port's train_port takes the same
init (carried across by utils/convert) and the same plans. Float32 on both
sides: the first 10 losses agree within EARLY_TOL (absolute, the JAX
module's early_max_absdiff). The reference model's side runs where
VIT_PE_REFERENCE names its checkout, and raises, naming the directory,
where it does not.
"""

import functools
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel.mesh import (
    DATA_AXIS, NamedSharding, P, make_mesh)
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.utils import trajectory_parity as traj
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

EARLY_TOL = 1e-5
STEPS, BATCH, EPOCHS, SEED = 20, 64, 2, 0
SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scripts", "torch_trajectory_parity.py")


def jax_side(cfg_kw, bundle, steps_per_epoch):
    """The JAX module's JAX half at its defaults: (init params, per-epoch
    plans, per-step losses, final params), all as numpy arrays."""
    jcfg = JaxViTConfig(**cfg_kw)
    n_train = steps_per_epoch * BATCH
    tcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=EPOCHS,
                          lr=1e-3, weight_decay=0.01, seed=SEED)
    # one jitted program (eagerly, each random draw compiles on its own)
    params = jax.jit(functools.partial(jvit.init_params, cfg=jcfg))(
        jax.random.PRNGKey(SEED))
    init = {k: np.asarray(v) for k, v in params.items()}
    key = jax.random.PRNGKey(SEED + 100)
    plans = [np.asarray(jts.epoch_indices(jax.random.fold_in(key, e),
                                          n_train, BATCH, True))
             for e in range(EPOCHS)]
    mesh = make_mesh(batch_size=BATCH, num_devices=1)
    rep = NamedSharding(mesh, P())
    pre = jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28)
    tx = jts.make_optimizer(tcfg, steps_per_epoch)
    p = jax.device_put(params, rep)
    o = jax.device_put(tx.init(p), rep)
    step = jts.make_train_step(jcfg, tcfg, mesh, tx, pre)
    dx = jax.device_put(bundle.train_x, rep)
    dy = jax.device_put(bundle.train_y, rep)
    losses = []
    for e in range(EPOCHS):
        ei = jax.device_put(jnp.asarray(plans[e]),
                            NamedSharding(mesh, P(None, DATA_AXIS)))
        for s in range(steps_per_epoch):
            if len(losses) >= STEPS:
                break
            p, o, m = step(p, o, jnp.asarray([s], jnp.int32), dx, dy, ei)
            losses.append(float(np.asarray(m)[0]))
    return init, plans, losses, {k: np.asarray(v) for k, v in
                                 jax.device_get(p).items()}


def test_port_trajectory_matches_the_jax_build():
    """20 steps of the port (train_port, the fused AdamW's twin) against
    the JAX make_train_step on the same init, set and plans: the first 10
    losses within EARLY_TOL, and compare's dict holds the JAX module's
    statistics (the JAX side's test accuracy taken by the port's forward
    on its final params, carried across)."""
    cfg = traj.trajectory_config()
    assert cfg.attention_impl == "reference" and cfg.img_size == 28
    bundle, steps_per_epoch = traj.synthetic_task(steps=STEPS,
                                                  batch_size=BATCH,
                                                  epochs=EPOCHS, seed=SEED)
    assert steps_per_epoch * BATCH == len(bundle.train_y) == 640
    kw = {f: getattr(cfg, f) for f in (
        "img_size", "patch_size", "in_chans", "embed_dim", "depth",
        "num_heads", "pos_encoding", "attention_impl",
        "rope_mixed_compat_scramble")}
    jinit, plans, jax_losses, jfinal = jax_side(kw, bundle, steps_per_epoch)

    def carried(tree):
        return {k: v for k, v in params_from_jax(tree, cfg).items()
                if k in tree}

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the port's side on one intra-op thread
    try:
        port = traj.train_port({k: v.numpy() for k, v in
                                carried(jinit).items()}, cfg, bundle, plans,
                               STEPS, device="cpu")
        with torch.no_grad():
            test = torch.from_numpy(traj._normalized(bundle.test_x, bundle))
            jax_acc = traj._accuracy(vit.apply(carried(jfinal), test, cfg),
                                     bundle.test_y)
    finally:
        torch.set_num_threads(threads)
    result = traj.compare(port["losses"], jax_losses, port["acc"], jax_acc,
                          cfg.pos_encoding, "mnist", BATCH)
    assert len(port["losses"]) == STEPS
    assert result["early_max_absdiff"] < EARLY_TOL, result
    assert result["smoothed_max_reldiff"] < 1e-4, result
    assert result["acc_absdiff"] <= 0.5, result
    # the JAX module's keys, for a result of two trajectories
    jax_keys = {"pe", "dataset", "steps", "batch_size", "early_max_absdiff",
                "smoothed_max_reldiff", "final_window_loss_jax",
                "final_window_loss_torch", "acc_jax", "acc_torch",
                "acc_absdiff", "jax_losses", "torch_losses"}
    assert set(result) == jax_keys


def test_reference_side_raises_naming_the_directory(tmp_path, monkeypatch,
                                                   capsys):
    """Without the reference checkout the reference side raises, naming the
    directory (or the variable, when none is named), and the script stops
    with that error; nothing else stands in."""
    missing = str(tmp_path / "no_reference")
    monkeypatch.setenv(traj.REFERENCE_ENV, missing)
    with pytest.raises(FileNotFoundError, match="no_reference"):
        traj.train_reference({}, traj.trajectory_config(), None, [], 1)
    with pytest.raises(FileNotFoundError, match="no_reference"):
        traj.run_trajectory_parity(steps=2, device="cpu")
    monkeypatch.delenv(traj.REFERENCE_ENV)
    with pytest.raises(FileNotFoundError, match=traj.REFERENCE_ENV):
        traj.reference_dir()
    monkeypatch.setattr(sys, "argv", [SCRIPT, "--pe", "none", "--steps",
                                      "2", "--reference", missing,
                                      "--device", "cpu"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(SCRIPT, run_name="__main__")
    assert exc.value.code == 2 and "no_reference" in capsys.readouterr().err


def test_port_side_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """The port's side is an entry point: with no device named it takes
    the card (utils.device.resolve_device) and, with none visible, raises
    instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = traj.trajectory_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traj.train_port({}, cfg, None, [np.zeros((1, 1), np.int64)], 1)
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "vit.py").write_text("")
    monkeypatch.setenv(traj.REFERENCE_ENV, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traj.run_trajectory_parity(steps=2)


@pytest.mark.skipif(
    not os.path.isdir(os.environ.get(traj.REFERENCE_ENV) or ""),
    reason="the reference checkout is not mounted (VIT_PE_REFERENCE)")
def test_port_trajectory_matches_the_reference_model():
    """Where the reference checkout is there: 20 steps of the port against
    the reference model (strict .pth load of the port's init), the JAX
    module's early bound."""
    result = traj.run_trajectory_parity(steps=STEPS, verbose=False,
                                        device="cpu")
    assert result["early_max_absdiff"] < EARLY_TOL, result
