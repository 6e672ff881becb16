"""PyTorch port, training: the schedule, the masked loss and metrics, one
step's gradients, three SGD steps on an injected index matrix against the
JAX package's single-device train step, gradient accumulation, and fit()'s
side effects (CSV, best and last checkpoints, --resume) on the CPU.

Both packages get the same params (JAX init, moved over with numpy), the
same images (the synthetic dataset is byte-identical) and the same index
matrix (the packages shuffle with different generators by design).

Tolerances: unfused attention on both sides ("reference"): 1e-5 (float32
sums in another order); the attention kernels on both sides ("flash": the
port's plain twins, the JAX package's Pallas kernels in interpret mode):
2e-3 (bf16 operands that can round the other way at a boundary).
Gradients are compared relative to each tensor's largest entry.
"""

import csv
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.configs import cosine_lr_by_epoch as jax_cosine
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P, make_mesh
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig, cosine_lr_by_epoch
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

import torch_cp_worker
import torch_pp_worker
from torch_tp_worker import launch

TOL = {"reference": 1e-5, "flash": 2e-3}


def cfg_kw(**kw):
    d = dict(img_size=32, patch_size=8, in_chans=1, embed_dim=32, depth=2,
             num_heads=2, pos_encoding="rope-mixed", attention_impl="reference")
    d.update(kw)
    return d


def both_params(kw, seed=0):
    """(JAX params, port params requiring grad) — the same numbers."""
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in jparams.items()}
    return jparams, tparams


def batch(n_train=40, seed=1):
    bundle = datasets.synthetic("mnist", n_train=n_train, n_test=8,
                                seed=seed)
    pre_args = (bundle.mean, bundle.std, 28)
    return bundle, pre_args


def port_sgd(lr):
    def update(grads, state, params):
        with torch.no_grad():
            for k in params:
                params[k].sub_(lr * grads[k])
        return params, state

    return update


def close_to_largest(got, want, tol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=tol * float(np.abs(want).max()) + 1e-8, err_msg=err_msg)


@pytest.mark.parametrize("epochs,steps_per_epoch", [(25, 100), (3, 7)])
def test_schedule_matches_jax(epochs, steps_per_epoch):
    jsched = jax_cosine(1e-3, epochs, steps_per_epoch)
    sched = cosine_lr_by_epoch(1e-3, epochs, steps_per_epoch)
    for step in range(0, epochs * steps_per_epoch + 10, 3):
        np.testing.assert_allclose(float(sched(step)),
                                   float(jsched(jnp.int32(step))), rtol=1e-6)
    assert float(sched(epochs * steps_per_epoch)) == pytest.approx(0.0,
                                                                   abs=1e-12)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_masked_loss_and_metrics_match_jax(impl):
    kw = cfg_kw(pos_encoding="relative", attention_impl=impl)
    jparams, tparams = both_params(kw)
    bundle, pre_args = batch()
    idx = np.array([3, 0, 7, -1, 5, -1, 11, 2], np.int64)
    imgs, labels, mask = jts._gather_batch(
        jnp.asarray(bundle.train_x), jnp.asarray(bundle.train_y),
        jnp.asarray(idx, jnp.int32))
    jcfg = JaxViTConfig(**kw)
    want = jts._loss_and_metrics(jparams, imgs, labels, mask, jcfg,
                                 jts.make_preprocess(jcfg, *pre_args))
    cfg = ViTConfig(**kw)
    timgs, tlabels, tmask = ts._gather_batch(
        torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y),
        torch.from_numpy(idx))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    got = ts._loss_and_metrics(tparams, timgs, tlabels, tmask, cfg,
                               ts.make_preprocess(cfg, *pre_args))
    np.testing.assert_allclose(float(got[0].detach()), float(want[0]),
                               rtol=TOL[impl])
    assert float(got[1]) == float(want[1])


@pytest.mark.parametrize("pe,impl,patch", [
    ("rope-mixed", "flash", 8), ("polynomial", "flash", 8),
    ("relative", "reference", 8), ("relative", "flash", 4)])
def test_one_step_grads_match_jax(pe, impl, patch):
    """value_and_grad of the batch-mean loss (patch 4 at img 32 = grid 8,
    N=65: a ragged key edge in the kernels' 64-wide tiles)."""
    kw = cfg_kw(pos_encoding=pe, attention_impl=impl, patch_size=patch)
    jparams, tparams = both_params(kw, seed=2)
    bundle, pre_args = batch(seed=2)
    idx = np.array([1, 4, 9, 16, 25, 36, -1, -1], np.int64)
    jcfg, cfg = JaxViTConfig(**kw), ViTConfig(**kw)
    imgs, labels, mask = jts._gather_batch(
        jnp.asarray(bundle.train_x), jnp.asarray(bundle.train_y),
        jnp.asarray(idx, jnp.int32))
    jpre = jts.make_preprocess(jcfg, *pre_args)

    def loss_fn(p):
        return jts._loss_and_metrics(p, imgs, labels, mask, jcfg, jpre)[0] / 6

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    timgs, tlabels, tmask = ts._gather_batch(
        torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y),
        torch.from_numpy(idx))
    loss = ts._loss_and_metrics(tparams, timgs, tlabels, tmask, cfg,
                                ts.make_preprocess(cfg, *pre_args))[0] / 6
    got = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL[impl])
    for key, g in zip(tparams, got):
        close_to_largest(g.numpy(), want[key], TOL[impl], err_msg=key)


@pytest.mark.parametrize("pe,img,threshold", [("rope-mixed", 48, 128),
                                              ("relative", 96, None)])
def test_one_step_grads_match_jax_on_the_streaming_route(pe, img, threshold,
                                                         monkeypatch):
    """The loss and every gradient leaf through the streaming forward and
    the separate-pass backward (the modes that keep it). rope-mixed: N=145 above a threshold lowered
    to 128 in both packages (dqr/dkr -> frequency gradients). relative:
    N=577 with 2 heads, where `_dense_attn_fits` fails below the real
    threshold, so both packages stream with the MATERIALIZED bias and the
    table's gradient comes from the dbias pass."""
    if threshold is not None:
        monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", threshold)
        monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", threshold)
    kw = cfg_kw(pos_encoding=pe, attention_impl="flash", img_size=img,
                patch_size=4)
    jcfg, cfg = JaxViTConfig(**kw), ViTConfig(**kw)
    assert cfg.seq_len > tfa.STREAMING_THRESHOLD or not tfa._dense_attn_fits(
        cfg.num_heads, cfg.seq_len, pe == "relative")
    jparams, tparams = both_params(kw, seed=4)
    bundle, pre_args = batch(seed=4)
    idx = np.array([2, 3, 5, 7, -1, 11], np.int64)
    imgs, labels, mask = jts._gather_batch(
        jnp.asarray(bundle.train_x), jnp.asarray(bundle.train_y),
        jnp.asarray(idx, jnp.int32))
    jpre = jts.make_preprocess(jcfg, *pre_args)

    def loss_fn(p):
        return jts._loss_and_metrics(p, imgs, labels, mask, jcfg, jpre)[0] / 5

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    timgs, tlabels, tmask = ts._gather_batch(
        torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y),
        torch.from_numpy(idx))
    loss = ts._loss_and_metrics(tparams, timgs, tlabels, tmask, cfg,
                                ts.make_preprocess(cfg, *pre_args))[0] / 5
    got = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL["flash"])
    for key, g in zip(tparams, got):
        close_to_largest(g.numpy(), want[key], TOL["flash"], err_msg=key)


@pytest.mark.parametrize("pe", ["polynomial", "relative"])
def test_training_a_generated_bias_raises(pe, monkeypatch):
    """Above the threshold (lowered to 128 in both packages; N=145) the
    polynomial / relative bias is generated in the kernels and its parameter
    gradient is summed in the one-pass backward. Training it raised until
    that kernel was ported; now the eval step runs, the loss and every
    gradient leaf (the coefficients / the table included) agree with
    jax.value_and_grad on the JAX package, and an SGD train step moves every
    leaf by -lr times that gradient."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 128)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 128)
    kw = cfg_kw(pos_encoding=pe, attention_impl="auto", img_size=48,
                patch_size=4)
    cfg = ViTConfig(**kw)
    jcfg = JaxViTConfig(**dict(kw, attention_impl="flash"))
    jparams, tparams = both_params(kw, seed=5)
    bundle, pre_args = batch(seed=5)
    pre = ts.make_preprocess(cfg, *pre_args)
    data = (torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y),
            torch.arange(8)[None])
    metrics = ts.make_eval_step(cfg, pre)(tparams, 0, *data)
    assert torch.isfinite(metrics).all() and float(metrics[2]) == 8

    imgs, labels, mask = jts._gather_batch(
        jnp.asarray(bundle.train_x), jnp.asarray(bundle.train_y),
        jnp.arange(8, dtype=jnp.int32))
    jpre = jts.make_preprocess(jcfg, *pre_args)

    def loss_fn(p):
        return jts._loss_and_metrics(p, imgs, labels, mask, jcfg, jpre)[0] / 8

    want_loss, want = jax.value_and_grad(loss_fn)(jparams)
    timgs, tlabels, tmask = ts._gather_batch(*data[:2], data[2][0])
    loss = ts._loss_and_metrics(tparams, timgs, tlabels, tmask, cfg, pre)[0] / 8
    got = torch.autograd.grad(loss, list(tparams.values()))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL["flash"])
    pe_keys = [key for key in tparams if key.startswith("pos_embed.")]
    assert pe_keys
    for key, g in zip(tparams, got):
        close_to_largest(g.numpy(), want[key], TOL["flash"], err_msg=key)
    for key in pe_keys:  # the generated bias' parameters do get a gradient
        assert float(np.abs(np.asarray(want[key])).max()) > 0

    before = {key: value.detach().clone() for key, value in tparams.items()}
    step = ts.make_train_step(cfg, port_sgd(0.1), pre)
    tparams, _, metrics = step(tparams, None, 0, *data)
    assert torch.isfinite(metrics).all()
    for key in tparams:
        close_to_largest((tparams[key].detach() - before[key]).numpy(),
                         -0.1 * np.asarray(want[key]), TOL["flash"],
                         err_msg=key)


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_three_sgd_steps_match_jax_train_step(impl):
    """Three steps on an injected index matrix (the last batch partial)
    against the JAX package's make_train_step on a 1-device mesh. SGD keeps
    the comparison tight: it is linear in the gradient."""
    kw = cfg_kw(pos_encoding="polynomial", attention_impl=impl)
    jparams, tparams = both_params(kw, seed=3)
    bundle, pre_args = batch(n_train=40, seed=3)
    order = np.random.default_rng(3).permutation(40)
    idx = np.concatenate([order, -np.ones(8, np.int64)]).reshape(3, 16)
    jcfg, cfg = JaxViTConfig(**kw), ViTConfig(**kw)

    mesh = make_mesh(batch_size=16, num_devices=1)
    rep = NamedSharding(mesh, P())
    tx = optax.sgd(0.05)
    jfn = jts.make_train_step(jcfg, JaxTrainConfig(dataset="mnist",
                                                   batch_size=16),
                              mesh, tx, jts.make_preprocess(jcfg, *pre_args))
    jp = jax.device_put(jparams, rep)
    jo = jax.device_put(tx.init(jparams), rep)
    dx = jax.device_put(bundle.train_x, rep)
    dy = jax.device_put(bundle.train_y, rep)
    jidx = jax.device_put(jnp.asarray(idx, jnp.int32),
                          NamedSharding(mesh, P(None, DATA_AXIS)))
    tfn = ts.make_train_step(cfg, port_sgd(0.05),
                             ts.make_preprocess(cfg, *pre_args))
    tx_, ty_ = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    tidx = torch.from_numpy(idx)
    state = None
    for s in range(3):
        jp, jo, jm = jfn(jp, jo, jnp.asarray([s], jnp.int32), dx, dy, jidx)
        tparams, state, tm = tfn(tparams, state, s, tx_, ty_, tidx)
        jm, tm = np.asarray(jm), tm.numpy()
        np.testing.assert_allclose(tm[0], jm[0], rtol=TOL[impl])
        assert tm[2] == jm[2] == (16 if s < 2 else 8)
        assert abs(tm[1] - jm[1]) <= 1  # near-tied logits may flip argmax
    jp = jax.device_get(jp)
    for key in tparams:
        close_to_largest(tparams[key].detach().numpy(), jp[key], TOL[impl],
                         err_msg=key)


def test_grad_accum_matches_one_double_batch():
    """accum=2 over two bs-8 rows equals one bs-16 row on the same 16
    examples (raw grads summed, divided by the total real count)."""
    kw = cfg_kw(pos_encoding="rope-axial")
    _, p16 = both_params(kw, seed=4)
    _, p8 = both_params(kw, seed=4)
    bundle, pre_args = batch(n_train=32, seed=4)
    cfg = ViTConfig(**kw)
    pre = ts.make_preprocess(cfg, *pre_args)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    order = torch.arange(32)
    fn16 = ts.make_train_step(cfg, port_sgd(0.05), pre)
    fn8 = ts.make_train_step(cfg, port_sgd(0.05), pre, accum=2)
    for s16, s8 in ((0, 0), (1, 2)):
        p16, _, m16 = fn16(p16, None, s16, x, y, order.reshape(2, 16))
        p8, _, m8 = fn8(p8, None, s8, x, y, order.reshape(4, 8))
        np.testing.assert_allclose(m8.numpy(), m16.numpy(), rtol=1e-6)
        assert float(m8[2]) == 16
    for key in p16:
        np.testing.assert_allclose(p8[key].detach().numpy(),
                                   p16[key].detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=key)


def test_grad_accum_partial_group_masks_padding():
    kw = cfg_kw(pos_encoding="none")
    _, params = both_params(kw, seed=5)
    bundle, pre_args = batch(n_train=12, seed=5)
    cfg = ViTConfig(**kw)
    fn = ts.make_train_step(cfg, port_sgd(0.05),
                            ts.make_preprocess(cfg, *pre_args), accum=2)
    idx = ts.pad_epoch_indices(ts.epoch_indices(12, 8, False), 2)
    assert idx.shape == (2, 8) and int((idx[1] == -1).sum()) == 4
    params, _, m = fn(params, None, 0, torch.from_numpy(bundle.train_x),
                      torch.from_numpy(bundle.train_y), idx)
    assert float(m[2]) == 12 and np.isfinite(float(m[0]))


def test_epoch_indices_cover_each_example_once():
    idx = ts.epoch_indices(37, 8, True, seed=3, epoch=1)
    assert idx.shape == (5, 8) and int((idx == -1).sum()) == 3
    assert sorted(idx[idx >= 0].tolist()) == list(range(37))
    assert not torch.equal(idx, ts.epoch_indices(37, 8, True, seed=3, epoch=2))
    assert torch.equal(idx, ts.epoch_indices(37, 8, True, seed=3, epoch=1))
    np.testing.assert_array_equal(
        ts.epoch_indices(37, 8, False).numpy(),
        np.asarray(jts.epoch_indices(jax.random.PRNGKey(0), 37, 8, False)))


def small_data(monkeypatch):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        assert use_synthetic
        return datasets.synthetic(dataset, n_train=96, n_test=32, seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


def test_fit_side_effects_and_resume(tmp_path, monkeypatch):
    small_data(monkeypatch)
    cfg = ViTConfig(**cfg_kw(pos_encoding="polynomial",
                             attention_impl="auto"))
    common = dict(dataset="mnist", batch_size=32, synthetic_data=True,
                  log_dir=str(tmp_path / "logs"),
                  ckpt_dir=str(tmp_path / "ckpts"), seed=0)
    summary = loop.fit(cfg, TrainConfig(epochs=1, **common), verbose=False,
                       device="cpu")
    csvs = glob.glob(str(tmp_path / "logs" / "mnist_polynomial_*.csv"))
    assert len(csvs) == 1 and summary["log_file"] == csvs[0]
    with open(csvs[0]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "train_loss", "train_acc", "test_loss",
                       "test_acc", "best_acc"]
    assert len(rows) == 2 and rows[1][0] == "1"
    assert summary["num_params"] == vit.num_params(
        vit.init_params(torch.Generator(), cfg, device="cpu"))
    best = tmp_path / "ckpts" / "mnist_polynomial_best.npz"
    assert summary["ckpt_path"] == str(best)
    with np.load(best) as z:
        keys = set(z.files)
    assert {"pos_embed.coefficients", "patch_embed.weight",
            "blocks.0.attn.pos_encoding.coefficients"} <= keys
    last = tmp_path / "ckpts" / "mnist_polynomial_last.npz"
    with np.load(last) as z:
        assert {"__opt.0", "__opt.1", "__opt.2", "__opt.3", "__epoch",
                "__best_acc"} <= set(z.files)
        assert int(z["__epoch"]) == 0 and int(z["__opt.0"]) == 3
    resumed = loop.fit(cfg, TrainConfig(epochs=2, resume=True, **common),
                       verbose=False, device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert resumed["best_acc"] >= summary["best_acc"]
    with np.load(last) as z:
        assert int(z["__epoch"]) == 1 and int(z["__opt.0"]) == 6


@pytest.mark.parametrize("field,value", [
    ("model_parallel", 2), ("sequence_parallel", 2), ("pipeline_parallel", 2),
    ("zero1", True), ("augment", True)])
def test_fit_refuses_unported_fields(field, value, tmp_path, monkeypatch):
    if field == "augment":
        # Ported (tests/test_torch_regularize.py); bounded stepping still
        # refuses it, as in the JAX package.
        with pytest.raises(ValueError, match="augment"):
            TrainConfig(dataset="mnist", q_chunk=16, augment=value)
        return
    if field == "model_parallel":
        # Ported (tests/test_torch_tensor_parallel.py): fit on two gloo
        # ranks (tests/torch_tp_worker.py), the heads and MLP rows sharded;
        # in one process (world size 1) T = 2 raises the JAX ValueError.
        launch("fit_one", tmp_path, 2)
        ranks = [json.loads((tmp_path / f"fit_one_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert ranks[0]["log_file"] and ranks[1]["log_file"] is None
        with np.load(tmp_path / "ckpts" / "mnist_rope-mixed_last.npz") as z:
            assert z["blocks.0.attn.qkv.weight"].shape == (96, 32)
        with pytest.raises(ValueError, match="device count 1 not divisible "
                           "by model_parallel=2"):
            loop.fit(ViTConfig(**cfg_kw()),
                     TrainConfig(dataset="mnist", model_parallel=value),
                     device="cpu")
        return
    if field == "pipeline_parallel":
        # Ported (tests/test_torch_pipeline_parallel.py): fit on two gloo
        # ranks (tests/torch_pp_worker.py), one block a stage, four
        # microbatches a step; in one process (world size 1) P = 2 raises
        # the JAX ValueError, and so does P = 2 with sequence_parallel
        # (PP x CP, ported: tests/test_torch_pp_tp_cp.py).
        torch_pp_worker.launch("fit_one", tmp_path, 2)
        ranks = [json.loads((tmp_path / f"fit_one_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert ranks[0]["log_file"] and ranks[1]["log_file"] is None
        with np.load(tmp_path / "ckpts" / "mnist_rope-mixed_last.npz") as z:
            assert z["blocks.1.attn.qkv.weight"].shape == (96, 32)
            assert int(z["__opt.0"]) == 2
        with pytest.raises(ValueError, match="device count 1 not divisible "
                           "by model_parallel=1 × seq_parallel=1 × "
                           "pipe_parallel=2"):
            loop.fit(ViTConfig(**cfg_kw()),
                     TrainConfig(dataset="mnist", pipeline_parallel=value),
                     device="cpu")
        with pytest.raises(ValueError, match="device count 1 not divisible "
                           "by model_parallel=1 × seq_parallel=2 × "
                           "pipe_parallel=2"):
            loop.fit(ViTConfig(**cfg_kw()),
                     TrainConfig(dataset="mnist", pipeline_parallel=value,
                                 sequence_parallel=2), device="cpu")
        return
    if field == "sequence_parallel":
        # Ported (tests/test_torch_context_parallel.py): fit on two gloo
        # ranks (tests/torch_cp_worker.py), each block's attention a KV ring
        # over the two token shards; in one process (world size 1) R = 2
        # raises the JAX ValueError, and so does R = 2 with model_parallel
        # (TP x CP, ported: tests/test_torch_tp_cp.py).
        torch_cp_worker.launch("cli", tmp_path, 2, "--synthetic",
                               "--sequence_parallel", "2", "--epochs", "1",
                               "--batch_size", "16", "--depth", "1",
                               "--embed_dim", "32", "--num_heads", "2",
                               "--device", "cpu")
        ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert ranks[0]["log_file"] and ranks[1]["log_file"] is None
        with pytest.raises(ValueError, match="device count 1 not divisible "
                           "by model_parallel=1 × seq_parallel=2"):
            loop.fit(ViTConfig(**cfg_kw()),
                     TrainConfig(dataset="mnist", sequence_parallel=value),
                     device="cpu")
        with pytest.raises(ValueError, match="device count 1 not divisible "
                           "by model_parallel=2 × seq_parallel=2 × "
                           "pipe_parallel=1"):
            loop.fit(ViTConfig(**cfg_kw()),
                     TrainConfig(dataset="mnist", sequence_parallel=value,
                                 model_parallel=2), device="cpu")
        return
    if field == "zero1":
        # Ported (tests/test_torch_data_parallel.py): in one process its one
        # slice is the whole flat vector, and the run is the replicated
        # optimizer's, bit for bit.
        small_data(monkeypatch)
        cfg = ViTConfig(**cfg_kw(pos_encoding="rope-axial"))
        state = {}
        for zero1 in (False, True):
            ckpts = tmp_path / f"ckpts_{zero1}"
            loop.fit(cfg, TrainConfig(dataset="mnist", batch_size=32,
                                      epochs=1, synthetic_data=True,
                                      log_dir=str(tmp_path / "logs"),
                                      ckpt_dir=str(ckpts), zero1=zero1),
                     verbose=False, device="cpu")
            with np.load(ckpts / "mnist_rope-axial_last.npz") as z:
                state[zero1] = {k: z[k] for k in z.files}
        assert int(state[True]["__opt.0"]) == 3
        for key in state[False]:
            np.testing.assert_array_equal(state[True][key], state[False][key],
                                          err_msg=key)
        return
    with pytest.raises(NotImplementedError, match=field):
        loop.fit(ViTConfig(**cfg_kw()),
                 TrainConfig(dataset="mnist", **{field: value}),
                 device="cpu")


def test_fit_refuses_bounded_stepping(tmp_path):
    """Bounded stepping trains on one device (tests/test_torch_bounded.py)
    and, ported since, over a sequence-parallel mesh (the JAX driver's
    per-chunk KV ring; tests/test_torch_context_parallel.py): fit with
    q_chunk and sequence_parallel 2 on two gloo ranks (through the train
    CLI, tests/torch_cp_worker.py) trains an epoch, the ranks reporting the
    same row; in one process R = 2 raises the JAX ValueError."""
    torch_cp_worker.launch("cli", tmp_path, 2, "--synthetic", "--q_chunk",
                           "16", "--sequence_parallel", "2", "--epochs",
                           "1", "--batch_size", "16", "--depth", "1",
                           "--embed_dim", "32", "--num_heads", "2",
                           "--pos_encoding", "relative", "--device", "cpu")
    ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
             for r in (0, 1)]
    for r in ranks:
        del r["history"][0]["images_per_sec"]
    assert ranks[0]["history"] == ranks[1]["history"]
    assert np.isfinite(ranks[0]["history"][0]["train_loss"])
    with pytest.raises(ValueError, match="seq_parallel=2"):
        loop.fit(ViTConfig(**cfg_kw()),
                 TrainConfig(dataset="mnist", q_chunk=16,
                             sequence_parallel=2), device="cpu")


@pytest.mark.parametrize("kw", [dict(drop_rate=0.1), dict(remat=True)])
def test_training_forward_refuses_dropout_and_remat(kw):
    """Neither is refused any more. Dropout (tests/test_torch_regularize.py)
    acts only with a generator, so a forward without one, with grad or not,
    is the deterministic one; remat (tests/test_torch_remat.py) gives a
    training forward the same numbers, bit for bit."""
    cfg = ViTConfig(**cfg_kw(**kw))
    _, params = both_params(cfg_kw(), seed=6)
    x = torch.zeros(2, 32, 32, 1)
    torch.testing.assert_close(vit.apply(params, x, cfg),
                               vit.apply(params, x, ViTConfig(**cfg_kw())),
                               rtol=0, atol=0)
    with torch.no_grad():  # the eval forward
        assert vit.apply(params, x, cfg).shape == (2, 10)
