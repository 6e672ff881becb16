"""PyTorch port, the bounded-program train step (train/bounded.py): loss and
every gradient against the JAX package's monolithic oracle
(jax.value_and_grad of vit.apply with attention_impl="reference") in all six
PE modes, several q-chunks, key segments, gradient accumulation, a masked
partial batch and the bounded evaluation; against the JAX package's own
bounded driver (Pallas kernels in interpret mode) over two optimizer steps;
and the routes into it: fit() and the train CLI with --q_chunk, and the
refusals.

Both packages get the same params (JAX init, carried across with
utils.convert), the same numpy images and labels. The port's step runs its
plain twins on the CPU with float32 products (mm_dtype=torch.float32), as
the JAX tests run the JAX driver.

Tolerances, the JAX package's tests/test_bounded.py limits, for the same
reason (float32 sums taken in another order along another schedule): loss
rtol 2e-5 / atol 1e-6; every gradient rtol 2e-4 / atol 2e-6, the atol
scaled by the tensor's largest entry where that exceeds 1: the cls token's
gradient (entries up to 9) sums the batch's cls rows, and its float32 noise
between the two frameworks is 4e-6 whatever the driver (the port's
monolithic autograd differs from jax.grad by as much), which an entry near
zero cannot absorb in a relative limit; params after two AdamW steps rtol
5e-4 / atol 5e-6 (Adam turns float32 noise in gradients near zero into
differences of the order of lr).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.train import bounded as jbounded
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import bounded, loop
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils import convert

PE_MODES = ["none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed"]
LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-6)
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)


def setup(pe, img=64, batch=2, depth=2, embed=64):
    """Both packages' configs, preprocess and params (the same numbers), and
    numpy images / labels."""
    kw = dict(img_size=img, patch_size=4, in_chans=3, embed_dim=embed,
              depth=depth, num_heads=2, pos_encoding=pe,
              attention_impl="reference")
    jcfg, cfg = JaxViTConfig(**kw), ViTConfig(**kw)
    mean_std = jdatasets.NORMALIZATION["cifar10"]
    jpre = jts.make_preprocess(jcfg, *mean_std, img)
    pre = ts.make_preprocess(cfg, *mean_std, img)
    jparams = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    state = convert.params_from_jax(jax.device_get(jparams), cfg)
    params = {k: state[k] for k in jparams}
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (batch, img, img, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (batch,), dtype=np.int32)
    return jcfg, cfg, jpre, pre, jparams, params, imgs, labels


def oracle(jcfg, jpre, jparams, imgs, labels, mask=None):
    """The JAX package's monolithic loss and gradients (XLA reference
    attention)."""
    mask = np.ones(labels.shape, np.float32) if mask is None else mask

    def loss_fn(p):
        logits = jvit.apply(p, jpre(jnp.asarray(imgs)), jcfg)
        losses = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels))
        return jnp.sum(losses * mask) / max(float(mask.sum()), 1.0)

    return jax.jit(jax.value_and_grad(loss_fn))(jparams)


def sgd(lr=0.1):
    """A plain SGD update with the optimizer's contract: linear in the
    gradient, so updated params compare as tightly as gradients do."""
    def update(grads, state, params):
        with torch.no_grad():
            for key in params:
                params[key].sub_(lr * grads[key])
        return params, state

    return (lambda params: None), update


def port_step(cfg, pre, params, batch=2, optimizer=None, **kw):
    """(step, optimizer state) of the port's bounded driver with float32
    products and the port's AdamW (or `optimizer`) over `params`."""
    init, update = optimizer or ts.make_optimizer(
        TrainConfig(dataset="cifar10", batch_size=batch, epochs=2), 2, params)
    step = bounded.make_bounded_step(
        cfg, TrainConfig(dataset="cifar10", batch_size=batch, epochs=2),
        update, pre, mm_dtype=torch.float32, debug_grads=True,
        **dict(dict(q_chunk=512), **kw))
    return step, init(params)


def copy(params):
    return {k: v.clone() for k, v in params.items()}


def run_port(cfg, pre, params, imgs, labels, mask=None, **kw):
    step, state = port_step(cfg, pre, params, **kw)
    mask = None if mask is None else torch.from_numpy(mask)
    _, _, metrics, grads = step(copy(params), state, 0,
                                torch.from_numpy(imgs),
                                torch.from_numpy(labels), mask)
    return step, metrics, grads


def assert_grads(grads, want, label=""):
    assert set(grads) == set(want)
    for key in sorted(want):
        w = np.asarray(want[key])
        np.testing.assert_allclose(
            grads[key].numpy(), w, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol"] * max(1.0, float(np.abs(w).max())),
            err_msg=f"{label}: {key}")


@pytest.mark.parametrize("pe", PE_MODES)
def test_bounded_step_matches_jax_monolithic_oracle(pe):
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(pe)
    want_loss, want = oracle(jcfg, jpre, jparams, imgs, labels)
    step, metrics, grads = run_port(cfg, pre, params, imgs, labels)
    assert step.n_chunks == 1 and step.n_pad == 512
    np.testing.assert_allclose(float(metrics[0]), float(want_loss),
                               **LOSS_TOL)
    assert float(metrics[2]) == 2.0
    assert_grads(grads, want, label=pe)


@pytest.mark.parametrize("pe", ["rope-axial"])
def test_bounded_step_at_a_padded_head_dim(pe):
    """Head dim 24 (embed 48, 2 heads), which the kernels are not built for:
    the step zero-pads q, k, v once per block to 32 and cuts the gradients
    back (rope is applied before the kernels, so the whole row is padded)."""
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(pe, embed=48)
    assert cfg.head_dim == 24
    want_loss, want = oracle(jcfg, jpre, jparams, imgs, labels)
    _, metrics, grads = run_port(cfg, pre, params, imgs, labels)
    np.testing.assert_allclose(float(metrics[0]), float(want_loss),
                               **LOSS_TOL)
    assert_grads(grads, want, label=pe)


@pytest.mark.parametrize("pe", ["rope-axial", "relative"])
def test_bounded_step_multi_chunk(pe):
    """img 128: N = 1025, n_pad = 1536 = three q-chunks of 512 at global row
    offsets."""
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(
        pe, img=128, depth=1)
    want_loss, want = oracle(jcfg, jpre, jparams, imgs, labels)
    step, metrics, grads = run_port(cfg, pre, params, imgs, labels)
    assert step.n_chunks == 3
    np.testing.assert_allclose(float(metrics[0]), float(want_loss),
                               **LOSS_TOL)
    assert_grads(grads, want, label=pe)


@pytest.mark.parametrize("pe", ["rope-axial", "polynomial", "relative"])
def test_bounded_step_kv_segmented(pe):
    """kv_chunk 512: the backward also segments the keys (three q-chunks x
    three key segments), every (q-chunk, segment) pair at nonzero global
    offsets in both axes."""
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(
        pe, img=128, depth=1)
    want_loss, want = oracle(jcfg, jpre, jparams, imgs, labels)
    step, metrics, grads = run_port(cfg, pre, params, imgs, labels,
                                    kv_chunk=512)
    assert step.n_chunks == 3
    np.testing.assert_allclose(float(metrics[0]), float(want_loss),
                               **LOSS_TOL)
    assert_grads(grads, want, label=pe)


def test_bounded_step_partial_batch_mask():
    """Masked examples (a final partial batch) add nothing to the gradient
    and the metrics count only the real examples."""
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(
        "rope-axial", batch=4)
    mask = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    want_loss, want = oracle(jcfg, jpre, jparams, imgs, labels, mask)
    _, metrics, grads = run_port(cfg, pre, params, imgs, labels, mask)
    np.testing.assert_allclose(float(metrics[0]), float(want_loss),
                               **LOSS_TOL)
    assert float(metrics[2]) == 2.0
    assert_grads(grads, want, label="masked")


@pytest.mark.parametrize("masked", [False, True])
def test_bounded_grad_accum_matches_concat_batch(masked):
    """grad_accum=2 on two micro-batches of 2 (one example padded when
    masked) is one step on the concatenated batch of 4: the same metrics,
    count-normalized gradients and (SGD-)updated params."""
    _, cfg, _, pre, _, params, imgs, labels = setup("rope-axial", batch=4)
    mask = np.array([1, 1, 1, 1 - masked], np.float32)
    concat, state = port_step(cfg, pre, params, batch=4, optimizer=sgd())
    p1, _, m1, g1 = concat(copy(params), state, 0, torch.from_numpy(imgs),
                           torch.from_numpy(labels), torch.from_numpy(mask))
    accum, state = port_step(cfg, pre, params, batch=4, optimizer=sgd(),
                             grad_accum=2)
    p2, _, m2, g2 = accum(copy(params), state, 0,
                          torch.from_numpy(imgs).reshape(2, 2, 64, 64, 3),
                          torch.from_numpy(labels).reshape(2, 2),
                          torch.from_numpy(mask).reshape(2, 2))
    np.testing.assert_allclose(m2.numpy(), m1.numpy(), **LOSS_TOL)
    assert float(m2[2]) == float(mask.sum())
    assert_grads(g2, {key: g.numpy() for key, g in g1.items()}, "accum")
    for key in g1:
        np.testing.assert_allclose(p2[key].numpy(), p1[key].numpy(),
                                   err_msg=key, **PARAM_TOL)
    with pytest.raises(ValueError, match="leading accumulation axis"):
        accum(copy(params), state, 0, torch.from_numpy(imgs),
              torch.from_numpy(labels))


def test_bounded_evaluate_matches_forward():
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup("polynomial")
    step, _ = port_step(cfg, pre, params)
    m = step.evaluate(params, 0, torch.from_numpy(imgs),
                      torch.from_numpy(labels)).numpy()
    logits = jax.jit(lambda p: jvit.apply(p, jpre(jnp.asarray(imgs)),
                                          jcfg))(jparams)
    losses = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(labels))
    np.testing.assert_allclose(m[0], float(losses.mean()), **LOSS_TOL)
    assert m[1] == float((np.argmax(np.asarray(logits), -1) == labels).sum())
    assert m[2] == 2.0
    with torch.no_grad():
        port_logits = vit.apply(params, pre(torch.from_numpy(imgs)), cfg)
    assert m[1] == float((port_logits.argmax(-1).numpy() == labels).sum())


@pytest.mark.parametrize("pe,img,depth", [("polynomial", 64, 2),
                                          ("relative", 64, 2),
                                          ("relative", 128, 1)])
def test_bounded_step_matches_jax_bounded_driver(pe, img, depth):
    """The port's driver against the JAX package's make_bounded_step (float32
    products, Pallas kernels in interpret mode) over two optimizer steps:
    the loss and gradients of each step and the params after both."""
    jcfg, cfg, jpre, pre, jparams, params, imgs, labels = setup(
        pe, img=img, depth=depth)
    jtcfg = JaxTrainConfig(dataset="cifar10", batch_size=2, epochs=2)
    tx = jts.make_optimizer(jtcfg, steps_per_epoch=2)
    jstep = jbounded.make_bounded_step(jcfg, jtcfg, tx, jpre, q_chunk=512,
                                       mm_dtype=jnp.float32, interpret=True,
                                       debug_grads=True)
    step, state = port_step(cfg, pre, params)
    assert step.n_chunks == jstep.n_chunks and step.n_pad == jstep.n_pad
    jp = jax.tree_util.tree_map(jnp.copy, jparams)
    jo = tx.init(jp)
    tp = copy(params)
    for s in range(2):
        jp, jo, jm, jg = jstep(jp, jo, jnp.asarray([s], jnp.int32),
                               jnp.asarray(imgs), jnp.asarray(labels))
        tp, state, tm, tg = step(tp, state, s, torch.from_numpy(imgs),
                                 torch.from_numpy(labels))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **LOSS_TOL)
        assert_grads(tg, jg, label=f"{pe} step {s}")
    jp = jax.device_get(jp)
    for key in jp:
        np.testing.assert_allclose(tp[key].numpy(), np.asarray(jp[key]),
                                   err_msg=key, **PARAM_TOL)


def small_data(monkeypatch):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        assert use_synthetic
        return datasets.synthetic(dataset, n_train=24, n_test=16, seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


def spy_on_bounded(monkeypatch):
    """Record the arguments of every bounded step built, and count the
    steps and evaluations it runs."""
    built = []

    def spy(*args, **kwargs):
        step = bounded.make_bounded_step(*args, **kwargs)
        calls = {"kwargs": kwargs, "steps": 0, "evals": 0}
        built.append(calls)

        def counted(*a, **k):
            calls["steps"] += 1
            return step(*a, **k)

        def evaluate(*a, **k):
            calls["evals"] += 1
            return step.evaluate(*a, **k)

        counted.evaluate = evaluate
        return counted

    monkeypatch.setattr(loop, "make_bounded_step", spy)
    return built


@pytest.mark.parametrize("accum", [1, 2])
def test_fit_routes_through_bounded_driver(accum, tmp_path, monkeypatch):
    """q_chunk > 0: fit() trains and evaluates through the bounded driver
    (one step per dispatch; with grad_accum 2, two index rows per step),
    with its CSV and checkpoint."""
    small_data(monkeypatch)
    built = spy_on_bounded(monkeypatch)
    cfg = ViTConfig(img_size=28, patch_size=4, in_chans=1, embed_dim=32,
                    depth=1, num_heads=2, pos_encoding="rope-axial")
    tcfg = TrainConfig(dataset="mnist", batch_size=8, epochs=1,
                       synthetic_data=True, q_chunk=512, grad_accum=accum,
                       save_last=False, log_dir=str(tmp_path),
                       ckpt_dir=str(tmp_path))
    summary = loop.fit(cfg, tcfg, verbose=False, device="cpu")
    assert len(built) == 1
    assert built[0]["kwargs"] == dict(q_chunk=512, kv_chunk=0,
                                      grad_accum=accum)
    assert built[0]["steps"] == -(-3 // accum) and built[0]["evals"] == 2
    hist = summary["history"]
    assert len(hist) == 1 and np.isfinite(hist[0]["train_loss"])
    assert 0.0 <= hist[0]["test_acc"] <= 100.0
    assert summary["ckpt_path"] is None or summary["ckpt_path"].endswith(
        "mnist_rope-axial_best.npz")


def test_train_cli_q_chunk_runs_the_bounded_driver(tmp_path, monkeypatch,
                                                   capsys):
    small_data(monkeypatch)
    built = spy_on_bounded(monkeypatch)
    train_cli.main([
        "--dataset", "mnist", "--synthetic", "--epochs", "1",
        "--batch_size", "8", "--img_size", "28", "--depth", "1",
        "--embed_dim", "32", "--num_heads", "2", "--pos_encoding",
        "relative", "--q_chunk", "256", "--kv_chunk", "256",
        "--log_dir", str(tmp_path / "logs"), "--ckpt_dir",
        str(tmp_path / "ckpts"), "--device", "cpu"])
    assert "Done. Best Test Acc" in capsys.readouterr().out
    assert built[0]["kwargs"] == dict(q_chunk=256, kv_chunk=256,
                                      grad_accum=1)
    assert built[0]["steps"] == 3 and built[0]["evals"] == 2


def test_bounded_step_refuses_what_is_not_ported():
    """The ring paths are ported (tests/test_torch_context_parallel.py: the
    per-q-chunk KV ring over a process group's mesh, data parallelism as
    the ring of one rank, force_ring). What they cannot take is refused:
    a mesh of local devices, seq_parallel or force_ring without a mesh;
    and dropout, grad_accum 0, and (in one process) sequence_parallel 2
    with q_chunk, whose mesh needs two ranks."""
    _, cfg, _, pre, _, params, _, _ = setup("rope-axial")
    make = functools.partial(bounded.make_bounded_step, cfg,
                             TrainConfig(dataset="cifar10"), None, pre)
    with pytest.raises(ValueError, match="process group"):
        make(mesh=make_mesh(devices=["cpu"]))
    for kw in (dict(seq_parallel=2), dict(force_ring=True)):
        with pytest.raises(ValueError, match="require a mesh"):
            make(**kw)
    with pytest.raises(ValueError, match="does not support dropout"):
        bounded.make_bounded_step(
            ViTConfig(**dict(vars(cfg), drop_rate=0.1)),
            TrainConfig(dataset="cifar10"), None, pre)
    with pytest.raises(ValueError, match="grad_accum must be >= 1"):
        make(grad_accum=0)
    with pytest.raises(ValueError, match="device count 1 not divisible by "
                       "model_parallel=1 × seq_parallel=2"):
        loop.fit(cfg, TrainConfig(dataset="mnist", q_chunk=512,
                                  sequence_parallel=2), device="cpu")
