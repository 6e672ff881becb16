"""PyTorch port, k train steps per dispatch (train_step.make_train_multi_step)
and the epoch-ordered feed, on the CPU, where the driver runs its k steps
eagerly (the plain version of the CUDA graph it replays on the card).

* pick_steps_per_dispatch, pad_epoch_indices and epoch_order_data against
  the JAX package's, exactly;
* the k-step driver against the port's per-step driver, bit for bit, with
  padded no-op steps (k = 3 over 4 steps), with grad_accum 2, on both
  feeds, and with AdamW (count, moments and params);
* the k-step driver against the JAX package's make_train_multi_step and
  make_flat_train_multi_step on one injected index matrix, under SGD
  (linear in the gradient, as the JAX package's own equivalence test):
  losses within rtol 1e-5 and params within 1e-5 of each leaf's largest
  entry on the unfused attention (float32 sums in another order), 2e-3 on
  the kernels' twins against the Pallas kernels in interpret mode (bf16
  operands that can round the other way);
* fit with steps_per_dispatch 4 gives the CSV row of steps_per_dispatch 1,
  and a run resumes under another k;
* the AdamW kernel's device-table entry (its plain twin here) and the
  launch counts' helpers.
"""

import csv
import glob

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P, make_mesh
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu.utils.flatten import Flattener as JaxFlattener
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.ops import fused_adamw, launches
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and the
    workers of a parallel test run do not compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {"reference": 1e-5, "flash": 2e-3}


def cfg_kw(**kw):
    d = dict(img_size=32, patch_size=8, in_chans=1, embed_dim=32, depth=2,
             num_heads=2, pos_encoding="rope-mixed", attention_impl="reference")
    d.update(kw)
    return d


def both_params(kw, seed=0):
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in jparams.items()}
    return jparams, tparams


def port_params(kw, seed=0):
    return both_params(kw, seed)[1]


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


def data(n_train, batch, seed, rows=None):
    """The synthetic MNIST set (byte-identical in both packages), its
    pre-processing arguments and an injected [rows, batch] index matrix
    (the last real row partial, then padded rows)."""
    bundle = datasets.synthetic("mnist", n_train=n_train, n_test=8, seed=seed)
    order = np.random.default_rng(seed).permutation(n_train)
    real = -(-n_train // batch)
    rows = rows or real
    idx = np.full(rows * batch, -1, np.int64)
    idx[:n_train] = order
    return bundle, (bundle.mean, bundle.std, 28), idx.reshape(rows, batch)


def adamw(cfg, steps_per_epoch, params):
    return ts.make_optimizer(TrainConfig(dataset="mnist", epochs=2),
                             steps_per_epoch, params)


@pytest.mark.parametrize("cap", [32, 7, 1])
def test_pick_steps_per_dispatch_matches_jax(cap):
    for steps in range(1, 501):
        assert ts.pick_steps_per_dispatch(steps, cap) == \
            jts.pick_steps_per_dispatch(steps, cap), steps


@pytest.mark.parametrize("k", [1, 3, 4])
def test_pad_epoch_indices_matches_jax(k):
    idx = np.arange(40, dtype=np.int64).reshape(5, 8)
    got = ts.pad_epoch_indices(torch.from_numpy(idx), k)
    want = jts.pad_epoch_indices(jnp.asarray(idx, jnp.int32), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_train,batch,rows", [(40, 16, 3), (48, 16, 5),
                                               (37, 8, 6)])
def test_epoch_order_data_matches_jax(n_train, batch, rows):
    bundle, _, idx = data(n_train, batch, seed=n_train, rows=rows)
    got_x, got_y = ts.epoch_order_data(torch.from_numpy(bundle.train_x),
                                       torch.from_numpy(bundle.train_y),
                                       torch.from_numpy(idx))
    want_x, want_y = jts.epoch_order_data(jnp.asarray(bundle.train_x),
                                          jnp.asarray(bundle.train_y),
                                          jnp.asarray(idx, jnp.int32))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    # each ordered slice is the gather of its index row
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    for row in range(rows):
        sliced = ts._fetch_batch_ordered(got_x, got_y, torch.from_numpy(
            idx[row]), row)
        gathered = ts._gather_batch(x, y, torch.from_numpy(idx[row]))
        for a, b in zip(sliced, gathered):
            assert torch.equal(a, b)


def test_make_fetch_modes():
    assert ts._make_fetch("gather") is None
    assert ts._make_fetch("ordered") is ts._fetch_batch_ordered
    with pytest.raises(ValueError, match="feed"):
        ts._make_fetch("stream")


def run_per_step(cfg, pre, update, opt_state, params, x, y, idx, accum=1):
    step = ts.make_train_step(cfg, update, pre, accum=accum)
    metrics = []
    for row in range(0, idx.shape[0], accum):
        if not (idx[row:row + accum] >= 0).any():
            break  # padding: the per-step driver never sees these rows
        params, opt_state, m = step(params, opt_state, row, x, y, idx)
        metrics.append(m)
    return params, opt_state, torch.stack(metrics)


def run_multi(cfg, pre, update, opt_state, params, x, y, idx, k, accum=1,
              feed="ordered"):
    fn = ts.make_train_multi_step(cfg, update, pre, k, accum=accum,
                                  feed=feed)
    idx = ts.pad_epoch_indices(idx, k * accum)
    if feed == "ordered":
        x, y = ts.epoch_order_data(x, y, idx)
    metrics = []
    for row in range(0, idx.shape[0], k * accum):
        params, opt_state, m = fn(params, opt_state, row, x, y, idx)
        assert m.shape == (k, 3)
        metrics.append(m)
    return params, opt_state, torch.cat(metrics)


def assert_same_state(a, b):
    (pa, sa), (pb, sb) = a, b
    for key in pa:
        assert torch.equal(pa[key], pb[key]), key
    if sa is not None:
        mu_a, nu_a, count_a = sa
        mu_b, nu_b, count_b = sb
        assert count_a == count_b
        for key in mu_a:
            assert torch.equal(mu_a[key], mu_b[key]), key
            assert torch.equal(nu_a[key], nu_b[key]), key


@pytest.mark.parametrize("impl,accum,feed", [
    ("reference", 1, "ordered"), ("flash", 1, "ordered"),
    ("reference", 2, "ordered"), ("reference", 1, "gather"),
    ("flash", 2, "gather")])
def test_multi_step_matches_per_step_bit_for_bit(impl, accum, feed):
    """k = 3 over 4 optimizer steps (two padded no-op steps) with the fused
    AdamW (its twin): params, both moments, the AdamW count and the per-step
    metrics equal the per-step driver's bit for bit; the padded steps report
    count 0."""
    kw = cfg_kw(attention_impl=impl, pos_encoding="polynomial"
                if impl == "flash" else "rope-mixed")
    cfg = ViTConfig(**kw)
    bundle, pre_args, idx = data(4 * 8 * accum - 4, 8, seed=6)
    pre = ts.make_preprocess(cfg, *pre_args)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    idx = torch.from_numpy(idx)
    results = []
    for run in (run_per_step, run_multi):
        params = port_params(kw, seed=6)
        init, update = adamw(cfg, 4, params)
        extra = dict(k=3, feed=feed) if run is run_multi else {}
        results.append(run(cfg, pre, update, init(params), params, x, y, idx,
                           accum=accum, **extra))
    (p1, s1, m1), (p2, s2, m2) = results
    assert s1[2] == s2[2] == 4
    assert_same_state((p1, s1), (p2, s2))
    assert m2.shape == (6, 3)
    assert torch.equal(m2[:4], m1)
    assert torch.equal(m2[4:], torch.zeros(2, 3))


def test_padded_steps_are_no_ops():
    """A dispatch whose steps are all padding reports count 0 and leaves
    params, both moments and the AdamW count as they were."""
    kw = cfg_kw()
    cfg = ViTConfig(**kw)
    bundle, pre_args, idx = data(16, 8, seed=7)
    pre = ts.make_preprocess(cfg, *pre_args)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    params = port_params(kw, seed=7)
    init, update = adamw(cfg, 2, params)
    fn = ts.make_train_multi_step(cfg, update, pre, 2, feed="gather")
    idx = ts.pad_epoch_indices(torch.from_numpy(idx), 4)
    state = init(params)
    params, state, m = fn(params, state, 0, x, y, idx)
    assert state[2] == 2 and (m[:, 2] == 8).all()
    before = ({k: v.detach().clone() for k, v in params.items()},
              ({k: v.clone() for k, v in state[0].items()},
               {k: v.clone() for k, v in state[1].items()}, state[2]))
    params, state, m = fn(params, state, 2, x, y, idx)
    assert torch.equal(m, torch.zeros(2, 3))
    assert_same_state(before, (params, state))


def jax_multi(kw, idx, bundle, pre_args, k, accum, flat, feed, lr=0.05):
    """The JAX package's k-step driver (make_train_multi_step, or
    make_flat_train_multi_step over vit.apply_stacked) under SGD on a
    1-device mesh; returns (losses per step, params)."""
    jcfg = JaxViTConfig(**kw)
    jparams = jvit.init_params(jax.random.PRNGKey(8), jcfg)
    mesh = make_mesh(batch_size=idx.shape[1], num_devices=1)
    rep = NamedSharding(mesh, P())
    tx = optax.sgd(lr)
    tcfg = JaxTrainConfig(dataset="mnist", batch_size=idx.shape[1])
    pre = jts.make_preprocess(jcfg, *pre_args)
    jidx = jts.pad_epoch_indices(jnp.asarray(idx, jnp.int32), k * accum)
    dx, dy = jnp.asarray(bundle.train_x), jnp.asarray(bundle.train_y)
    if feed == "ordered":
        dx, dy = jts.epoch_order_data(dx, dy, jidx)
    if flat:
        fl = JaxFlattener(jvit.stack_block_params(jparams, jcfg))
        p = fl.flatten(jvit.stack_block_params(jparams, jcfg))
        fn = jts.make_flat_train_multi_step(
            jcfg, tcfg, mesh, tx, pre, k, fl, apply_fn=jvit.apply_stacked,
            accum=accum, feed=feed)
    else:
        p = jparams
        fn = jts.make_train_multi_step(jcfg, tcfg, mesh, tx, pre, k,
                                       accum=accum, feed=feed)
    p, o = jax.device_put(p, rep), jax.device_put(tx.init(p), rep)
    dx, dy = jax.device_put(dx, rep), jax.device_put(dy, rep)
    jidx = jax.device_put(jidx, NamedSharding(mesh, P(None, DATA_AXIS)))
    metrics = []
    for s in range(0, jidx.shape[0], k * accum):
        p, o, m = fn(p, o, jnp.asarray([s], jnp.int32), dx, dy, jidx)
        metrics.append(np.asarray(m))
    p = jax.device_get(p)
    if flat:
        p = jvit.unstack_block_params(fl.unflatten(p), jcfg)
    return np.concatenate(metrics), {key: np.asarray(v) for key, v in
                                     p.items()}


@pytest.mark.parametrize("impl,k,accum,flat,feed", [
    ("reference", 3, 1, False, "gather"), ("reference", 3, 1, False,
                                           "ordered"),
    ("reference", 2, 2, True, "ordered"), ("flash", 3, 1, True, "ordered")])
def test_multi_step_matches_jax_drivers(impl, k, accum, flat, feed):
    """One injected index matrix (4 optimizer steps, the last batch partial)
    through the port's k-step driver and the JAX package's, SGD on both."""
    kw = cfg_kw(attention_impl=impl,
                pos_encoding="polynomial" if impl == "flash" else "rope-mixed")
    bundle, pre_args, idx = data(4 * 8 * accum - 4, 8, seed=8)
    want_m, want_p = jax_multi(kw, idx, bundle, pre_args, k, accum, flat,
                               feed)
    cfg = ViTConfig(**kw)
    params = {key: torch.from_numpy(np.array(v)).requires_grad_()
              for key, v in jvit.init_params(jax.random.PRNGKey(8),
                                             JaxViTConfig(**kw)).items()}
    params, _, got_m = run_multi(
        cfg, ts.make_preprocess(cfg, *pre_args), port_sgd(0.05), None, params,
        torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y),
        torch.from_numpy(idx), k, accum=accum, feed=feed)
    got_m = got_m.numpy()
    assert got_m.shape == want_m.shape
    np.testing.assert_array_equal(got_m[:, 2], want_m[:, 2])
    live = want_m[:, 2] > 0
    np.testing.assert_allclose(got_m[live, 0], want_m[live, 0],
                               rtol=TOL[impl])
    assert np.abs(got_m[:, 1] - want_m[:, 1]).max() <= 1  # argmax near-ties
    for key in params:
        close_to_largest(params[key].detach().numpy(), want_p[key],
                         TOL[impl], err_msg=key)


def csv_rows(log_dir):
    (path,) = glob.glob(f"{log_dir}/*.csv")
    with open(path) as f:
        return list(csv.reader(f))


@pytest.fixture
def small_data(monkeypatch):
    orig = datasets.synthetic
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: orig(
            dataset, n_train=200, n_test=40, seed=seed))


@pytest.mark.parametrize("k,accum", [(4, 1), (3, 2)])
def test_fit_rows_do_not_depend_on_steps_per_dispatch(tmp_path, small_data,
                                                      k, accum):
    """200 examples in batches of 32: 7 rows an epoch, so k = 4 pads a
    step and (3, accum 2) pads two; every CSV row equals the per-step
    driver's, and both runs leave the same moments on disk."""
    cfg = ViTConfig(**cfg_kw(img_size=28, patch_size=7))
    common = dict(dataset="mnist", batch_size=32, epochs=2, grad_accum=accum,
                  synthetic_data=True)
    for name, spd in (("one", 1), ("many", k)):
        loop.fit(cfg, TrainConfig(log_dir=str(tmp_path / name),
                                  ckpt_dir=str(tmp_path / name),
                                  steps_per_dispatch=spd, **common),
                 verbose=False, device="cpu")
    assert csv_rows(tmp_path / "one")[1:] == csv_rows(tmp_path / "many")[1:]
    with np.load(tmp_path / "one" / "mnist_rope-mixed_last.npz") as a, \
            np.load(tmp_path / "many" / "mnist_rope-mixed_last.npz") as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_fit_resumes_under_another_k(tmp_path, small_data):
    """Epoch 1 at k = 1, then --resume for epoch 2 at k = 4: the rows and
    the state on disk of a straight two-epoch run at k = 4."""
    cfg = ViTConfig(**cfg_kw(img_size=28, patch_size=7))
    common = dict(dataset="mnist", batch_size=32, synthetic_data=True)
    straight = dict(log_dir=str(tmp_path / "s"), ckpt_dir=str(tmp_path / "s"))
    split = dict(log_dir=str(tmp_path / "r"), ckpt_dir=str(tmp_path / "r"))
    loop.fit(cfg, TrainConfig(epochs=2, steps_per_dispatch=4, **straight,
                              **common), verbose=False, device="cpu")
    loop.fit(cfg, TrainConfig(epochs=1, steps_per_dispatch=1, **split,
                              **common), verbose=False, device="cpu")
    # epochs=2 keeps the cosine schedule of the straight run
    loop.fit(cfg, TrainConfig(epochs=2, steps_per_dispatch=4, resume=True,
                              **split, **common), verbose=False, device="cpu")
    rows = sorted(glob.glob(f"{tmp_path / 'r'}/*.csv"))
    assert len(rows) in (1, 2)  # one CSV per run; same second -> one file
    resumed = [r for path in rows for r in csv.reader(open(path))
               if r[0] == "2"]
    assert resumed == [csv_rows(tmp_path / "s")[2]]
    with np.load(tmp_path / "s" / "mnist_rope-mixed_last.npz") as a, \
            np.load(tmp_path / "r" / "mnist_rope-mixed_last.npz") as b:
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("live", [1.0, 0.0])
def test_adamw_table_entry_twin(live):
    """adamw_update_table on CPU tensors: the by-value update where the row
    is live, nothing where it is not; update.hyper(count) are the values the
    by-value update uses."""
    gen = torch.Generator().manual_seed(9)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    p = [torch.randn(s, generator=gen) for s in shapes]
    g = [torch.randn(s, generator=gen) for s in shapes]
    mu = [torch.randn(s, generator=gen).abs() for s in shapes]
    nu = [torch.randn(s, generator=gen).abs() for s in shapes]
    lr, c1, c2 = 3e-3, 0.19, 0.002997
    want = [[t.clone() for t in lst] for lst in (p, mu, nu)]
    if live:
        fused_adamw.adamw_update(*want[:1], g, *want[1:], lr, c1, c2)
    row = fused_adamw.hyper_rows([(lr, c1, c2, live)], "cpu")[0]
    fused_adamw.adamw_update_table(p, g, mu, nu, row)
    for got, exp in zip((p, mu, nu), want):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)

    params = {"w": torch.zeros(3)}
    schedule = lambda step: 1e-3 * (0.5 ** step)  # noqa: E731
    _, update = fused_adamw.make_fused_adamw(params, schedule)
    assert update.hyper(3) == (1e-3 * 0.25,
                               *fused_adamw.bias_corrections(3, 0.9, 0.999))


def test_adamw_table_entry_checks_its_row():
    p = [torch.zeros(3)]
    with pytest.raises(ValueError, match="hyper"):
        fused_adamw.adamw_update_table(p, p, p, p, torch.zeros(3))
    with pytest.raises(ValueError, match="hyper"):
        fused_adamw.adamw_update_table(p, p, p, p,
                                       torch.zeros(4, dtype=torch.float64))


def test_launch_counts_helpers(monkeypatch):
    monkeypatch.setattr(fused_adamw, "LAUNCHES_ADAMW", 5)
    monkeypatch.setattr(fused_adamw, "LAUNCHES_ADAMW_TABLE", 0)
    before = launches.counts()
    key = ("vit_rpe_rope_tpu_torch.ops.fused_adamw", "LAUNCHES_ADAMW_TABLE")
    assert before[key] == 0
    assert ("vit_rpe_rope_tpu_torch.ops.flash_attention", "LAUNCHES") in before
    fused_adamw.LAUNCHES_ADAMW_TABLE += 3
    delta = launches.since(before)
    assert delta == {key: 3}
    launches.add(delta, -1)
    assert fused_adamw.LAUNCHES_ADAMW_TABLE == 0
    launches.add(delta, 4)
    assert fused_adamw.LAUNCHES_ADAMW_TABLE == 12 and \
        fused_adamw.LAUNCHES_ADAMW == 5


def test_dispatch_with_draws_runs_eagerly_with_the_per_step_draws():
    """With dropout, the k-step driver draws each row from the row's
    step_generators, as the per-step driver does: the same params."""
    kw = cfg_kw(drop_rate=0.1, drop_path_rate=0.1)
    cfg = ViTConfig(**kw)
    bundle, pre_args, idx = data(32, 8, seed=10)
    pre = ts.make_preprocess(cfg, *pre_args, augment=True)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    idx = torch.from_numpy(idx)
    results = []
    for run in (run_per_step, run_multi):
        params = port_params(kw, seed=10)
        extra = dict(k=2) if run is run_multi else {}
        results.append(run(cfg, pre, port_sgd(0.05), None, params, x, y, idx,
                           **extra))
    (p1, _, m1), (p2, _, m2) = results
    assert torch.equal(m1, m2)
    for key in p1:
        assert torch.equal(p1[key], p2[key]), key
