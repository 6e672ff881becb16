"""PyTorch port, the JAX package's fused dispatch on the CPU: the auto rule
for steps and evaluation rows per dispatch, k-row evaluation
(train_step.make_eval_step(k=)) and the per-row seeds the CUDA-graph steps
re-seed their generators with. On the CPU every k-step or k-row dispatch
runs eagerly, the plain version of the graph the card replays.

* train_step.resolve_steps_per_dispatch against the JAX loop's rule, read
  from the JAX fit itself (loop.py:193-200 for the train k, :537-543 for
  the evaluation's), its backend set to "tpu" or "cpu" (the card or the
  CPU for the port), with and without --q_chunk;
* make_eval_step(k=3) over padded rows, bit for bit against three k = 1
  calls, and against the JAX make_eval_step(k=3) on one injected index
  matrix: 1e-5 relative on the unfused attention (float32 sums in another
  order), 2e-3 on the kernels' twins against the Pallas kernels in
  interpret mode (bf16 operands that can round the other way); the correct
  counts within one (argmax near-ties);
* row_seeds: generators seeded with them draw step_generators' bits;
* fit at steps_per_dispatch 0 on the CPU takes k = 1 and writes the k = 1
  CSV row, and with k > 1 forced for the steps and the evaluation rows on
  the CPU (eager, both padded) the same row.
"""

import csv
import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P, make_mesh
from vit_rpe_rope_tpu.train import loop as jloop
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TOL = {"reference": 1e-5, "flash": 2e-3}


def cfg_kw(**kw):
    d = dict(img_size=28, patch_size=7, in_chans=1, embed_dim=32, depth=2,
             num_heads=2, pos_encoding="rope-mixed",
             attention_impl="reference")
    d.update(kw)
    return d


class _Reached(Exception):
    pass


def jax_rule(monkeypatch, tmp_path, backend, steps, eval_steps, spd=0,
             q_chunk=0):
    """(train k, evaluation k) that the JAX fit picks under `backend` for an
    epoch of `steps` batches of 4 and `eval_steps` test batches: the stride
    its first _run_epoch call gets, and the k its eval_idx is padded to.
    The fit stops at that first call."""
    seen = {}
    real_pad = jts.pad_epoch_indices

    def pad(epoch_idx, k):
        seen.setdefault("eval", k)  # the evaluation's rows are padded first
        return real_pad(epoch_idx, k)

    def run_epoch(*args, k=1, **kw):
        seen["train"] = k
        raise _Reached

    synthetic = jdatasets.synthetic
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(jts, "pad_epoch_indices", pad)
    monkeypatch.setattr(jloop, "_run_epoch", run_epoch)
    monkeypatch.setattr(
        jdatasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: synthetic(
            dataset, n_train=4 * steps, n_test=4 * eval_steps, seed=seed))
    jcfg = JaxViTConfig(**cfg_kw(depth=1, attention_impl="flash"))
    tcfg = JaxTrainConfig(dataset="mnist", batch_size=4, epochs=1,
                          synthetic_data=True, steps_per_dispatch=spd,
                          q_chunk=q_chunk, log_dir=str(tmp_path),
                          ckpt_dir=str(tmp_path))
    with pytest.raises(_Reached):
        jloop.fit(jcfg, tcfg, verbose=False)
    return seen["train"], seen["eval"]


@pytest.mark.parametrize("backend,device,steps,eval_steps,spd,q_chunk", [
    ("tpu", "cuda", 100, 20, 0, 0), ("tpu", "cuda", 37, 6, 0, 0),
    ("tpu", "cuda", 12, 40, 50, 0), ("cpu", "cpu", 100, 20, 0, 0),
    ("cpu", "cpu", 7, 5, 4, 0), ("tpu", "cuda", 12, 8, 0, 64)])
def test_auto_rule_matches_the_jax_loop(monkeypatch, tmp_path, backend,
                                        device, steps, eval_steps, spd,
                                        q_chunk):
    """The JAX package's accelerator is the port's card: auto picks the
    largest divisor up to 32 there and 1 on the CPU, an explicit k is
    capped at the epoch's steps, and the bounded driver takes 1."""
    want = jax_rule(monkeypatch, tmp_path, backend, steps, eval_steps, spd,
                    q_chunk)
    got = (ts.resolve_steps_per_dispatch(spd, steps, device, q_chunk > 0),
           ts.resolve_steps_per_dispatch(0, eval_steps, device, q_chunk > 0))
    assert got == want


def eval_data(impl, seed=11):
    kw = cfg_kw(attention_impl=impl, pos_encoding="polynomial"
                if impl == "flash" else "rope-mixed")
    bundle = datasets.synthetic("mnist", n_train=8, n_test=30, seed=seed)
    idx = np.full((9, 4), -1, np.int64)  # 8 rows (the last partial), 1 pad
    idx.reshape(-1)[:30] = np.random.default_rng(seed).permutation(30)
    return kw, bundle, idx


def port_eval(kw, bundle, idx, k, seed=11):
    cfg = ViTConfig(**kw)
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    params = {key: torch.from_numpy(np.array(v)) for key, v in jparams.items()}
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    step = ts.make_eval_step(cfg, pre, k=k)
    x, y = torch.from_numpy(bundle.test_x), torch.from_numpy(bundle.test_y)
    idx = torch.from_numpy(idx)
    return torch.cat([step(params, row, x, y, idx).reshape(-1, 3)
                      for row in range(0, idx.shape[0], k)]).numpy()


def test_eval_k_rows_equal_k1_calls_bit_for_bit():
    """Three rows a call over 9 index rows (the eighth partial, the ninth
    padding): every row of the k = 1 calls, bit for bit; the padded row
    reports count 0 and loss 0."""
    kw, bundle, idx = eval_data("reference")
    one = port_eval(kw, bundle, idx, 1)
    three = port_eval(kw, bundle, idx, 3)
    assert three.shape == (9, 3)
    np.testing.assert_array_equal(three, one)
    np.testing.assert_array_equal(three[8], [0.0, 0.0, 0.0])
    assert three[7, 2] == 2.0


@pytest.mark.parametrize("impl", ["reference", "flash"])
def test_eval_k_rows_match_jax_make_eval_step(impl):
    kw, bundle, idx = eval_data(impl)
    jcfg = JaxViTConfig(**kw)
    mesh = make_mesh(batch_size=4, num_devices=1)
    rep = NamedSharding(mesh, P())
    fn = jts.make_eval_step(jcfg, mesh, jts.make_preprocess(
        jcfg, bundle.mean, bundle.std, 28), k=3)
    params = jax.device_put(jvit.init_params(jax.random.PRNGKey(11), jcfg),
                            rep)
    dx, dy = (jax.device_put(jnp.asarray(a), rep)
              for a in (bundle.test_x, bundle.test_y))
    jidx = jax.device_put(jnp.asarray(idx, jnp.int32),
                          NamedSharding(mesh, P(None, DATA_AXIS)))
    want = np.concatenate([
        np.asarray(fn(params, jnp.asarray([s], jnp.int32), dx, dy, jidx))
        for s in range(0, 9, 3)])
    got = port_eval(kw, bundle, idx, 3)
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=TOL[impl])
    assert np.abs(got[:, 1] - want[:, 1]).max() <= 1  # argmax near-ties


@pytest.mark.parametrize("rank,model_rank", [(0, None), (3, None), (1, 0),
                                             (0, 2)])
def test_row_seeds_draw_as_step_generators(rank, model_rank):
    """Generators seeded with row_seeds draw step_generators' bits: the
    augmentation's draws, the dropout masks, and under tensor parallelism
    the local stream's."""
    def flat(gens):
        return gens if model_rank is None else (gens[0], *gens[1])

    for row in (0, 5, 17):
        want = flat(ts.step_generators(7, 2, row, "cpu", rank, model_rank))
        seeds = ts.row_seeds(7, 2, row, rank, model_rank)
        assert len(seeds) == len(want) == (2 if model_rank is None else 3)
        assert all(0 <= s < 1 << 63 for s in seeds)
        got = [torch.Generator().manual_seed(s) for s in seeds]
        for a, b in zip(got, want):
            assert torch.equal(ts.augment_draws(a, 16)[0],
                               ts.augment_draws(b, 16)[0])
            assert torch.equal(torch.rand(64, generator=a),
                               torch.rand(64, generator=b))
    assert ts.row_seeds(7, 2, 0) != ts.row_seeds(7, 2, 1)


def csv_rows(log_dir):
    (path,) = glob.glob(f"{log_dir}/*.csv")
    with open(path) as f:
        return list(csv.reader(f))[1:]


@pytest.fixture
def small_data(monkeypatch):
    orig = datasets.synthetic
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: orig(
            dataset, n_train=192, n_test=150, seed=seed))


def test_fit_auto_on_the_cpu_and_forced_k_give_the_k1_row(
        tmp_path, small_data, monkeypatch):
    """192 examples in batches of 32 (6 steps), 150 test images (5 rows,
    the last partial), with dropout and the augmentation: auto on the CPU
    is k = 1 for both and writes the k = 1 row; k = 4 steps and 3
    evaluation rows a dispatch forced on the CPU (eager, the steps padded
    by two, the rows by one) write it too."""
    cfg = ViTConfig(**cfg_kw(drop_rate=0.1))
    common = dict(dataset="mnist", batch_size=32, epochs=1,
                  synthetic_data=True, augment=True)
    runs = {}
    for name, spd in (("one", 1), ("auto", 0)):
        runs[name] = loop.fit(cfg, TrainConfig(
            log_dir=str(tmp_path / name), ckpt_dir=str(tmp_path / name),
            steps_per_dispatch=spd, **common), verbose=False, device="cpu")
    assert (runs["auto"]["steps_per_dispatch"],
            runs["auto"]["eval_rows_per_dispatch"]) == (1, 1)
    assert runs["auto"]["capture_seconds"] is None
    assert runs["auto"]["eval_capture_seconds"] is None
    monkeypatch.setattr(ts, "resolve_steps_per_dispatch",
                        lambda k, steps, device, bounded=False:
                        {6: 4, 5: 3}[steps])
    forced = loop.fit(cfg, TrainConfig(
        log_dir=str(tmp_path / "forced"), ckpt_dir=str(tmp_path / "forced"),
        steps_per_dispatch=0, **common), verbose=False, device="cpu")
    assert (forced["steps_per_dispatch"],
            forced["eval_rows_per_dispatch"]) == (4, 3)
    rows = csv_rows(tmp_path / "one")
    assert csv_rows(tmp_path / "auto") == rows
    assert csv_rows(tmp_path / "forced") == rows
