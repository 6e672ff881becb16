"""PyTorch port, data parallelism and ZeRO-1 over torch.distributed (the
parallel/ subpackage, train_step's mesh= and zero1, fit under a process
group, data-parallel serving), on the CPU.

Two ranks run as subprocesses with torchrun's environment on a free
localhost port, over gloo, one intra-op thread each (tests/torch_dp_worker.py),
once per module fixture: three train steps of each run, then four fits.
Depth 2, embed 32, 2 heads, 16 px (MNIST's 28 px shrunk: the antialiased
resize), the unfused attention ("reference").

Tolerances:
* the ranks agree bit for bit (they apply one summed gradient);
* two ranks against one process on the same global batch (SGD, linear in
  the gradient): each parameter update within DP_TOL of the largest update
  entry, the losses within rtol DP_TOL (float32 sums in another order: half
  batches, then the sum over ranks); the mutants (dividing by the local
  count, skipping the all-reduce) miss that bound by more than 10x;
* ZeRO-1 against the replicated AdamW on the same gradients: bit for bit
  (the update is elementwise; the slices are gathered exactly);
* ZeRO-1 against the JAX make_flat_train_multi_step(zero1=True) on a
  2-device mesh: losses within rtol JAX_TOL, both moments within JAX_TOL of
  their largest entry, each param within JAX_TOL of the largest update
  entry plus its share of AdamW's normalisation: a gradient error of
  JAX_TOL of the largest gradient, divided by the entry's own scale
  sqrt(nu), twice a step (float32 sums in another order: the JAX package's
  psum and its XLA-fused forward).
"""

import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel import mesh as jmesh
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu.utils.flatten import Flattener as JaxFlattener
from vit_rpe_rope_tpu_torch import serving
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import fused_adamw
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import mesh as tmesh
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_dp_worker.py"
WORKER_TIMEOUT = 240  # seconds for one two-rank launch

DP_TOL = 1e-5
JAX_TOL = 1e-5

KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=32, depth=2,
          num_heads=2, pos_encoding="rope-axial", attention_impl="reference")
BATCH, STEPS, EPOCHS, LR, SGD_LR = 16, 3, 2, 1e-3, 0.05
REAL_RUNS = ("dp_sgd", "dp_sgd_accum2", "dp_adamw", "zero1")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode: str, out: pathlib.Path, world: int = 2):
    """Run `world` ranks of the worker; raise with their output if one
    fails or the launch outlasts WORKER_TIMEOUT."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), mode, str(out)], cwd=out,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {mode} failed:\n{log}"


def init_params(seed=0):
    """The JAX package's init, moved over with numpy."""
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**KW))
    return {k: np.array(v) for k, v in jparams.items()}


def inputs():
    bundle = datasets.synthetic("mnist", n_train=88, n_test=8, seed=7)
    order = np.random.default_rng(7).permutation(88)
    slots = np.full(6 * BATCH, -1, np.int64)
    # rows 2 and 5 partial, their padding in both ranks' halves
    pad = {2 * BATCH + 3, 2 * BATCH + 12, 5 * BATCH + 1, 5 * BATCH + 9,
           5 * BATCH + 10, 5 * BATCH + 14, 4 * BATCH + 15, 3 * BATCH}
    slots[[i for i in range(6 * BATCH) if i not in pad]] = order
    return bundle, slots.reshape(6, BATCH)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_steps")
    bundle, idx = inputs()
    params = init_params()
    (out / "config.json").write_text(json.dumps(dict(
        cfg=KW, batch=BATCH, steps=STEPS, epochs=EPOCHS, lr=LR,
        sgd_lr=SGD_LR)))
    np.savez(out / "inputs.npz", train_x=bundle.train_x,
             train_y=bundle.train_y, idx=idx, mean=np.float32(bundle.mean),
             std=np.float32(bundle.std),
             **{f"p:{k}": v for k, v in params.items()})
    launch("steps", out)

    def read(name, rank):
        with np.load(out / f"{name}_rank{rank}.npz") as z:
            return {k: z[k] for k in z.files}

    return dict(bundle=bundle, idx=idx, params=params,
                runs={(name, rank): read(name, rank)
                      for name in (*REAL_RUNS, "mutant_local_count",
                                   "mutant_no_all_reduce")
                      for rank in (0, 1)})


def one_process(steps, accum):
    """The port's one-process run of the same SGD steps."""
    bundle, idx = steps["bundle"], torch.from_numpy(steps["idx"])
    cfg = ViTConfig(**KW)
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in steps["params"].items()}

    def sgd(grads, state, params):
        with torch.no_grad():
            for key in params:
                params[key].sub_(SGD_LR * grads[key])
        return params, state

    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    step = ts.make_train_step(cfg, sgd, pre, accum=accum)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    metrics = []
    for s in range(STEPS):
        params, _, m = step(params, None, s * accum, x, y, idx)
        metrics.append(m.numpy())
    return ({k: v.detach().numpy() for k, v in params.items()},
            np.stack(metrics))


def update_err(got, want, init):
    """Largest difference of the parameter updates, relative to the largest
    update entry."""
    keys = list(init)
    d_got = np.concatenate([(got[f"p:{k}"] - init[k]).ravel() for k in keys])
    d_want = np.concatenate([(want[k] - init[k]).ravel() for k in keys])
    return float(np.abs(d_got - d_want).max() / np.abs(d_want).max())


@pytest.mark.parametrize("run", REAL_RUNS)
def test_ranks_agree_bit_for_bit(steps, run):
    a, b = steps["runs"][run, 0], steps["runs"][run, 1]
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("run,accum", [("dp_sgd", 1), ("dp_sgd_accum2", 2)])
def test_two_ranks_match_one_process(steps, run, accum):
    want_p, want_m = one_process(steps, accum)
    got = steps["runs"][run, 0]
    assert update_err(got, want_p, steps["params"]) < DP_TOL
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0],
                               rtol=DP_TOL)
    np.testing.assert_array_equal(got["metrics"][:, 1:], want_m[:, 1:])
    counts = got["metrics"][:, 2]
    assert list(counts) == ([16, 16, 14] if accum == 1 else [32, 29, 27])


@pytest.mark.parametrize("mutant", ["mutant_local_count",
                                    "mutant_no_all_reduce"])
def test_mutants_miss_the_dp_bound(steps, mutant):
    want_p, _ = one_process(steps, 1)
    err = update_err(steps["runs"][mutant, 0], want_p, steps["params"])
    assert err > 10 * DP_TOL, err


def test_zero1_matches_replicated_adamw_bit_for_bit(steps):
    dp, z = steps["runs"]["dp_adamw", 0], steps["runs"]["zero1", 0]
    assert set(dp) == set(z) and int(z["count"]) == STEPS
    for key in dp:
        np.testing.assert_array_equal(z[key], dp[key], err_msg=key)


def test_zero1_matches_jax_zero1_on_a_two_device_mesh(steps):
    """The port's two-rank ZeRO-1 run against the JAX package's flat k-step
    driver with zero1=True on a 2-device mesh: the same params, the same
    index matrix, the same schedule."""
    bundle, idx = steps["bundle"], steps["idx"]
    jcfg = JaxViTConfig(**KW)
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=EPOCHS,
                           lr=LR)
    mesh = jmesh.make_mesh(batch_size=BATCH, num_devices=2)
    rep = NamedSharding(mesh, P())
    tx = jts.make_optimizer(jtcfg, STEPS)
    # sorted keys: the JAX loop's params come back from jax.device_put so
    jparams = {k: jnp.asarray(v) for k, v in sorted(steps["params"].items())}
    flattener = JaxFlattener(jvit.stack_block_params(jparams, jcfg))
    flat0 = jax.device_put(flattener.flatten(
        jvit.stack_block_params(jparams, jcfg)), rep)
    opt, _ = jts.init_zero1_opt_state(tx, flattener, mesh)
    fn = jts.make_flat_train_multi_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), STEPS,
        flattener, apply_fn=jvit.apply_stacked, guard_padded_steps=False,
        zero1=True)
    p, o, m = fn(flat0, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))
    want_p, want_m = np.asarray(p), np.asarray(m)
    adam = o[0]
    want_mu = np.asarray(adam.mu)[:flattener.total]
    want_nu = np.asarray(adam.nu)[:flattener.total]

    got = steps["runs"]["zero1", 0]
    cfg = ViTConfig(**KW)
    layout = ts.flat_layout({k: torch.from_numpy(v)
                             for k, v in steps["params"].items()}, cfg)
    got_p = np.concatenate([got[f"p:{k}"].ravel() for k in layout.keys])
    p0 = np.concatenate([steps["params"][k].ravel() for k in layout.keys])
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0],
                               rtol=JAX_TOL)
    np.testing.assert_array_equal(got["metrics"][:, 2], want_m[:, 2])
    for name, g, w in (("mu", got["mu"], want_mu), ("nu", got["nu"],
                                                    want_nu)):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=JAX_TOL * np.abs(w).max(),
                                   err_msg=name)
    # AdamW divides each entry's gradient by the entry's own scale
    # sqrt(nu): a gradient error of JAX_TOL of the largest moves entry i by
    # up to 2 lr JAX_TOL max(sqrt(nu)) / sqrt(nu_i) a step.
    scale = np.sqrt(want_nu)
    bound = (JAX_TOL * np.abs(want_p - p0).max()
             + 2 * STEPS * LR * JAX_TOL * scale.max()
             / np.maximum(scale, 1e-30))
    np.testing.assert_array_less(np.abs(got_p - want_p), bound)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = tmp_path_factory.mktemp("dp_fit")
    launch("fit", out)
    return out, [json.loads((out / f"fit_rank{r}.json").read_text())
                 for r in (0, 1)]


def rows(history):
    """A fit's history without its host-clock throughput."""
    return [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in history]


def test_fit_writes_one_csv_and_one_best_checkpoint(fits):
    out, (lead, other) = fits
    for run in lead:
        assert lead[run]["num_devices"] == other[run]["num_devices"] == 2
        assert other[run]["log_file"] is None
        assert other[run]["ckpt_path"] is None
        assert rows(lead[run]["history"]) == rows(other[run]["history"])
    for name in ("zero1", "dp"):
        for epochs in (1, 2):
            csvs = list((out / name / f"logs{epochs}").glob("*.csv"))
            assert [str(p) for p in csvs] == [
                lead[f"{name}_{epochs}"]["log_file"]]
            assert len(csvs[0].read_text().splitlines()) == 2
        assert sorted(p.name for p in (out / name / "ckpts").iterdir()) \
            == ["last_epoch1.npz", "last_epoch2.npz",
                "mnist_rope-axial_best.npz", "mnist_rope-axial_last.npz"]


def last_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_last_state_is_the_same_with_and_without_zero1(fits):
    """After one epoch (--zero1 on / off) and after each run resumed with
    --zero1 toggled, the two `_last.npz` hold the same bits: ZeRO-1's
    moments gathered and trimmed are the replicated optimizer's."""
    out, (lead, _) = fits
    for epochs in (1, 2):
        z = last_state(out / "zero1" / "ckpts" / f"last_epoch{epochs}.npz")
        d = last_state(out / "dp" / "ckpts" / f"last_epoch{epochs}.npz")
        assert set(z) == set(d) and int(z["__epoch"]) == epochs - 1
        assert int(z["__opt.0"]) == 3 * epochs
        for key in z:
            np.testing.assert_array_equal(z[key], d[key], err_msg=key)
    assert [h["epoch"] for h in lead["zero1_2"]["history"]] == [2]
    assert rows(lead["zero1_2"]["history"]) == rows(lead["dp_2"]["history"])


def test_last_state_resumes_at_world_size_1(fits, monkeypatch):
    """The two-rank `_last.npz` resumes in one process, with and without
    --zero1, to the same third epoch."""
    out, _ = fits

    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=96, n_test=32, seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)
    runs = {}
    for name, zero1 in (("zero1", True), ("dp", False)):
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=3,
                           synthetic_data=True, seed=0, zero1=zero1,
                           resume=True, log_dir=str(out / name / "logs3"),
                           ckpt_dir=str(out / name / "ckpts"))
        runs[name] = loop.fit(ViTConfig(**KW), tcfg, verbose=False,
                              device="cpu")
        assert runs[name]["num_devices"] == 1
        assert [h["epoch"] for h in runs[name]["history"]] == [3]
    assert runs["zero1"]["history"][0]["train_loss"] == \
        runs["dp"]["history"][0]["train_loss"]
    z = last_state(out / "zero1" / "ckpts" / "mnist_rope-axial_last.npz")
    d = last_state(out / "dp" / "ckpts" / "mnist_rope-axial_last.npz")
    assert int(z["__opt.0"]) == 9 and int(z["__epoch"]) == 2
    for key in z:
        np.testing.assert_array_equal(z[key], d[key], err_msg=key)


# ---- unit cases, no processes ----

@pytest.mark.parametrize("total,n", [(1000, 1), (1000, 2), (1001, 2),
                                     (1001, 8), (7, 8), (33_290, 3)])
def test_zero1_shard_size_and_layout_match_jax(total, n):
    """The shard size, and each rank's moment slice over the model's flat
    vector against the JAX init_zero1_opt_state's padded vector and its
    per-device shards on an n-device mesh."""
    shard = ts.zero1_shard_size(total, n)
    assert shard == jts.zero1_shard_size(total, n)
    assert shard * n >= total > (shard - 1) * n
    params = init_params()
    flat = ts.flat_layout({k: torch.from_numpy(v) for k, v in params.items()},
                          ViTConfig(**KW))
    jflat = JaxFlattener(jvit.stack_block_params(
        {k: jnp.asarray(v) for k, v in sorted(params.items())},
        JaxViTConfig(**KW)))
    assert flat.total == jflat.total
    shard = ts.zero1_shard_size(flat.total, n)
    jopt, _ = jts.init_zero1_opt_state(
        jts.make_optimizer(JaxTrainConfig(dataset="mnist"), 1), jflat,
        jmesh.make_mesh(num_devices=n))
    assert jopt[0].mu.shape == (shard * n,)
    assert {s.data.shape for s in jopt[0].mu.addressable_shards} \
        == {(shard,)}
    group = tmesh.Mesh(devices=(torch.device("cpu"),), ranks=tuple(range(n)))
    mu, nu, count = ts.init_zero1_opt_state(flat, group, "cpu")
    assert mu.shape == nu.shape == (shard,) and count == 0


@pytest.mark.parametrize("entry", ["by_value", "table_live",
                                   "table_not_live"])
def test_zero1_one_leaf_template_through_both_adamw_entries(entry):
    """Without a process group ZeRO-1 runs the AdamW kernel's wrapper (its
    plain twin here) over one flat slice, a one-leaf template, through the
    by-value entry (update) and the device-table entry (from_table, a row
    of hyper_rows): bit for bit the replicated optimizer's update, or none
    where the row is not live."""
    cfg = ViTConfig(**KW)
    init = init_params(3)
    gen = torch.Generator().manual_seed(3)
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in init.items()}
    schedule = lambda count: 1e-3 * (1.0 - count / 10)  # noqa: E731
    results = {}
    for name in ("replicated", "zero1"):
        params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
        if name == "replicated":
            opt_init, update = fused_adamw.make_fused_adamw(params, schedule)
        else:
            opt_init, update = ts.make_zero1_adamw(params, cfg, schedule)
        state = opt_init(params)
        for _ in range(2):  # the second step sees nonzero moments
            params, state = update(grads, state, params)
        if entry != "by_value":
            live = entry == "table_live"
            row = fused_adamw.hyper_rows(
                [(*update.hyper(state[2] + 1), float(live))], "cpu")[0]
            params, state = update.from_table(grads, state, params, row)
        results[name] = params, state
    (p_rep, (mu_rep, _, count_rep)), (p_z, (mu_z, _, count_z)) = \
        results["replicated"], results["zero1"]
    assert count_rep == count_z == 2 and mu_z.shape == (ts.flat_layout(
        p_rep, cfg).total,)
    for key in p_rep:
        torch.testing.assert_close(p_z[key], p_rep[key], rtol=0, atol=0)
    flat = ts.flat_layout(p_rep, cfg)
    torch.testing.assert_close(mu_z, flat.flatten(mu_rep), rtol=0, atol=0)


def test_flat_layout_is_the_disk_layout_of_jax():
    """flat_layout over the reference keys flattens to the vector that
    loop.moment_flattener (over the depth-stacked keys) gives, which is the
    JAX package's flat vector."""
    params = {k: torch.from_numpy(v) for k, v in init_params(1).items()}
    cfg = ViTConfig(**KW)
    got = ts.flat_layout(params, cfg).flatten(params)
    disk = loop.moment_flattener(params, cfg)
    want = disk.flatten(vit.stack_block_params(
        dict(sorted(params.items())), cfg))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jflat = JaxFlattener(jvit.stack_block_params(
        jax.device_put(jparams), JaxViTConfig(**KW)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jflat.flatten(jvit.stack_block_params(
            jax.device_put(jparams), JaxViTConfig(**KW)))))


@pytest.mark.parametrize("batch,world,ok", [(128, 2, True), (128, 3, False),
                                            (129, 3, True), (5, 2, False)])
def test_make_mesh_needs_the_world_size_to_divide_the_batch(monkeypatch,
                                                            batch, world, ok):
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "rank", lambda: world - 1)
    monkeypatch.setattr(distributed, "device", lambda: torch.device("cpu"))
    if not ok:
        with pytest.raises(ValueError,
                           match=f"batch_size {batch} .* world size {world}"):
            tmesh.make_mesh(batch_size=batch)
        return
    mesh = tmesh.make_mesh(batch_size=batch)
    assert mesh.shape == {tmesh.DATA_AXIS: world} and mesh.distributed
    assert mesh.rank == world - 1
    assert ts._columns(mesh, batch) == slice((world - 1) * (batch // world),
                                             batch)


@pytest.mark.parametrize("kw,match", [
    (dict(seq_parallel=2), "the context-parallel ring"),
    (dict(pipe_parallel=2), "GPipe pipeline parallelism")])
def test_make_mesh_refuses_the_other_axes_by_name(kw, match):
    """The sequence and pipe axes are ported
    (tests/test_torch_context_parallel.py,
    tests/test_torch_pipeline_parallel.py): in one process seq_parallel 2
    or pipe_parallel 2 does not divide the world (the JAX make_mesh's
    ValueError), and the compositions with a sequence axis (with a model
    axis, or with a pipe axis) are refused, naming Queue A's
    compositions. (`match` names the Queue A item that ported the axis.)"""
    del match
    seq, pipe = kw.get("seq_parallel", 1), kw.get("pipe_parallel", 1)
    with pytest.raises(ValueError, match=f"device count 1 not divisible "
                       f"by model_parallel=1 × seq_parallel={seq} × "
                       f"pipe_parallel={pipe}"):
        tmesh.make_mesh(**kw)
    other = dict(model_parallel=2) if seq > 1 else dict(seq_parallel=2)
    with pytest.raises(NotImplementedError, match="the compositions"):
        tmesh.make_mesh(**other, **kw)


def test_make_mesh_takes_the_model_axis(monkeypatch):
    """model_parallel is ported (tests/test_torch_tensor_parallel.py): on
    a process group of 6 ranks with model_parallel 2, rank 5 is data rank
    2 of 3 (the data axis the data-parallel code reads as mesh.rank and
    mesh.size) and model rank 1, takes the last third of each batch, and
    the data width (not the world size) must divide the batch."""
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: 6)
    monkeypatch.setattr(distributed, "rank", lambda: 5)
    monkeypatch.setattr(distributed, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(distributed, "new_group", lambda ranks: tuple(ranks))
    mesh = tmesh.make_mesh(batch_size=12, model_parallel=2)
    assert mesh.shape == {tmesh.DATA_AXIS: 3, tmesh.MODEL_AXIS: 2}
    assert (mesh.rank, mesh.size, mesh.model_rank) == (2, 3, 1)
    assert ts._columns(mesh, 12) == slice(8, 12)
    assert ts._world(mesh) == (2, 3)
    assert (mesh.data_group, mesh.model_group) == ((1, 3, 5), (4, 5))
    with pytest.raises(ValueError, match="multiple of the data width 3"):
        tmesh.make_mesh(batch_size=8, model_parallel=2)


def test_local_mesh_takes_the_devices_that_divide_the_batch():
    cpus = [torch.device("cpu")] * 4
    assert tmesh.make_mesh(num_devices=3, devices=cpus).size == 3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mesh = tmesh.make_mesh(batch_size=6, devices=cpus)
    assert mesh.size == 2 and not mesh.distributed and mesh.rank == 0
    assert "using 2 of 4 devices" in str(caught[0].message)


def test_initialize_without_torchrun_is_the_one_device_run(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert distributed.initialize() is False
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.device() is None
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(ValueError, match="MASTER_PORT"):
        distributed.initialize(device="cpu")


@pytest.mark.parametrize("n", [1, 3, 5])
def test_sharded_predictor_matches_one_device(n):
    """A ragged batch over a 2-entry CPU mesh (padded with zero images to a
    multiple of 2, split into equal shards) gives the one-device logits."""
    cfg = ViTConfig(**KW)
    params = init_params(2)
    mean, std = datasets.NORMALIZATION["mnist"]
    images = np.random.default_rng(n).integers(0, 256, (n, 28, 28, 1),
                                               dtype=np.uint8)
    one = serving.Predictor.from_params(params, cfg, mean, std, 28,
                                        device="cpu")
    mesh = tmesh.make_mesh(num_devices=2, devices=["cpu", "cpu"])
    seen = []
    sharded = serving.Predictor.from_params(params, cfg, mean, std, 28,
                                            mesh=mesh)
    inner = sharded._call
    sharded._call = lambda x: seen.append(tuple(x.shape)) or inner(x)
    got = sharded.logits(images)
    assert seen == [(n + n % 2, 28, 28, 1)] and got.shape == (n, 10)
    np.testing.assert_allclose(got, one.logits(images), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(sharded.predict(images),
                                  one.predict(images))
