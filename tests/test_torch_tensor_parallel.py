"""PyTorch port, tensor parallelism over torch.distributed
(parallel/tensor_parallel.py, the model axis of parallel/mesh.py,
train_step.make_train_step on a model axis, ZeRO-1 x TP, fit with
model_parallel), on the CPU.

Ranks run as subprocesses with torchrun's environment on a free localhost
port, over gloo, one intra-op thread each (tests/torch_tp_worker.py), once
per module fixture: two ranks (model_parallel 2) for the train steps, four
(data 2 x model 2) for the fits. The model is the JAX tests' small_cfg
(tests/test_tensor_parallel.py): 16 px, patch 4, embed 64, depth 2, 4
heads, the unfused attention ("reference"); the streaming cases take the
kernels' twins ("flash") at 48 px (N = 145) with STREAMING_THRESHOLD
lowered to 128 in both processes, so that the generated relative bias's
per-head table and rope-mixed's per-head rotation tables are sliced.

Tolerances:
* against the port's one-device run on the same inputs (SGD, linear in
  the gradient): the logits within TP_TOL of their largest entry, each
  parameter update within TP_TOL of the largest update entry, the losses
  within rtol TP_TOL (float32 sums in another order: the projection's and
  fc2's partial products summed over the ranks); the mutants (no PE-param
  sum over the model axis, no all-reduce in f's backward) miss that bound
  by more than 10x. On the kernels' twins ("flash": products of operands
  rounded to bfloat16, as on the card) within FLASH_TP_TOL instead: a
  float32-order difference in q, k or v flips the bfloat16 rounding of
  some entries (2^-9 of the entry);
* ZeRO-1 x TP against TP with the replicated AdamW, remat "full" against
  remat off, the ranks' replicated params against each other: bit for bit;
* against the JAX make_tp_train_step on a 1 x 2 mesh (AdamW): losses within
  rtol JAX_TOL, each param within JAX_TOL of the largest update entry plus
  its share of AdamW's normalisation (as tests/test_torch_data_parallel.py
  bounds ZeRO-1 against JAX).
"""

import contextlib
import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel import mesh as jmesh
from vit_rpe_rope_tpu.parallel import tensor_parallel as jtp
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import mesh as tmesh
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel as tp
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

from torch_tp_worker import launch

TP_TOL = 1e-5
FLASH_TP_TOL = 2e-4
JAX_TOL = 1e-5

KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
          num_heads=4, attention_impl="reference")
STREAM_KW = dict(KW, img_size=48, attention_impl="flash")  # N = 145
PE_MODES = ("none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed")
BATCH, STEPS, OPT_STEPS, LR, SGD_LR = 16, 3, 2, 1e-3, 0.05
REGULARISED = dict(drop_rate=0.1, drop_path_rate=0.1, attn_drop_rate=0.1)


def spec(pe="rope-mixed", opt="sgd", steps=STEPS, kw=KW, **extra):
    cfg = dict(kw, pos_encoding=pe, **{k: v for k, v in extra.items()
                                       if k in ViTConfig.__dataclass_fields__})
    out = dict(cfg=cfg, opt=opt, steps=steps)
    out.update({k: v for k, v in extra.items() if k not in cfg})
    return out


RUNS = {
    **{f"sgd_{pe}": spec(pe) for pe in PE_MODES},
    "sgd_accum2": spec(accum=2),
    "remat_full": spec(remat=True, remat_policy="full"),
    "multi_step": spec(k=STEPS),
    **{f"stream_{pe}": spec(pe, kw=STREAM_KW, threshold=128)
       for pe in ("relative", "rope-mixed")},
    "flash_relative": spec("relative", kw=dict(KW, attention_impl="flash")),
    "adamw": spec(opt="adamw", steps=OPT_STEPS),
    "zero1": spec(opt="zero1", steps=OPT_STEPS),
    "dropout": spec(steps=2, **REGULARISED),
    "dropout_remat": spec(steps=2, remat=True, **REGULARISED),
    "mutant_no_model_sync": spec(mutant="no_model_sync"),
    "mutant_no_f_bwd": spec(mutant="no_f_bwd"),
}
ONE_DEVICE = [r for r in RUNS if r.startswith(("sgd_", "stream_", "flash_"))]


@contextlib.contextmanager
def one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def one_thread():
    # module fixtures are set up before this one: they take the context
    with one_intra_op_thread():
        yield


def init_params(kw, seed=0):
    """The JAX package's init, carried over by utils/convert."""
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    full = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                           ViTConfig(**kw))
    return {k: full[k].numpy() for k in jparams}


@functools.lru_cache(maxsize=None)
def run_init(pe, img_size, jax_init=False):
    """A run's initial params, which depend on its PE mode and image size
    alone (the widths are KW's): the port's init, or (for the runs held to
    the JAX make_tp_train_step) the JAX package's, carried over."""
    kw = dict(KW, pos_encoding=pe, img_size=img_size)
    if jax_init:
        return init_params(kw)
    return {k: v.numpy() for k, v in vit.init_params(
        torch.Generator().manual_seed(0), ViTConfig(**kw),
        device="cpu").items()}


def inputs():
    bundle = datasets.synthetic("mnist", n_train=88, n_test=8, seed=7)
    order = np.random.default_rng(7).permutation(88)
    slots = np.full(6 * BATCH, -1, np.int64)
    pad = {2 * BATCH + 3, 2 * BATCH + 12, 5 * BATCH + 1, 5 * BATCH + 9,
           5 * BATCH + 10, 5 * BATCH + 14, 4 * BATCH + 15, 3 * BATCH}
    slots[[i for i in range(6 * BATCH) if i not in pad]] = order
    return bundle, slots.reshape(6, BATCH)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_steps")
    bundle, idx = inputs()
    with one_intra_op_thread():
        params = {name: run_init(s["cfg"]["pos_encoding"],
                                 s["cfg"]["img_size"], s["opt"] != "sgd")
                  for name, s in RUNS.items()}
    (out / "config.json").write_text(json.dumps(dict(
        runs=RUNS, batch=BATCH, lr=LR, sgd_lr=SGD_LR)))
    np.savez(out / "inputs.npz", train_x=bundle.train_x,
             train_y=bundle.train_y, idx=idx, mean=np.float32(bundle.mean),
             std=np.float32(bundle.std), eval_x=bundle.test_x,
             **{f"p:{name}:{k}": v for name, p in params.items()
                for k, v in p.items()})
    launch("steps", out, 2)

    def read(name, rank):
        with np.load(out / f"{name}_rank{rank}.npz") as z:
            return {k: z[k] for k in z.files}

    return dict(bundle=bundle, idx=idx, params=params,
                runs={(name, rank): read(name, rank)
                      for name in RUNS for rank in (0, 1)})


def one_device(steps, name, monkeypatch):
    """The port's one-device run of the same SGD steps: (logits of the
    initial params, params after the steps, metrics)."""
    s = RUNS[name]
    if "threshold" in s:
        monkeypatch.setattr(flash_attention, "STREAMING_THRESHOLD",
                            s["threshold"])
    bundle, idx = steps["bundle"], torch.from_numpy(steps["idx"])
    cfg = ViTConfig(**s["cfg"])
    params = {k: torch.from_numpy(v.copy())
              for k, v in steps["params"][name].items()}
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    with torch.no_grad():
        logits = vit.apply(params, pre(torch.from_numpy(bundle.test_x)), cfg)
    for v in params.values():
        v.requires_grad_(True)

    def sgd(grads, state, params):
        with torch.no_grad():
            for key in params:
                params[key].sub_(SGD_LR * grads[key])
        return params, state

    accum = s.get("accum", 1)
    step = ts.make_train_step(cfg, sgd, pre, accum=accum)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    metrics = []
    for r in range(s["steps"]):
        params, _, m = step(params, None, r * accum, x, y, idx)
        metrics.append(m.numpy())
    return (logits.numpy(), {k: v.detach().numpy() for k, v in params.items()},
            np.stack(metrics))


def update_err(got, want, init):
    """Largest difference of the parameter updates, relative to the largest
    update entry."""
    keys = list(init)
    d_got = np.concatenate([(got[f"p:{k}"] - init[k]).ravel() for k in keys])
    d_want = np.concatenate([(want[k] - init[k]).ravel() for k in keys])
    return float(np.abs(d_got - d_want).max() / np.abs(d_want).max())


def replicated(run: dict) -> dict:
    dims = tp.tp_shard_dims({k[6:]: None for k in run
                             if k.startswith("local:")})
    return {k: run[f"local:{k}"] for k, d in dims.items() if d is None}


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_tp_matches_the_one_device_port(steps, name, monkeypatch):
    """Logits and a 3-step SGD trajectory (every param gathered into the
    reference layout, the losses) against the one-device run, in every PE
    mode, with grad_accum 2, and on the streaming route's twins."""
    want_logits, want_p, want_m = one_device(steps, name, monkeypatch)
    tol = (FLASH_TP_TOL if RUNS[name]["cfg"]["attention_impl"] == "flash"
           else TP_TOL)
    got = steps["runs"][name, 0]
    init = steps["params"][name]
    assert set(k[2:] for k in got if k.startswith("p:")) == set(init)
    for key, v in init.items():
        assert got[f"p:{key}"].shape == v.shape, key
    np.testing.assert_allclose(got["logits"], want_logits, rtol=0,
                               atol=tol * np.abs(want_logits).max())
    assert update_err(got, want_p, init) < tol
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0], rtol=tol)
    np.testing.assert_array_equal(got["metrics"][:, 1:], want_m[:, 1:])
    other = steps["runs"][name, 1]  # both ranks gather the same params
    for key in got:
        if not key.startswith("local:"):
            np.testing.assert_array_equal(got[key], other[key], err_msg=key)


@pytest.mark.parametrize("mutant", ["mutant_no_model_sync",
                                    "mutant_no_f_bwd"])
def test_mutants_miss_the_tp_bound(steps, mutant, monkeypatch):
    _, want_p, _ = one_device(steps, "sgd_rope-mixed", monkeypatch)
    err = update_err(steps["runs"][mutant, 0], want_p,
                     steps["params"][mutant])
    assert err > 10 * TP_TOL, err


@pytest.mark.parametrize("run,twin", [("zero1", "adamw"),
                                      ("remat_full", "sgd_rope-mixed"),
                                      ("dropout_remat", "dropout"),
                                      ("multi_step", "sgd_rope-mixed")])
def test_bit_equal_to_the_plain_tp_run(steps, run, twin):
    """ZeRO-1 x TP against the replicated AdamW (params, moments, count),
    remat "full" against remat off, with and without dropout (the shared
    and local mask streams replayed), the k-step driver (eager under a
    process group) against one step a call."""
    for rank in (0, 1):
        a, b = steps["runs"][run, rank], steps["runs"][twin, rank]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("run", ["dropout", "sgd_relative", "adamw"])
def test_replicated_params_bit_equal_across_model_ranks(steps, run):
    """After steps with dropout, drop-path and attention-prob dropout at
    0.1 (the masks on replicated tensors drawn alike on both ranks), and
    without: every replicated param is the same on both model ranks, and
    the sharded ones differ."""
    a, b = replicated(steps["runs"][run, 0]), replicated(steps["runs"][run, 1])
    assert "head.weight" in a and "blocks.0.mlp.fc1.weight" not in a
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    fc1 = "local:blocks.0.mlp.fc1.weight"
    assert not np.array_equal(steps["runs"][run, 0][fc1],
                              steps["runs"][run, 1][fc1])
    if run == "dropout":  # the dropout moved the trajectory
        assert not np.array_equal(steps["runs"]["dropout", 0]["p:head.weight"],
                                  steps["runs"]["sgd_rope-mixed", 0][
                                      "p:head.weight"])


def test_tp_matches_jax_make_tp_train_step(steps):
    """The port's two-rank AdamW run against the JAX make_tp_train_step on
    a 1 x 2 mesh (rope-mixed: the freqs' gradients summed over the model
    axis): the same params, the same index matrix, the same schedule."""
    bundle, idx = steps["bundle"], steps["idx"]
    s = RUNS["adamw"]
    jcfg = JaxViTConfig(**s["cfg"])
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=2,
                           lr=LR)
    mesh = jmesh.make_mesh(num_devices=2, model_parallel=2)
    tx = jts.make_optimizer(jtcfg, OPT_STEPS)
    jparams = {k: jnp.asarray(v) for k, v in steps["params"]["adamw"].items()}
    prepped = jtp.prepare_tp_params(jparams, jcfg)
    specs = jtp.tp_param_specs(prepped, jcfg)
    placed = jax.device_put(prepped, {k: NamedSharding(mesh, sp)
                                      for k, sp in specs.items()})
    opt = jax.jit(tx.init)(placed)
    rep = NamedSharding(mesh, P())
    fn = jts.make_tp_train_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), k=OPT_STEPS,
        guard_padded_steps=False)
    p, o, m = fn(placed, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:OPT_STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))
    want = {k: np.asarray(v) for k, v in
            jtp.restore_reference_params(jax.device_get(p), jcfg).items()}
    want_m = np.asarray(m)
    want_nu = {k: np.asarray(v) for k, v in jtp.restore_reference_params(
        jax.device_get(o[0].nu), jcfg).items()}

    got = steps["runs"]["adamw", 0]
    init = steps["params"]["adamw"]
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0],
                               rtol=JAX_TOL)
    np.testing.assert_array_equal(got["metrics"][:, 2], want_m[:, 2])
    largest = max(np.abs(want[k] - init[k]).max() for k in init)
    scale_max = max(np.sqrt(v).max() for v in want_nu.values())
    for key in init:
        # AdamW divides each entry's gradient by its own scale sqrt(nu): a
        # gradient error of JAX_TOL of the largest moves entry i by up to
        # 2 lr JAX_TOL max(sqrt(nu)) / sqrt(nu_i) a step.
        bound = (JAX_TOL * largest + 2 * OPT_STEPS * LR * JAX_TOL * scale_max
                 / np.maximum(np.sqrt(want_nu[key]), 1e-30))
        np.testing.assert_array_less(np.abs(got[f"p:{key}"] - want[key]),
                                     bound, err_msg=key)


# ---- fit on four ranks (data 2 x model 2) ----

def small_data(monkeypatch, n_train=96, n_test=32):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                  seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


FIT_KW = dict(KW, pos_encoding="rope-mixed")
LAST = "mnist_rope-mixed_last.npz"


def one_device_fit(out, epochs, monkeypatch, zero1=False):
    small_data(monkeypatch)
    tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                       synthetic_data=True, seed=0, zero1=zero1,
                       resume=epochs > 1, log_dir=str(out / "logs"),
                       ckpt_dir=str(out / "ckpts"))
    return loop.fit(ViTConfig(**FIT_KW), tcfg, verbose=False, device="cpu")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_fit")
    with pytest.MonkeyPatch.context() as mp, one_intra_op_thread():
        one_device_fit(out / "one", 1, mp)  # the one-device epoch
    (out / "resume" / "ckpts").mkdir(parents=True)
    shutil.copy(out / "one" / "ckpts" / LAST, out / "resume" / "ckpts" / LAST)
    launch("fit", out, 4)
    return out, [json.loads((out / f"fit_rank{r}.json").read_text())
                 for r in range(4)]


def rows(history):
    return [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in history]


def last_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fit_writes_one_csv_and_reference_checkpoints(fits):
    """Rank 0 alone writes the CSV, `_best.npz` and `_last.npz`: the params
    in the reference layout and shapes, the moments as the canonical flat
    vectors; every rank reports the same rows over 4 devices."""
    out, summaries = fits
    lead = summaries[0]
    cfg = ViTConfig(**FIT_KW)
    ref = {k: v.shape for k, v in vit.init_params(
        torch.Generator(), cfg, device="cpu").items()}
    total = loop.moment_flattener(vit.init_params(
        torch.Generator(), cfg, device="cpu"), cfg).total
    for name in ("tp", "tpz", "resume"):
        for other in summaries[1:]:
            assert other[name]["log_file"] is None
            assert rows(other[name]["history"]) == rows(lead[name]["history"])
        assert lead[name]["num_devices"] == 4
        assert lead[name]["num_params"] == sum(
            int(np.prod(s)) for s in ref.values())
        assert [str(p) for p in (out / name / "logs").glob("*.csv")] == [
            lead[name]["log_file"]]
        state = last_state(out / name / "ckpts" / LAST)
        for key, shape in ref.items():
            assert state[key].shape == shape, key
        assert state["__opt.1"].shape == state["__opt.2"].shape == (total,)
        if name == "resume":  # its best accuracy came with the file
            continue
        assert lead[name]["ckpt_path"] == str(
            out / name / "ckpts" / "mnist_rope-mixed_best.npz")
        with np.load(lead[name]["ckpt_path"]) as z:
            assert z["blocks.1.attn.qkv.weight"].shape == (3 * 64, 64)


def test_zero1_tp_last_state_bit_equal_to_tp(fits):
    """One epoch at data 2 x model 2 with and without --zero1 leaves the
    same `_last.npz`, bit for bit: ZeRO-1 x TP's moments, gathered over
    the data and the model axes into the canonical vectors, are the
    replicated optimizer's."""
    out, summaries = fits
    z = last_state(out / "tpz" / "ckpts" / LAST)
    d = last_state(out / "tp" / "ckpts" / LAST)
    assert set(z) == set(d) and int(z["__opt.0"]) == 3
    for key in z:
        np.testing.assert_array_equal(z[key], d[key], err_msg=key)
    assert rows(summaries[0]["tp"]["history"]) == rows(
        summaries[0]["tpz"]["history"])


def test_tp_last_state_resumes_at_world_size_1(fits, monkeypatch, tmp_path):
    """The four-rank `_last.npz` resumes in one process for a second epoch;
    and the one-device `_last.npz` that the four ranks resumed with --zero1
    under model_parallel 2 gives the one-device second epoch's row and
    state within float32 order (TP_TOL of each array's largest entry, the
    losses within rtol TP_TOL)."""
    out, summaries = fits
    shutil.copytree(out / "tp" / "ckpts", tmp_path / "tp" / "ckpts")
    resumed = one_device_fit(tmp_path / "tp", 2, monkeypatch)
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert int(last_state(tmp_path / "tp" / "ckpts" / LAST)["__opt.0"]) == 6

    shutil.copytree(out / "one" / "ckpts", tmp_path / "one" / "ckpts")
    want = one_device_fit(tmp_path / "one", 2, monkeypatch)
    got = summaries[0]["resume"]["history"]
    assert [h["epoch"] for h in got] == [2]
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(got[0][key], want["history"][0][key],
                                   rtol=TP_TOL)
    g = last_state(out / "resume" / "ckpts" / LAST)
    w = last_state(tmp_path / "one" / "ckpts" / LAST)
    assert int(g["__opt.0"]) == int(w["__opt.0"]) == 6
    for key in w:
        if not key.startswith("__"):
            np.testing.assert_allclose(
                g[key], w[key], rtol=0,
                atol=TP_TOL * max(np.abs(w[key]).max(), 1e-30), err_msg=key)


# ---- unit cases, no processes ----

@pytest.mark.parametrize("pe", ["relative", "rope-mixed", "polynomial"])
def test_layouts_and_shards_match_jax(pe):
    """prepare_tp_params / restore_reference_params and their optimizer
    twins against the JAX functions, and the shard dims against the JAX
    tp_param_specs; shard_params of each model rank joined back along its
    dim is the whole tensor, and without a model axis the reference params
    are the train state as they are; the PE params that are summed over
    the model axis are the JAX needs_model_sync's (none for rope-axial's
    shared tables)."""
    cfg, jcfg = ViTConfig(**KW, pos_encoding=pe), JaxViTConfig(
        **KW, pos_encoding=pe)
    params = init_params(dict(KW, pos_encoding=pe), seed=3)
    torch_p = {k: torch.from_numpy(v) for k, v in params.items()}
    prepped = tp.prepare_tp_params(torch_p, cfg)
    jprepped = jtp.prepare_tp_params(
        {k: jnp.asarray(v) for k, v in params.items()}, jcfg)
    jspecs = jtp.tp_param_specs(jprepped, jcfg)
    for key, dim in tp.tp_shard_dims(prepped).items():
        np.testing.assert_array_equal(prepped[key].numpy(),
                                      np.asarray(jprepped[key]))
        want = next((i for i, ax in enumerate(jspecs[key])
                     if ax == jmesh.MODEL_AXIS), None)
        assert dim == want, key
    back = tp.restore_reference_params(prepped, cfg)
    assert all(torch.equal(back[k], torch_p[k]) for k in torch_p)
    mu = {k: v + 1 for k, v in torch_p.items()}
    opt = tp.prepare_tp_opt_state((mu, mu, 2), cfg)
    assert opt[0]["blocks.0.attn.qkv.weight"].shape == (3, 4, 16, 64)
    again = tp.restore_reference_opt_state(opt, cfg)
    assert again[2] == 2 and all(torch.equal(again[1][k], mu[k]) for k in mu)
    meshes = [tmesh.Mesh(devices=("cpu",), ranks=(0, 1), model_parallel=2)
              for _ in range(2)]
    shards = []
    for m in (0, 1):
        with _rank(m):
            shards.append(tp.shard_params(prepped, meshes[m]))
    for key, dim in tp.tp_shard_dims(prepped).items():
        if dim is None:
            assert shards[0][key] is prepped[key]
        else:
            assert shards[0][key].shape[dim] * 2 == prepped[key].shape[dim]
            assert shards[0][key].is_contiguous()
            torch.testing.assert_close(
                torch.cat([s[key] for s in shards], dim=dim), prepped[key],
                rtol=0, atol=0)
    one = tmesh.Mesh(devices=("cpu",), ranks=(0, 1))
    for mesh in (None, one):
        same = tp.shard_reference(torch_p, cfg, mesh)
        assert all(same[k] is torch_p[k] for k in torch_p)
        assert all(v is torch_p[k] for k, v in
                   tp.gather_reference(same, cfg, mesh).items())
    jpe = jvit.init_params(jax.random.PRNGKey(0), jcfg)
    assert tp.model_sync_keys(torch_p, cfg) == sorted(
        k for k in jpe if k.startswith("pos_embed."))
    axial = ViTConfig(**KW, pos_encoding="rope-axial")
    assert tp.model_sync_keys(torch_p, axial) == []


@contextlib.contextmanager
def _rank(r):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "rank", lambda: r)
        yield


def test_model_axis_is_sliced_per_head():
    """The PE arguments of a block on model rank 1 of 2: the bias's, the
    generated bias's and rope-mixed's per-head tables sliced to heads 2..3
    (contiguous slices), rope-axial's shared tables as they are."""
    mesh = tmesh.Mesh(devices=("cpu",), ranks=(0, 1), model_parallel=2)
    bias = torch.arange(4 * 5 * 5.0).reshape(4, 5, 5)
    cos3 = torch.arange(4 * 3 * 2.0).reshape(4, 3, 2)
    cos2 = torch.ones(3, 2)
    with _rank(1):
        b, (c, s) = vit._local_pe(bias, (cos3, cos3 + 1), mesh.model_rank, 2)
        assert torch.equal(b, bias[2:]) and b.is_contiguous()
        assert torch.equal(c, cos3[2:]) and torch.equal(s, cos3[2:] + 1)
        (g,), shared = vit._local_pe((bias[:, 0],), (cos2, cos2),
                                     mesh.model_rank, 2)
        assert torch.equal(g, bias[2:, 0]) and shared[0] is cos2


def test_step_generators_share_the_replicated_stream():
    """Under a model axis the augmentation and the shared dropout stream
    are the data rank's (those of the data-parallel step), the local
    stream differs per model rank."""
    plain = ts.step_generators(0, 1, 2, "cpu", rank=1)
    draws = []
    for m in (0, 1):
        aug, (shared, local) = ts.step_generators(0, 1, 2, "cpu", rank=1,
                                                  model_rank=m)
        draws.append([torch.rand(4, generator=g) for g in
                      (aug, shared, local)])
    want = [torch.rand(4, generator=g) for g in plain]
    for m in (0, 1):
        assert torch.equal(draws[m][0], want[0])
        assert torch.equal(draws[m][1], want[1])
    assert not torch.equal(draws[0][2], draws[1][2])
    assert not torch.equal(draws[0][2], draws[0][1])


@pytest.mark.parametrize("world,t,ok", [(4, 2, True), (4, 3, False),
                                        (2, 2, True), (1, 2, False)])
def test_make_mesh_model_axis_needs_t_to_divide_the_world(monkeypatch,
                                                          world, t, ok):
    """model_parallel must divide the world size, in the JAX make_mesh's
    words; the data width must divide the batch."""
    monkeypatch.setattr(distributed, "is_initialized", lambda: world > 1)
    monkeypatch.setattr(distributed, "world_size", lambda: world)
    monkeypatch.setattr(distributed, "rank", lambda: world - 1)
    monkeypatch.setattr(distributed, "device", lambda: torch.device("cpu"))
    monkeypatch.setattr(distributed, "new_group", lambda ranks: tuple(ranks))
    if not ok:
        with pytest.raises(ValueError, match=f"device count {world} not "
                           f"divisible by model_parallel={t}"):
            tmesh.make_mesh(batch_size=8, model_parallel=t)
        return
    mesh = tmesh.make_mesh(batch_size=8, model_parallel=t)
    assert mesh.shape == {tmesh.DATA_AXIS: world // t, tmesh.MODEL_AXIS: t}
    assert (mesh.data_rank, mesh.model_rank) == divmod(world - 1, t)
    # this rank's model column and data row, out of every one created
    assert mesh.data_group == tuple(range((world - 1) % t, world, t))
    assert mesh.model_group == tuple(range(world - t, world))
    if world // t > 1:
        with pytest.raises(ValueError, match="multiple of the data width"):
            tmesh.make_mesh(batch_size=3, model_parallel=t)
