"""PyTorch port, pipeline parallelism over torch.distributed
(parallel/pipeline_parallel.py, parallel/pp_tp.py, the pipe axis of
parallel/mesh.py, distributed.stage_hop, train_step.make_train_step on a
pipe axis, fit with pipeline_parallel), on the CPU.

Ranks run as subprocesses with torchrun's environment on a free localhost
port, over gloo, one intra-op thread each (tests/torch_pp_worker.py), once
per module fixture: two ranks (data 1 x pipe 2) for apply_pp and the PP
steps, four for apply_pp at P = 4, the PP x TP steps (data 1 x pipe 2 x
model 2) and the fits (data 2 x pipe 2, data 1 x pipe 2 x model 2, a
resume and a CLI run). The model is the JAX tests' small_cfg
(tests/test_pipeline_parallel.py): 16 px, patch 4, embed 64, depth 2 (4 at
P = 4), 4 heads, the unfused attention ("reference"); the streaming cases
take the kernels' twins ("flash") at 48 px (N = 145) with
STREAMING_THRESHOLD lowered to 128 in both processes (apply_pp's
generated-bias marker; apply_pp_tp's materialized bias sliced to the
rank's heads); "flash" at 16 px runs the dense kernels' twins.

Tolerances:
* against the port's one-device run on the same inputs (SGD, linear in
  the gradient): the logits within TP_TOL of their largest entry, each
  parameter update within TP_TOL of the largest update entry, the losses
  within rtol TP_TOL (float32 sums in another order: the microbatches'
  gradients added up, the replicated params' partial gradients summed over
  the stages); the mutants (the cotangent not sent back along the stage
  chain, the replicated gradients not summed over the stages) miss that
  bound by more than 10x. On the kernels' twins within FLASH_TP_TOL
  instead (a float32-order difference flips the bfloat16 rounding of some
  products);
* the k-step driver and remat ("full", "softmax" under PP x TP) against
  the plain step, the ranks' replicated params against each other: bit
  for bit;
* against the JAX make_pp_train_step on a 2-device CPU mesh (AdamW):
  losses within rtol JAX_TOL, each param within JAX_TOL of the largest
  update entry plus its share of AdamW's normalisation (as
  tests/test_torch_tensor_parallel.py bounds TP against JAX).
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
from vit_rpe_rope_tpu.parallel import pipeline_parallel as jpp
from vit_rpe_rope_tpu.parallel import pp_tp as jpp_tp
from vit_rpe_rope_tpu.parallel import tensor_parallel as jtp
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import mesh as tmesh
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel as pp
from vit_rpe_rope_tpu_torch.parallel import pp_tp
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel as tp
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

from torch_pp_worker import FIT_KW, launch

TP_TOL = 1e-5
FLASH_TP_TOL = 2e-4
JAX_TOL = 1e-5

KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
          num_heads=4, attention_impl="reference")
STREAM_KW = dict(KW, img_size=48, attention_impl="flash")  # N = 145
PE_MODES = ("none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed")
BATCH, STEPS, OPT_STEPS, LR, SGD_LR = 16, 3, 2, 1e-3, 0.05


def spec(pe="rope-mixed", n_micro=2, kw=KW, opt="sgd", steps=STEPS,
         **extra):
    cfg = dict(kw, pos_encoding=pe, **{k: v for k, v in extra.items()
                                       if k in ViTConfig.__dataclass_fields__})
    out = dict(cfg=cfg, n_micro=n_micro, opt=opt, steps=steps)
    out.update({k: v for k, v in extra.items() if k not in cfg})
    return out


STREAM = dict(kw=STREAM_KW, threshold=128)
APPLY = {
    2: {**{pe: spec(pe, n_micro=4) for pe in PE_MODES},
        "stream_relative": spec("relative", **STREAM),
        "stream_polynomial": spec("polynomial", **STREAM),
        "flash_rope-mixed": spec(kw=dict(KW, attention_impl="flash"))},
    4: {pe: spec(pe, kw=dict(KW, depth=4)) for pe in PE_MODES},
}
STEPS_RUNS = {
    2: {"sgd_rope-mixed": spec(),
        "sgd_relative": spec("relative", n_micro=4),
        "stream_relative": spec("relative", **STREAM),
        "multi_step": spec(k=STEPS),
        "adamw": spec(opt="adamw", steps=OPT_STEPS),
        "mutant_no_hop_cotangent": spec(mutant="no_hop_cotangent"),
        "mutant_no_stage_sum": spec(mutant="no_stage_sum")},
    4: {"sgd_rope-mixed": spec(),
        "sgd_relative": spec("relative", n_micro=4),
        "flash_polynomial": spec("polynomial",
                                 kw=dict(KW, attention_impl="flash")),
        "stream_relative": spec("relative", **STREAM),
        "remat_full": spec(remat=True, remat_policy="full"),
        "remat_softmax": spec(remat=True, remat_policy="softmax"),
        "mutant_no_hop_cotangent": spec(mutant="no_hop_cotangent"),
        "mutant_no_stage_sum": spec(mutant="no_stage_sum")},
}
ONE_DEVICE = [(w, r) for w, runs in STEPS_RUNS.items() for r in runs
              if r.startswith(("sgd_", "stream_", "flash_"))]
CLI_ARGV = ["--synthetic", "--epochs", "1", "--batch_size", "16",
            "--depth", "2", "--embed_dim", "32", "--num_heads", "2",
            "--pos_encoding", "relative", "--pipeline_parallel", "2",
            "--model_parallel", "2", "--device", "cpu"]


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


@functools.lru_cache(maxsize=None)
def run_init(cfg_json, jax_init=False):
    """A run's initial params in the reference layout: the port's init, or
    (for the run held to the JAX make_pp_train_step) the JAX package's,
    carried over by utils/convert."""
    kw = json.loads(cfg_json)
    if jax_init:
        jparams = jvit.init_params(jax.random.PRNGKey(0),
                                   JaxViTConfig(**kw))
        full = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                               ViTConfig(**kw))
        return {k: full[k].numpy() for k in jparams}
    return {k: v.numpy() for k, v in vit.init_params(
        torch.Generator().manual_seed(0), ViTConfig(**kw),
        device="cpu").items()}


def init_of(s):
    return run_init(json.dumps(s["cfg"], sort_keys=True), s["opt"] != "sgd")


def inputs():
    bundle = datasets.synthetic("mnist", n_train=40, n_test=8, seed=7)
    order = np.random.default_rng(7).permutation(40)
    slots = np.full(3 * BATCH, -1, np.int64)
    pad = {3, 12, BATCH + 1, BATCH + 9, 2 * BATCH + 10, 2 * BATCH + 14,
           2 * BATCH + 15, 2 * BATCH}
    slots[[i for i in range(3 * BATCH) if i not in pad]] = order
    return bundle, slots.reshape(3, BATCH)


def run_ranks(tmp_path_factory, world, *args):
    """One launch of `world` ranks over the apply and step runs of that
    width (and, for four ranks, the fits): every saved array, by run and
    rank."""
    out = tmp_path_factory.mktemp(f"pp_{world}")
    bundle, idx = inputs()
    applied = {f"apply_{n}": s for n, s in APPLY[world].items()}
    runs = {**applied, **STEPS_RUNS[world]}
    one_fit = None
    with one_intra_op_thread():
        params = {name: init_of(s) for name, s in runs.items()}
        if world == 4:  # the one-device epoch whose _last.npz is resumed
            with pytest.MonkeyPatch.context() as mp:
                one_fit = one_device_fit(out / "one", 1, mp)
            (out / "resume" / "ckpts").mkdir(parents=True)
            shutil.copy(out / "one" / "ckpts" / LAST,
                        out / "resume" / "ckpts" / LAST)
    (out / "config.json").write_text(json.dumps({
        f"apply{world}": applied, f"steps{world}": STEPS_RUNS[world],
        "batch": BATCH, "lr": LR, "sgd_lr": SGD_LR}))
    np.savez(out / "inputs.npz", train_x=bundle.train_x,
             train_y=bundle.train_y, idx=idx, mean=np.float32(bundle.mean),
             std=np.float32(bundle.std), eval_x=bundle.test_x,
             **{f"p:{name}:{k}": v
                for name, p in params.items() for k, v in p.items()})
    launch({2: "two", 4: "four"}[world], out, world,
           *(CLI_ARGV + ["--log_dir", str(out / "cli" / "logs"),
                         "--ckpt_dir", str(out / "cli" / "ckpts")]
             if world == 4 else []))

    def read(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    saved = {(name, rank): read(out / f"{name}_rank{rank}.npz")
             for name in runs for rank in range(world)}
    fits = ([json.loads((out / f"fit_rank{r}.json").read_text())
             for r in range(world)] if world == 4 else None)
    return dict(out=out, bundle=bundle, idx=idx, params=params, runs=saved,
                fits=fits, one_fit=one_fit)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_ranks(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return run_ranks(tmp_path_factory, 4)


def ranks(request, world):
    return request.getfixturevalue({2: "two", 4: "four"}[world])


def threshold_of(s, monkeypatch):
    if "threshold" in s:
        monkeypatch.setattr(flash_attention, "STREAMING_THRESHOLD",
                            s["threshold"])


def tol_of(s):
    return FLASH_TP_TOL if s["cfg"]["attention_impl"] == "flash" else TP_TOL


@pytest.mark.parametrize("world,name", [(w, n) for w, runs in APPLY.items()
                                        for n in runs])
def test_apply_pp_matches_the_one_device_apply(request, world, name,
                                               monkeypatch):
    """apply_pp at P = 2 (M = 4, or 2 on the streaming twins) and P = 4 (M
    = 2, a middle stage that receives and sends) against the one-device
    vit.apply, in every PE mode, on the dense kernels' twins and through
    the streaming generated-bias marker: the same logits on every stage."""
    run = ranks(request, world)
    s = APPLY[world][name]
    threshold_of(s, monkeypatch)
    cfg = ViTConfig(**s["cfg"])
    bundle = run["bundle"]
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    params = {k: torch.from_numpy(v) for k, v in
              run["params"][f"apply_{name}"].items()}
    with torch.no_grad():
        want = vit.apply(params, pre(torch.from_numpy(bundle.test_x)),
                         cfg).numpy()
    got = run["runs"][f"apply_{name}", 0]["logits"]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol_of(s) * np.abs(want).max())
    for rank in range(1, world):
        np.testing.assert_array_equal(
            run["runs"][f"apply_{name}", rank]["logits"], got)


@pytest.mark.parametrize("pe", PE_MODES)
def test_one_stage_is_microbatched_execution(pe):
    """P = 1 with M = 2 (no mesh): the logits of vit.apply and its
    gradients within float32 order (the JAX
    test_apply_pp_single_stage_degenerates)."""
    cfg = ViTConfig(**KW, pos_encoding=pe)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    x = torch.randn(4, 16, 16, 1, generator=torch.Generator().manual_seed(1))
    stacked = {k: v.clone().requires_grad_() for k, v in
               vit.stack_block_params(params, cfg).items()}
    got = pp.apply_pp(stacked, x, cfg, None, 2)
    grads = torch.autograd.grad(got.square().sum(), list(stacked.values()))
    ref = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = vit.apply(ref, x, cfg)
    want_g = vit.stack_block_params(dict(zip(ref, torch.autograd.grad(
        want.square().sum(), list(ref.values())))), cfg)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=TP_TOL * float(want.detach().abs().max()))
    for key, g in zip(stacked, grads):
        torch.testing.assert_close(
            g, want_g[key], rtol=0,
            atol=TP_TOL * float(want_g[key].abs().max()) + 1e-30)


def one_device(run, s, monkeypatch):
    """The port's one-device run of the same SGD steps: (logits of the
    initial params, params after the steps, metrics)."""
    threshold_of(s, monkeypatch)
    bundle, idx = run["bundle"], torch.from_numpy(run["idx"])
    cfg = ViTConfig(**s["cfg"])
    params = {k: torch.from_numpy(v.copy()) for k, v in init_of(s).items()}
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

    step = ts.make_train_step(cfg, sgd, pre)
    x, y = torch.from_numpy(bundle.train_x), torch.from_numpy(bundle.train_y)
    metrics = []
    for r in range(s["steps"]):
        params, _, m = step(params, None, r, x, y, idx)
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


@pytest.mark.parametrize("world,name", ONE_DEVICE)
def test_pp_step_matches_the_one_device_port(request, world, name,
                                             monkeypatch):
    """The PP step (two ranks: data 1 x pipe 2) and the PP x TP step (four:
    data 1 x pipe 2 x model 2) against the one-device step: the logits of
    the step's forward, a 3-step SGD trajectory (every param gathered into
    the reference layout), the losses; in rope-mixed and relative, on the
    dense and streaming twins. Every rank gathers the same params."""
    run = ranks(request, world)
    s = STEPS_RUNS[world][name]
    want_logits, want_p, want_m = one_device(run, s, monkeypatch)
    tol = tol_of(s)
    got = run["runs"][name, 0]
    init = run["params"][name]
    assert set(k[2:] for k in got if k.startswith("p:")) == set(init)
    for key, v in init.items():
        assert got[f"p:{key}"].shape == v.shape, key
    np.testing.assert_allclose(got["logits"], want_logits, rtol=0,
                               atol=tol * np.abs(want_logits).max())
    assert update_err(got, want_p, init) < tol
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0], rtol=tol)
    np.testing.assert_array_equal(got["metrics"][:, 1:], want_m[:, 1:])
    for rank in range(1, world):
        other = run["runs"][name, rank]
        for key in got:
            if not key.startswith("local:"):
                np.testing.assert_array_equal(got[key], other[key],
                                              err_msg=key)


@pytest.mark.parametrize("world,mutant", [
    (w, m) for w in (2, 4)
    for m in ("mutant_no_hop_cotangent", "mutant_no_stage_sum")])
def test_mutants_miss_the_pp_bound(request, world, mutant, monkeypatch):
    run = ranks(request, world)
    _, want_p, _ = one_device(run, STEPS_RUNS[world]["sgd_rope-mixed"],
                              monkeypatch)
    err = update_err(run["runs"][mutant, 0], want_p, run["params"][mutant])
    assert err > 10 * TP_TOL, err


@pytest.mark.parametrize("world,run_name,twin", [
    (2, "multi_step", "sgd_rope-mixed"), (4, "remat_full", "sgd_rope-mixed"),
    (4, "remat_softmax", "sgd_rope-mixed")])
def test_bit_equal_to_the_plain_pp_step(request, world, run_name, twin):
    """The k-step driver (eager under a process group) against one step a
    call; remat "full" and "softmax" under PP x TP (f and g's collectives
    inside the recomputed blocks) against remat off."""
    run = ranks(request, world)
    for rank in range(world):
        a, b = run["runs"][run_name, rank], run["runs"][twin, rank]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("world,name", [(2, "sgd_relative"), (2, "adamw"),
                                        (4, "sgd_relative"),
                                        (4, "sgd_rope-mixed")])
def test_replicated_params_bit_equal_and_blocks_sharded(request, world,
                                                        name):
    """Each rank holds depth / P blocks (of H / T heads under a model
    axis), its block shards differ from every other rank's, and every
    replicated param (the relative table, rope-mixed's freqs, the head,
    ...) is the same on every rank after the steps."""
    run = ranks(request, world)
    local = [{k[6:]: v for k, v in run["runs"][name, r].items()
              if k.startswith("local:")} for r in range(world)]
    init = run["params"][name]
    fc1 = "blocks.mlp.fc1.weight"
    t = 2 if world == 4 else 1
    assert local[0][fc1].shape == (1, init["blocks.0.mlp.fc1.weight"].shape[
        0] // t, 64)
    for r in range(world):
        for other in range(r):
            assert not np.array_equal(local[r][fc1], local[other][fc1])
        for key in local[0]:
            if not key.startswith(pp.BLOCKS):
                np.testing.assert_array_equal(local[r][key], local[0][key],
                                              err_msg=key)
    assert any(k.startswith("pos_embed.") for k in local[0])


def test_pp_matches_jax_make_pp_train_step(two):
    """The port's two-rank AdamW run (data 1 x pipe 2, M = 2) against the
    JAX make_pp_train_step on a 1 x 2 mesh (its lone pipeline folds the
    stages onto 'model'): the same params, the same index matrix, the same
    schedule."""
    bundle, idx = two["bundle"], two["idx"]
    s = STEPS_RUNS[2]["adamw"]
    jcfg = JaxViTConfig(**s["cfg"])
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=2,
                           lr=LR)
    mesh = jmesh.make_mesh(num_devices=2, model_parallel=2)
    tx = jts.make_optimizer(jtcfg, OPT_STEPS)
    stacked = jvit.stack_block_params(
        {k: jnp.asarray(v) for k, v in two["params"]["adamw"].items()},
        jcfg)
    specs = jpp.pp_param_specs(stacked)
    placed = jax.device_put(stacked, {k: NamedSharding(mesh, sp)
                                      for k, sp in specs.items()})
    opt = jax.device_put(
        tx.init(stacked), jax.tree_util.tree_map(
            lambda sp: NamedSharding(mesh, sp),
            jts.opt_specs_like(tx.init(stacked), specs),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
    rep = NamedSharding(mesh, P())
    fn = jts.make_pp_train_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), n_micro=2,
        k=OPT_STEPS, guard_padded_steps=False)
    p, o, m = fn(placed, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:OPT_STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))
    want = {k: np.asarray(v) for k, v in
            jvit.unstack_block_params(jax.device_get(p), jcfg).items()}
    want_m = np.asarray(m)
    want_nu = {k: np.asarray(v) for k, v in jvit.unstack_block_params(
        jax.device_get(o[0].nu), jcfg).items()}

    got = two["runs"]["adamw", 0]
    init = two["params"]["adamw"]
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
    assert int(got["count"]) == OPT_STEPS
    flat = loop.moment_flattener({k: torch.from_numpy(v)
                                  for k, v in init.items()},
                                 ViTConfig(**s["cfg"]))
    assert got["mu"].shape == got["nu"].shape == (flat.total,)


# ---- fit and the CLI on four ranks ----

def small_data(monkeypatch, n_train=96, n_test=32):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                  seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


LAST = "mnist_rope-mixed_last.npz"


def one_device_fit(out, epochs, monkeypatch):
    small_data(monkeypatch)
    tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                       synthetic_data=True, seed=0, resume=epochs > 1,
                       log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpts"))
    return loop.fit(ViTConfig(**FIT_KW), tcfg, verbose=False, device="cpu")


def rows(history):
    return [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in history]


def last_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_fit_writes_one_csv_and_reference_checkpoints(four):
    """Rank 0 alone writes the CSV, `_best.npz` and `_last.npz` (params in
    the reference layout and shapes, the moments as the canonical flat
    vectors) at data 2 x pipe 2, data 1 x pipe 2 x model 2, after a resume
    and through the CLI with --pipeline_parallel 2 --model_parallel 2;
    every rank reports the same rows over 4 devices."""
    out, summaries = four["out"], four["fits"]
    lead = summaries[0]
    for name, kw in (("pp", FIT_KW), ("pptp", FIT_KW), ("resume", FIT_KW),
                     ("cli", dict(FIT_KW, img_size=32, embed_dim=32,
                                  num_heads=2, pos_encoding="relative",
                                  attention_impl="auto"))):
        cfg = ViTConfig(**kw)
        ref = vit.init_params(torch.Generator(), cfg, device="cpu")
        total = loop.moment_flattener(ref, cfg).total
        for other in summaries[1:]:
            assert other[name]["log_file"] is None
            assert rows(other[name]["history"]) == rows(lead[name]["history"])
        assert lead[name]["num_devices"] == 4
        assert lead[name]["num_params"] == vit.num_params(ref)
        assert [str(p) for p in (out / name / "logs").glob("*.csv")] == [
            lead[name]["log_file"]]
        state = last_state(next((out / name / "ckpts").glob("*_last.npz")))
        for key, v in ref.items():
            assert state[key].shape == tuple(v.shape), key
        assert state["__opt.1"].shape == state["__opt.2"].shape == (total,)
        assert np.isfinite(lead[name]["history"][-1]["train_loss"])


def test_pp_fit_matches_one_device_and_resumes_at_world_size_1(
        four, monkeypatch, tmp_path):
    """The first epochs at data 2 x pipe 2 and data 1 x pipe 2 x model 2
    give the one-device epoch's row within float32 order; their
    `_last.npz` resume in one process for a second epoch; and the
    one-device `_last.npz` that four ranks resumed under PP x TP gives the
    one-device second epoch's row and state within float32 order (TP_TOL
    of each array's largest entry, the losses within rtol TP_TOL)."""
    out, summaries = four["out"], four["fits"]
    one = rows(four["one_fit"]["history"])
    for name in ("pp", "pptp"):
        got = rows(summaries[0][name]["history"])
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(got[0][key], one[0][key], rtol=TP_TOL)
        for key in ("train_acc", "test_acc"):
            assert got[0][key] == one[0][key]
        shutil.copytree(out / name / "ckpts", tmp_path / name / "ckpts")
        resumed = one_device_fit(tmp_path / name, 2, monkeypatch)
        assert [h["epoch"] for h in resumed["history"]] == [2]
        assert int(last_state(tmp_path / name / "ckpts" / LAST)[
            "__opt.0"]) == 6

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

@contextlib.contextmanager
def fake_group(world, rank):
    """distributed's view of a process group of `world` ranks, as rank
    `rank`, whose subgroups are the tuples of their ranks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(distributed, "is_initialized", lambda: True)
        mp.setattr(distributed, "world_size", lambda: world)
        mp.setattr(distributed, "rank", lambda: rank)
        mp.setattr(distributed, "device", lambda: torch.device("cpu"))
        mp.setattr(distributed, "new_group", lambda ranks: tuple(ranks))
        yield


@pytest.mark.parametrize("world,p,t", [(4, 2, 1), (4, 4, 1), (8, 2, 2),
                                       (4, 2, 2)])
def test_make_mesh_pipe_axis_follows_the_jax_layout(world, p, t):
    """Lone PP: rank r at data r // P, stage r % P (the JAX ('data',
    'model') fold); PP x TP: data r // (P·T), stage (r // T) % P, model
    r % T (the JAX ('data', 'pipe', 'model') grid). Each rank's groups:
    its model row, its stage chain (in stage order, prev / next), its
    data column (same stage and model) and its replica group (same
    model)."""
    d = world // (p * t)
    for r in range(world):
        with fake_group(world, r):
            mesh = tmesh.make_mesh(batch_size=8 * d, pipe_parallel=p,
                                   model_parallel=t)
        i, s, m = r // (p * t), r // t % p, r % t
        with fake_group(world, r):
            assert (mesh.data_rank, mesh.pipe_rank, mesh.model_rank) == (
                i, s, m)
        want = {tmesh.DATA_AXIS: d, tmesh.PIPE_AXIS: p}
        if t > 1:
            want[tmesh.MODEL_AXIS] = t
        assert mesh.shape == want and mesh.size == d
        at = lambda i_, s_, m_: (i_ * p + s_) * t + m_  # noqa: E731
        chain = mesh.pipe_chain
        assert chain.group == tuple(at(i, s_, m) for s_ in range(p))
        assert (chain.rank, chain.size) == (s, p)
        assert chain.prev == (at(i, s - 1, m) if s else None)
        assert chain.next == (at(i, s + 1, m) if s + 1 < p else None)
        assert mesh.data_group == tuple(at(i_, s, m) for i_ in range(d))
        if t > 1:
            assert mesh.model_group == tuple(at(i, s, m_) for m_ in range(t))
            assert mesh.replica_group == tuple(range(m, world, t))
        else:
            assert mesh.model_group is None and mesh.replica_group is None


def test_make_mesh_pipe_axis_rules():
    """P x T must divide the world size (the JAX make_mesh's words), the
    data width the batch; so must P x R with a sequence axis (PP x CP,
    ported: tests/test_torch_pp_tp_cp.py), which then takes the grid's
    ranks: rank 1 of four is stage 0 and sequence rank 1."""
    with fake_group(4, 0):
        with pytest.raises(ValueError, match="device count 4 not divisible "
                           "by model_parallel=1 × seq_parallel=1 × "
                           "pipe_parallel=3"):
            tmesh.make_mesh(pipe_parallel=3)
        with pytest.raises(ValueError, match="multiple of the data width 2"):
            tmesh.make_mesh(batch_size=3, pipe_parallel=2)
    with fake_group(4, 0):
        with pytest.raises(ValueError, match="device count 4 not divisible "
                           "by model_parallel=1 × seq_parallel=3 × "
                           "pipe_parallel=2"):
            tmesh.make_mesh(pipe_parallel=2, seq_parallel=3)
    with fake_group(4, 1):
        mesh = tmesh.make_mesh(pipe_parallel=2, seq_parallel=2)
        assert (mesh.pipe_rank, mesh.seq_rank) == (0, 1)
    assert mesh.seq_ring.group == (0, 1) and mesh.pipe_chain.group == (1, 3)


@pytest.mark.parametrize("pe", ["relative", "rope-mixed"])
def test_shards_match_jax_specs(pe):
    """pp_shard_dims and pp_tp.pp_tp_shard_dims against the JAX
    pp_param_specs and pp_tp_param_specs on the depth-stacked (TP-prepared)
    params; each rank's shard_reference has the shapes the specs give on a
    data 1 x pipe 2 x model 2 grid, and the shards joined back are the
    whole tensors (gather_reference's layout inverted)."""
    kw = dict(KW, pos_encoding=pe)
    cfg, jcfg = ViTConfig(**kw), JaxViTConfig(**kw)
    ref = {k: torch.from_numpy(v) for k, v in
           run_init(json.dumps(kw, sort_keys=True), True).items()}
    jref = {k: jnp.asarray(v.numpy()) for k, v in ref.items()}
    for t in (1, 2):
        torch_stacked = vit.stack_block_params(
            tp.prepare_tp_params(ref, cfg) if t > 1 else ref, cfg)
        jstacked = jvit.stack_block_params(
            jtp.prepare_tp_params(jref, jcfg) if t > 1 else jref, jcfg)
        dims = (pp_tp.pp_tp_shard_dims(torch_stacked) if t > 1
                else pp.pp_shard_dims(torch_stacked))
        jspecs = (jpp_tp.pp_tp_param_specs(jstacked) if t > 1
                  else jpp.pp_param_specs(jstacked))
        axes = ((jmesh.PIPE_AXIS, jmesh.MODEL_AXIS) if t > 1
                else (jmesh.MODEL_AXIS, None))
        assert set(dims) == set(jspecs)
        shards = {}
        for r in range(2 * t):
            with fake_group(2 * t, r):
                mesh = tmesh.make_mesh(pipe_parallel=2, model_parallel=t)
                shards[r // t, r % t] = pp.shard_reference(ref, cfg, mesh)
        for key, (pdim, mdim) in dims.items():
            spec = tuple(jspecs[key]) + (None,) * 8
            np.testing.assert_array_equal(torch_stacked[key].numpy(),
                                          np.asarray(jstacked[key]))
            assert pdim == next((i for i, a in enumerate(spec)
                                 if a == axes[0]), None), key
            assert mdim == next((i for i, a in enumerate(spec)
                                 if a is not None and a == axes[1]),
                                None), key
            local = list(torch_stacked[key].shape)
            for dim, n in ((pdim, 2), (mdim, t)):
                if dim is not None:
                    local[dim] //= n
            assert all(tuple(v[key].shape) == tuple(local)
                       for v in shards.values()), key
            stages = [shards[st, 0][key] if mdim is None else torch.cat(
                [shards[st, m][key] for m in range(t)], dim=mdim)
                for st in range(2)]
            whole = stages[0] if pdim is None else torch.cat(stages, pdim)
            torch.testing.assert_close(whole, torch_stacked[key], rtol=0,
                                       atol=0)


def fit_cfg(**kw):
    return ViTConfig(**dict(FIT_KW, **kw))


@pytest.mark.parametrize("case", ["depth", "microbatches", "dropout",
                                  "grad_accum", "heads", "zero1"])
def test_fit_refuses_what_jax_refuses(case):
    """The JAX fit's ValueErrors under pipeline parallelism, in its words,
    on a process group of four ranks (faked: each check comes before any
    collective); and configs.TrainConfig's refusal of --zero1."""
    base = dict(dataset="mnist", batch_size=32, pipeline_parallel=2)
    cfg, tcfg, match = {
        "depth": (fit_cfg(depth=3), base,
                  "pipeline_parallel=2 must divide depth=3"),
        "microbatches": (fit_cfg(), dict(base, pp_microbatches=3),
                         "per-device batch 16 not divisible by "
                         "pp_microbatches=3"),
        "dropout": (fit_cfg(drop_rate=0.1), base,
                    "sequence_parallel/pipeline_parallel do not support "
                    "dropout rates > 0"),
        "grad_accum": (fit_cfg(), dict(base, grad_accum=2),
                       "grad_accum > 1 is not supported with pipeline "
                       "parallelism \\(use --pp_microbatches"),
        "heads": (fit_cfg(), dict(base, model_parallel=8),
                  "model_parallel=8 must divide num_heads=4"),
        "zero1": (None, dict(base, zero1=True),
                  "zero1 is incompatible with pipeline parallelism > 1"),
    }[case]
    world = 2 * 2 * tcfg.get("model_parallel", 1)  # data 2
    with pytest.raises(ValueError, match=match), fake_group(world, 0):
        loop.fit(cfg, TrainConfig(**tcfg), verbose=False, device="cpu")
