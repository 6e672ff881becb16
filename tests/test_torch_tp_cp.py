"""PyTorch port, tensor x context parallelism over torch.distributed
(parallel/tp_cp.py, context_parallel._cp_block with a model row, the
('data', 'seq', 'model') grid of parallel/mesh.py, train_step.make_train_step
on it, fit and the train CLI with --sequence_parallel and
--model_parallel), on the CPU; and the mesh of every composition against
the JAX make_mesh's device layout.

The ranks run as subprocesses with torchrun's environment on a free
localhost port, over gloo, one intra-op thread each
(tests/torch_comp_worker.py), in one launch of four ranks (data 1 x seq 2
x model 2) for the whole module: the forward in the six PE modes, the
steps, the mutants, the fit and a CLI run. The model is the JAX tests'
small configuration (tests/test_tp_cp.py): 16 px, patch 4, embed 64,
depth 2, 4 heads, the unfused attention ("reference"), N = 17 padded to 18
over the ring; the flash cases take the kernels' twins at 48 px (N = 145)
with STREAMING_THRESHOLD lowered to 128 (the one-device run's streaming
route against the ring of chunk twins).

Tolerances:
* against the port's one-device run on the same inputs (SGD, linear in
  the gradient): the logits within TP_TOL of their largest entry, each
  parameter update within TP_TOL of the largest update entry, the losses
  within rtol TP_TOL (float32 sums in another order: the tokens'
  partial gradients summed over the ring, the heads' partial sums over the
  model row); the mutants (the per-head PE params' gradient not summed
  over the model axis, no gradient summed over the ring) miss that bound
  by more than 10x. On the kernels' twins (bfloat16 products) the
  composed forward's logits are held within FLASH_TP_TOL of the lone
  context-parallel ring's (the same hops, so the same rounding points),
  and the composed runs within FLASH_RING_TOL of the one-device
  streaming route: splitting the keys into hops moves each hop's softmax
  max, which flips the bfloat16 rounding of p and ds (2^-9 of an entry).
  On these inputs the sound ring reads up to 4.2e-4 and the control (each
  hop's log-sum-exp rounded to bfloat16 before the merge) 2.8e-3, which
  the bound sits between;
* the k-step driver and remat ("full", "softmax": f, g and the ring's hops
  recomputed) against the plain step, the ranks' replicated params
  against each other: bit for bit;
* against the JAX make_tp_cp_train_step on a 1 x 2 x 2 CPU mesh (AdamW):
  losses within rtol JAX_TOL, each param within JAX_TOL of the largest
  update entry plus its share of AdamW's normalisation (as
  tests/test_torch_pipeline_parallel.py bounds PP against JAX).
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
from vit_rpe_rope_tpu_torch.parallel import tp_cp
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

from torch_comp_worker import FIT_KW, WORLDS, launch

TP_TOL = 1e-5
FLASH_TP_TOL = 2e-4
FLASH_RING_TOL = 1e-3
JAX_TOL = 1e-5

KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
          num_heads=4, attention_impl="reference")
STREAM_KW = dict(KW, img_size=48, attention_impl="flash")  # N = 145
PE_MODES = ("none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed")
BATCH, STEPS, OPT_STEPS, LR, SGD_LR = 16, 3, 2, 1e-3, 0.05
LAST = "mnist_rope-mixed_last.npz"


def spec(pe="rope-mixed", n_micro=2, kw=KW, opt="sgd", steps=STEPS,
         **extra):
    cfg = dict(kw, pos_encoding=pe, **{k: v for k, v in extra.items()
                                       if k in ViTConfig.__dataclass_fields__})
    out = dict(cfg=cfg, n_micro=n_micro, opt=opt, steps=steps)
    out.update({k: v for k, v in extra.items() if k not in cfg})
    return out


STREAM = dict(kw=STREAM_KW, threshold=128)
APPLY = {**{pe: spec(pe) for pe in PE_MODES},
         "stream_relative": spec("relative", **STREAM),
         "stream_polynomial": spec("polynomial", **STREAM)}
CONTROL = {"control_bf16_lse": spec("relative", mutant="bf16_lse",
                                   **STREAM)}
STEPS_RUNS = {
    "sgd_rope-mixed": spec(),
    "sgd_relative": spec("relative"),
    "stream_relative": spec("relative", **STREAM),
    "accum_relative": spec("relative", steps=1, accum=2),
    "multi_step": spec(k=STEPS),
    "remat_full": spec(remat=True, remat_policy="full"),
    "remat_softmax": spec(remat=True, remat_policy="softmax"),
    "adamw": spec(opt="adamw", steps=OPT_STEPS),
    "mutant_no_model_sync": spec("relative", mutant="no_model_sync"),
    "mutant_no_seq_sum": spec(mutant="no_seq_sum")}
FITS = {"tpcp": dict(sequence_parallel=2, model_parallel=2)}
CLI_ARGV = ["--synthetic", "--epochs", "1", "--batch_size", "16",
            "--depth", "2", "--embed_dim", "32", "--num_heads", "2",
            "--pos_encoding", "relative", "--device", "cpu"]


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
    (for the run held to the JAX train step) the JAX package's, carried
    over by utils/convert. The JAX init runs as one jitted program: eagerly
    each of its random draws compiles on its own, for seconds."""
    kw = json.loads(cfg_json)
    if jax_init:
        jparams = jax.jit(functools.partial(
            jvit.init_params, cfg=JaxViTConfig(**kw)))(jax.random.PRNGKey(0))
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


def small_data(monkeypatch, n_train=96, n_test=32):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                  seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


def one_device_fit(out, epochs, monkeypatch):
    small_data(monkeypatch)
    tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                       synthetic_data=True, seed=0, resume=epochs > 1,
                       log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpts"))
    return loop.fit(ViTConfig(**FIT_KW), tcfg, verbose=False, device="cpu")


def run_composition(tmp_path_factory, mode, apply, steps, fits,
                    jax_step=None):
    """One launch of the composition `mode`'s ranks over its apply, step
    and fit runs and a CLI run (the composition's flags on CLI_ARGV's
    model): every saved array, by run and rank, each rank's fit
    summaries, the one-device epoch of the fits' data and, given
    jax_step(bundle, idx, params), its result on the "adamw" run's params
    ("jax"), computed here while the ranks run."""
    out = tmp_path_factory.mktemp(mode)
    bundle, idx = inputs()
    runs = {**apply, **steps}
    world = WORLDS[mode]
    flags = {"tpcp": ["--sequence_parallel", "2", "--model_parallel", "2"],
             "ppcp": ["--pipeline_parallel", "2", "--sequence_parallel",
                      "2"],
             "pptpcp": ["--pipeline_parallel", "2", "--sequence_parallel",
                        "2", "--model_parallel", "2"]}[mode]
    with one_intra_op_thread():
        params = {name: init_of(s) for name, s in runs.items()}
        with pytest.MonkeyPatch.context() as mp:
            one_fit = one_device_fit(out / "one", 1, mp)
    (out / "config.json").write_text(json.dumps({
        "apply": apply, "steps": steps, "fits": fits, "batch": BATCH,
        "lr": LR, "sgd_lr": SGD_LR}))
    np.savez(out / "inputs.npz", train_x=bundle.train_x,
             train_y=bundle.train_y, idx=idx, mean=np.float32(bundle.mean),
             std=np.float32(bundle.std), eval_x=bundle.test_x,
             **{f"p:{name}:{k}": v
                for name, p in params.items() for k, v in p.items()})
    jax_out = {}

    def during():
        if jax_step is not None:
            jax_out["result"] = jax_step(bundle, idx, params["adamw"])

    launch(mode, out, *CLI_ARGV, *flags, "--log_dir",
           str(out / "cli" / "logs"), "--ckpt_dir", str(out / "cli" / "ckpts"),
           during=during)

    def read(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    saved = {(name, rank): read(out / f"{name}_rank{rank}.npz")
             for name in runs for rank in range(world)}
    summaries = [json.loads((out / f"fit_rank{r}.json").read_text())
                 for r in range(world)]
    return dict(out=out, bundle=bundle, idx=idx, params=params, runs=saved,
                fits=summaries, one_fit=one_fit, world=world,
                jax=jax_out.get("result"))


@pytest.fixture(scope="module")
def comp(tmp_path_factory):
    return run_composition(tmp_path_factory, "tpcp", {**APPLY, **CONTROL},
                           STEPS_RUNS, FITS, jax_step=jax_tp_cp_step)


def threshold_of(s, monkeypatch):
    if "threshold" in s:
        monkeypatch.setattr(flash_attention, "STREAMING_THRESHOLD",
                            s["threshold"])


def tol_of(s):
    return FLASH_RING_TOL if s["cfg"]["attention_impl"] == "flash" else TP_TOL


@functools.lru_cache(maxsize=None)
def one_device_apply(spec_json):
    """vit.apply's logits of a run's initial params on the eval images (the
    same inputs in every launch)."""
    s = json.loads(spec_json)
    cfg = ViTConfig(**s["cfg"])
    bundle = inputs()[0]
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    params = {k: torch.from_numpy(v) for k, v in init_of(s).items()}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        threshold_of(s, mp)
        return vit.apply(params, pre(torch.from_numpy(bundle.test_x)),
                         cfg).numpy()


def apply_err(run, name, s):
    """Rank 0's composed logits against the one-device vit.apply's: the
    largest difference relative to the largest one-device logit."""
    want = one_device_apply(json.dumps(s, sort_keys=True))
    got = run["runs"][name, 0]["logits"]
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_apply(run, name, s):
    """The composed forward's logits against the one-device vit.apply's,
    the same on every rank; on the kernels' twins also against the lone
    ring's at FLASH_TP_TOL (the one-device route merges no ring hops)."""
    got = run["runs"][name, 0]["logits"]
    err = apply_err(run, name, s)
    print(f"{name}: logits off the one device's by {err:.3e} of the "
          f"largest (bound {tol_of(s):g})")
    assert err <= tol_of(s), (name, err)
    for rank in range(1, run["world"]):
        np.testing.assert_array_equal(run["runs"][name, rank]["logits"], got)
    if "cp_logits" in run["runs"][name, 0]:
        ring = run["runs"][name, 0]["cp_logits"]
        np.testing.assert_allclose(got, ring, rtol=0,
                                   atol=FLASH_TP_TOL * np.abs(ring).max())


def one_device(run, s):
    """The port's one-device run of the same SGD steps: (logits of the
    initial params, params after the steps, metrics)."""
    del run  # every launch takes the same inputs
    return one_device_steps(json.dumps(s, sort_keys=True))


@functools.lru_cache(maxsize=None)
def one_device_steps(spec_json):
    s = json.loads(spec_json)
    bundle, idx = inputs()
    idx = torch.from_numpy(idx)
    cfg = ViTConfig(**s["cfg"])
    params = {k: torch.from_numpy(v.copy()) for k, v in init_of(s).items()}
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    with pytest.MonkeyPatch.context() as mp:
        threshold_of(s, mp)
        with torch.no_grad():
            logits = vit.apply(params, pre(torch.from_numpy(bundle.test_x)),
                               cfg)
        for v in params.values():
            v.requires_grad_(True)

        def sgd(grads, state, params):
            with torch.no_grad():
                for key in params:
                    params[key].sub_(SGD_LR * grads[key])
            return params, state

        accum = s.get("accum", 1)
        step = ts.make_train_step(cfg, sgd, pre, accum=accum)
        x = torch.from_numpy(bundle.train_x)
        y = torch.from_numpy(bundle.train_y)
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


def check_step(run, name, s):
    """A composed step's trajectory against the one-device one: the logits
    of its forward, the SGD updates (every param gathered into the
    reference layout), the losses; every rank gathers the same params."""
    want_logits, want_p, want_m = one_device(run, s)
    tol = tol_of(s)
    got = run["runs"][name, 0]
    init = run["params"][name]
    assert set(k[2:] for k in got if k.startswith("p:")) == set(init)
    for key, v in init.items():
        assert got[f"p:{key}"].shape == v.shape, key
    np.testing.assert_allclose(got["logits"], want_logits, rtol=0,
                               atol=tol * np.abs(want_logits).max())
    err = update_err(got, want_p, init)
    loss_err = float(np.max(np.abs(got["metrics"][:, 0] / want_m[:, 0] - 1)))
    print(f"{name}: updates off the one device's by {err:.3e} of the "
          f"largest, losses by {loss_err:.3e} relative (bound {tol:g})")
    assert err < tol
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0], rtol=tol)
    np.testing.assert_array_equal(got["metrics"][:, 1:], want_m[:, 1:])
    for rank in range(1, run["world"]):
        other = run["runs"][name, rank]
        for key in got:
            if not key.startswith("local:"):
                np.testing.assert_array_equal(got[key], other[key],
                                              err_msg=key)


def check_mutant(run, name, twin):
    _, want_p, _ = one_device(run, twin)
    err = update_err(run["runs"][name, 0], want_p, run["params"][name])
    assert err > 10 * TP_TOL, err


def check_bit_equal(run, name, twin):
    for rank in range(run["world"]):
        a, b = run["runs"][name, rank], run["runs"][twin, rank]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def check_shards(run, name, position, blocks_key):
    """Every replicated param (the relative table, the head, ...) is the
    same on every rank after the steps; a block shard is the same on the
    ranks of one position (`position`: rank -> its stage and model
    position) and differs between positions."""
    world = run["world"]
    local = [{k[6:]: v for k, v in run["runs"][name, r].items()
              if k.startswith("local:")} for r in range(world)]
    for r in range(world):
        for other in range(r):
            same = np.array_equal(local[r][blocks_key],
                                  local[other][blocks_key])
            assert same == (position(r) == position(other)), (r, other)
        for key in local[0]:
            if not key.startswith("blocks."):
                np.testing.assert_array_equal(local[r][key], local[0][key],
                                              err_msg=key)
    assert any(k.startswith("pos_embed.") for k in local[0])


def adamw_bound_check(got, want, want_m, want_nu, init):
    """The port's AdamW run against a JAX one: losses within rtol JAX_TOL,
    each param within JAX_TOL of the largest update entry plus its share
    of AdamW's normalisation."""
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


def rows(history):
    return [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in history]


def last_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def check_fits(run, names, monkeypatch, tmp_path):
    """Rank 0 alone writes the CSV, `_best.npz` and `_last.npz` (params in
    the reference layout and shapes, the moments as the canonical flat
    vectors) for each fit run and the CLI run; every rank reports the same
    rows over all the ranks; each fit's first epoch gives the one-device
    epoch's row within float32 order, and its `_last.npz` resumes in one
    process for a second epoch."""
    out, summaries = run["out"], run["fits"]
    lead = summaries[0]
    cli_kw = dict(FIT_KW, img_size=32, embed_dim=32, num_heads=2,
                  pos_encoding="relative", attention_impl="auto")
    for name, kw in [(n, FIT_KW) for n in names] + [("cli", cli_kw)]:
        cfg = ViTConfig(**kw)
        ref = vit.init_params(torch.Generator(), cfg, device="cpu")
        total = loop.moment_flattener(ref, cfg).total
        for other in summaries[1:]:
            assert other[name]["log_file"] is None
            assert rows(other[name]["history"]) == rows(lead[name]["history"])
        assert lead[name]["num_devices"] == run["world"]
        assert lead[name]["num_params"] == vit.num_params(ref)
        assert [str(p) for p in (out / name / "logs").glob("*.csv")] == [
            lead[name]["log_file"]]
        state = last_state(next((out / name / "ckpts").glob("*_last.npz")))
        for key, v in ref.items():
            assert state[key].shape == tuple(v.shape), key
        assert state["__opt.1"].shape == state["__opt.2"].shape == (total,)
        assert np.isfinite(lead[name]["history"][-1]["train_loss"])
    one = rows(run["one_fit"]["history"])
    for name in names:
        got = rows(lead[name]["history"])
        for key in ("train_loss", "test_loss"):
            np.testing.assert_allclose(got[0][key], one[0][key], rtol=TP_TOL)
        for key in ("train_acc", "test_acc"):
            assert got[0][key] == one[0][key]
        shutil.copytree(out / name / "ckpts", tmp_path / name / "ckpts")
        resumed = one_device_fit(tmp_path / name, 2, monkeypatch)
        assert [h["epoch"] for h in resumed["history"]] == [2]
        assert int(last_state(tmp_path / name / "ckpts" / LAST)[
            "__opt.0"]) == 6


# ---- the launch of four ranks: data 1 x seq 2 x model 2 ----

@pytest.mark.parametrize("name", APPLY)
def test_apply_tp_cp_matches_the_one_device_apply(comp, name):
    """apply_tp_cp in every PE mode (the generated biases cut to the
    rank's heads and generated per hop; rope-mixed's per-head tables) and
    on the kernels' twins (the ring of chunk twins against the one-device
    streaming route): the logits of vit.apply on every rank."""
    check_apply(comp, name, APPLY[name])


def test_flash_bound_catches_a_bf16_lse_merge(comp):
    """The control of FLASH_RING_TOL: the ring of chunk twins with each
    hop's log-sum-exp rounded to bfloat16 before the logaddexp merge (the
    "bf16_lse" mutant, relative at N = 145) misses the one-device bound
    that the same ring meets unmutated (stream_relative above)."""
    err = apply_err(comp, "control_bf16_lse", CONTROL["control_bf16_lse"])
    print(f"control_bf16_lse: logits off the one device's by {err:.3e} of "
          f"the largest (bound {FLASH_RING_TOL:g})")
    assert err > FLASH_RING_TOL, err


@pytest.mark.parametrize("name", ["sgd_rope-mixed", "sgd_relative",
                                  "stream_relative", "accum_relative"])
def test_tp_cp_step_matches_the_one_device_port(comp, name):
    """The TP x CP step against the one-device step: 3 SGD steps in
    rope-mixed and relative (the per-head PE params' gradients summed over
    the model axis), on the kernels' twins, and one step of two
    accumulated rows (grad_accum works under TP x CP, as in JAX)."""
    check_step(comp, name, STEPS_RUNS[name])


@pytest.mark.parametrize("mutant,twin", [
    ("mutant_no_model_sync", "sgd_relative"),
    ("mutant_no_seq_sum", "sgd_rope-mixed")])
def test_mutants_miss_the_tp_cp_bound(comp, mutant, twin):
    check_mutant(comp, mutant, STEPS_RUNS[twin])


@pytest.mark.parametrize("name", ["multi_step", "remat_full",
                                  "remat_softmax"])
def test_bit_equal_to_the_plain_tp_cp_step(comp, name):
    """The k-step driver (eager under a process group) against one step a
    call; remat "full" and "softmax" (f, g and the ring's hops recomputed
    in the backward on every rank) against remat off."""
    check_bit_equal(comp, name, "sgd_rope-mixed")


@pytest.mark.parametrize("name", ["sgd_relative", "adamw"])
def test_replicated_params_bit_equal_and_heads_sharded(comp, name):
    """Each rank holds H / T heads; the ranks of one model position (a
    ring) hold the same block shards, the two model positions different
    ones; every replicated param is the same on every rank."""
    check_shards(comp, name, lambda r: r % 2, "blocks.0.mlp.fc1.weight")
    local = comp["runs"][name, 0]
    assert local["local:blocks.0.attn.qkv.weight"].shape == (3, 2, 16, 64)


def jax_tp_cp_step(bundle, idx, params):
    """The JAX make_tp_cp_train_step's AdamW run (OPT_STEPS steps on a
    1 x 2 x 2 CPU mesh) from `params` over the index matrix: (params,
    metrics, the second moment), in the reference layout."""
    jcfg = JaxViTConfig(**STEPS_RUNS["adamw"]["cfg"])
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=2,
                           lr=LR)
    mesh = jmesh.make_mesh(num_devices=4, model_parallel=2, seq_parallel=2)
    tx = jts.make_optimizer(jtcfg, OPT_STEPS)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    prepped = jtp.prepare_tp_params(jparams, jcfg)
    specs = jtp.tp_param_specs(prepped, jcfg)
    placed = jax.device_put(prepped, {k: NamedSharding(mesh, sp)
                                      for k, sp in specs.items()})
    opt = jax.jit(tx.init)(placed)
    rep = NamedSharding(mesh, P())
    fn = jts.make_tp_cp_train_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), k=OPT_STEPS,
        guard_padded_steps=False)
    p, o, m = fn(placed, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:OPT_STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))

    def reference(tree):
        return {k: np.asarray(v) for k, v in jtp.restore_reference_params(
            jax.device_get(tree), jcfg).items()}

    return reference(p), np.asarray(m), reference(o[0].nu)


def test_tp_cp_matches_jax_make_tp_cp_train_step(comp):
    """The port's AdamW run (data 1 x seq 2 x model 2) against the JAX
    make_tp_cp_train_step on a 1 x 2 x 2 mesh (jax_tp_cp_step, run while
    the ranks ran): the same params, the same index matrix, the same
    schedule."""
    want, want_m, want_nu = comp["jax"]
    adamw_bound_check(comp["runs"]["adamw", 0], want, want_m, want_nu,
                      comp["params"]["adamw"])


def test_tp_cp_fit_and_cli_write_reference_checkpoints(comp, monkeypatch,
                                                       tmp_path):
    """fit with sequence_parallel 2 and model_parallel 2, and the train CLI
    with --sequence_parallel 2 --model_parallel 2 (N = 65 padded to 66,
    the kernel ring of chunk twins), on four ranks (check_fits)."""
    check_fits(comp, list(FITS), monkeypatch, tmp_path)


# ---- no processes ----

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


@pytest.mark.parametrize("world,p,r,t", [(4, 1, 2, 2), (8, 1, 2, 2),
                                         (4, 2, 2, 1), (8, 2, 2, 2)])
def test_make_mesh_follows_the_jax_device_layout(world, p, r, t):
    """Each rank sits where the JAX make_mesh puts device r (its
    ('data', 'seq', 'model') or ('data', 'pipe', 'seq', 'model') grid),
    and its groups are the JAX axes through it: the ring (the seq axis,
    ranks T apart), the model row, the stage chain, data_group (data x seq)
    and replica_group (data x pipe x seq)."""
    jm = jmesh.make_mesh(num_devices=world, model_parallel=t,
                         seq_parallel=r, pipe_parallel=p)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    grid = ids.reshape(world // (p * r * t), p, r, t)
    d = world // (p * r * t)
    want_shape = {k: v for k, v in dict(jm.shape).items() if v > 1 or k
                  == DATA_AXIS}
    for rank in range(world):
        with fake_group(world, rank):
            mesh = tmesh.make_mesh(batch_size=4 * d, model_parallel=t,
                                   seq_parallel=r, pipe_parallel=p)
            pos = (mesh.data_rank, mesh.pipe_rank, mesh.seq_rank,
                   mesh.model_rank)
        assert grid[pos] == rank
        assert mesh.shape == want_shape and mesh.size == d
        i, s, q, m = pos
        ring = mesh.seq_ring
        assert ring.group == tuple(grid[i, s, :, m])
        assert (ring.rank, ring.size) == (q, r)
        assert ring.next == grid[i, s, (q + 1) % r, m]
        assert ring.prev == grid[i, s, (q - 1) % r, m]
        assert mesh.data_group == tuple(sorted(grid[:, s, :, m].ravel()))
        if t > 1:
            assert mesh.model_group == tuple(grid[i, s, q, :])
        else:
            assert mesh.model_group is None
        if p > 1:
            assert mesh.pipe_chain.group == tuple(grid[i, :, q, m])
            assert (mesh.pipe_chain.rank, mesh.pipe_chain.size) == (s, p)
            assert mesh.replica_group == (
                tuple(sorted(grid[..., m].ravel())) if t > 1 else None)
        else:
            assert mesh.pipe_chain is None


@pytest.mark.parametrize("case", ["zero1", "dropout", "heads",
                                  "q_chunk_tp", "q_chunk_pp"])
def test_fit_refuses_what_jax_refuses_under_tp_cp(case):
    """The JAX refusals under TP x CP, in their words: configs.TrainConfig
    refuses --zero1 with the three axes and --q_chunk (the bounded driver,
    whose ring takes replicated params) with a model or a pipe axis beside
    the sequence axis, the fit refuses dropout and a
    model width that does not divide the heads (on a process group of
    four ranks, faked: each check comes before any collective);
    apply_tp_cp (apply_cp) refuses dropout itself."""
    base = dict(dataset="mnist", batch_size=32, sequence_parallel=2,
                model_parallel=2)
    if case == "zero1":
        with pytest.raises(ValueError, match="zero1 composes with "
                           "sequence_parallel OR model_parallel, not the "
                           "3-axis product"):
            TrainConfig(**base, zero1=True)
        return
    if case.startswith("q_chunk"):
        axis = dict(q_chunk_tp={}, q_chunk_pp=dict(model_parallel=1,
                                                   pipeline_parallel=2))
        with pytest.raises(ValueError, match="not with model/pipeline "
                           "parallelism"):
            TrainConfig(**dict(base, **axis[case]), q_chunk=512)
        return
    if case == "dropout":
        cfg = ViTConfig(**dict(FIT_KW, drop_rate=0.1))
        with pytest.raises(ValueError, match="context parallelism does "
                           "not support dropout"):
            tp_cp.apply_tp_cp({}, None, cfg, None)
        match = ("sequence_parallel/pipeline_parallel do not support "
                 "dropout rates > 0")
    else:
        cfg = ViTConfig(**dict(FIT_KW, num_heads=2, embed_dim=32))
        base["model_parallel"] = 4
        match = "model_parallel=4 must divide num_heads=2"
    world = 2 * 2 * base["model_parallel"]
    with pytest.raises(ValueError, match=match), fake_group(world, 0):
        loop.fit(cfg, TrainConfig(**base), verbose=False, device="cpu")
