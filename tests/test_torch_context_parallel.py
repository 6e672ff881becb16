"""PyTorch port, context parallelism over torch.distributed
(parallel/context_parallel.py, the sequence axis of parallel/mesh.py, the
ring hop of parallel/distributed.py, make_train_step on a sequence axis,
ZeRO-1 x CP, fit and the train CLI with sequence_parallel, and the bounded
driver's per-q-chunk ring), on the CPU.

Ranks run as gloo subprocesses on a free localhost port, one intra-op
thread each, forked from one process of tests/torch_cp_worker.py, once per
module fixture. The model is the JAX tests' small config (16 px, patch 4,
embed 64, depth 2, 4 heads, N = 17 tokens: 9 a rank at R = 2, the last
shard holding one padding token).

Tolerances:
* the rings against the port's one-device attention on the same inputs:
  the plain ring (float32) against the unfused attention, the kernel ring
  on the chunk twins with float32 products against the streaming twins
  (attention_stream_plain, attention_stream_bwd_fused_plain): outputs
  within RING_TOL of their largest entry, lse within RING_TOL absolute,
  gradients within RING_GRAD_TOL of their largest entry (the JAX test's
  limits, float32 sums in another order, an online softmax merged over
  other tiles);
* apply_cp against models.vit.apply: rtol 2e-4 / atol 2e-5 (the JAX
  test_apply_cp_matches_apply bound);
* the CP step (unfused attention, the plain ring) against the port's
  one-device step (SGD, linear in the gradient): logits within CP_TOL of
  their largest entry, each parameter update within CP_TOL of the largest
  update entry, the losses within rtol CP_TOL; the mutants (no gradient
  sum over the ring; dk / dv left where they were computed) miss it by
  more than 10x. The kernel ring's step (bf16 products in the chunk twins)
  against the one-device kernel twins within FLASH_CP_TOL: a float32-order
  difference flips bf16 roundings of p and ds (2^-9 of the entry);
* ZeRO-1 x CP against CP with the replicated AdamW, remat against none:
  bit for bit;
* against the JAX make_cp_train_step on a 1 x 2 mesh (AdamW): as
  tests/test_torch_tensor_parallel.py holds TP to JAX;
* the bounded ring (float32 products) against the one-device bounded step
  (N = 257, the second shard padding only, and N = 577, valid tokens on
  both shards): the losses within rtol BOUNDED_TOL, the params after two AdamW steps
  within PARAM_TOL (tests/test_torch_bounded.py's limit: Adam turns
  float32 noise in gradients near zero into differences of the order of
  lr); force_ring on one rank: bit for bit.
"""

import contextlib
import functools
import json
import shutil
import types

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
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.ops import reference_attention
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import mesh as tmesh
from vit_rpe_rope_tpu_torch.train import bounded, loop
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils.convert import params_from_jax

from torch_cp_worker import FIT_KW, launch

RING_TOL = 1e-5
RING_GRAD_TOL = 1e-4
CP_TOL = 1e-5
FLASH_CP_TOL = 2e-3
JAX_TOL = 1e-5
BOUNDED_TOL = 2e-5
PARAM_TOL = dict(rtol=5e-4, atol=5e-6)

KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
          num_heads=4, attention_impl="reference")
PE_MODES = ("none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed")
BATCH, STEPS, OPT_STEPS, LR, SGD_LR = 16, 3, 2, 1e-3, 0.05


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


# ---- the rings on R ranks ----

RING_B, RING_H, RING_D, RING_N = 2, 2, 16, 37
GRID = 6  # 36 patches and the cls token


def ring_cases(world):
    """The ring cases: the plain ring in four bias regimes and the kernel
    ring in three, on 37 tokens (padded to R shards), and a kernel-ring
    case whose last shard holds padding only (a key chunk that every row
    masks whole)."""
    nl = -(-RING_N // world)
    cases = [dict(name=f"plain_{b}", ring="plain", bias=b, n_valid=RING_N,
                  nl=nl, n=RING_N, grid=GRID)
             for b in ("none", "dense", "poly", "rel")]
    cases += [dict(name=f"flash_{b}", ring="flash", bias=b, n_valid=RING_N,
                   nl=nl, n=RING_N, grid=GRID)
              for b in ("none", "poly", "rel")]
    cases.append(dict(name="flash_masked_hop", ring="flash", bias="rel",
                      n_valid=(world - 1) * 16 - 5, nl=16, n=16 * world,
                      grid=GRID))
    return cases


def ring_inputs(case, seed):
    rng = np.random.default_rng(seed)
    n = case["n"]
    arr = {t: rng.normal(size=(RING_B, RING_H, n, RING_D)).astype(np.float32)
           for t in "qkvg"}
    if case["bias"] == "dense":
        arr["bias"] = rng.normal(size=(RING_H, n, n)).astype(np.float32)
    elif case["bias"] == "poly":
        arr["bias_arg"] = (0.3 * rng.normal(size=(RING_H, 4))
                           ).astype(np.float32)
    elif case["bias"] == "rel":
        arr["bias_arg"] = rng.normal(size=(RING_H, 2 * n - 1)
                                     ).astype(np.float32)
    return arr


@pytest.fixture(scope="module")
def rings(tmp_path_factory):
    out = tmp_path_factory.mktemp("cp_rings")
    inputs = {}
    for world in (2, 4):
        cases = ring_cases(world)
        arrays = {}
        for i, case in enumerate(cases):
            arr = ring_inputs(case, 100 * world + i)
            inputs[world, case["name"]] = (case, arr)
            arrays.update({f"{case['name']}:{k}": v for k, v in arr.items()})
        np.savez(out / f"ring_{world}.npz", **arrays)
        (out / f"ring_{world}.json").write_text(json.dumps(cases))
        launch("ring", out, world)
    got = {}
    for world in (2, 4):
        ranks = []
        for r in range(world):
            with np.load(out / f"ring_{world}_rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
        got[world] = ranks
    return inputs, got


def assembled(ranks, key, n):
    """The ranks' token shards of `key` joined along the tokens, cut to n."""
    return np.concatenate([r[key] for r in ranks], axis=2)[:, :, :n]


def share(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def one_device_plain(case, arr):
    """The port's unfused attention on the whole sequence, its output and
    the gradients of <out, g> (the bias parameters' through the bias)."""
    q, k, v = (torch.from_numpy(arr[t]).requires_grad_() for t in "qkv")
    n, kind = case["n"], case["bias"]
    leaves = [q, k, v]
    bias = None
    if kind == "dense":
        bias = torch.from_numpy(arr["bias"]).requires_grad_()
        leaves.append(bias)
    elif kind in ("poly", "rel"):
        arg = torch.from_numpy(arr["bias_arg"]).requires_grad_()
        leaves.append(arg)
        bias = (fa._poly_bias_cols(arg, GRID, n, 0, n, arg.shape[1] - 1,
                                   n_valid=n) if kind == "poly"
                else fa._rel_bias_cols(arg, n, 0, n))
    out = reference_attention.attention(q, k, v, RING_D ** -0.5, bias=bias)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(arr["g"]))
    return out.detach().numpy(), [g.numpy() for g in grads]


def one_device_flash(case, arr):
    """The streaming twins on the whole sequence with float32 products:
    (out, lse, dq, dk, dv, dparam)."""
    q, k, v, g = (torch.from_numpy(arr[t]) for t in "qkvg")
    kw = {}
    if case["bias"] == "poly":
        kw["poly"] = (torch.from_numpy(arr["bias_arg"]), GRID)
    elif case["bias"] == "rel":
        kw["rel"] = torch.from_numpy(arr["bias_arg"])
    n_valid = case["n_valid"]
    out, lse = fa.attention_stream_plain(q, k, v, RING_D ** -0.5,
                                         mm_dtype=torch.float32,
                                         n_valid=n_valid, **kw)
    delta = (g * out).sum(-1)
    dq, dk, dv, dcoeff, dtable = fa.attention_stream_bwd_fused_plain(
        q, k, v, g, lse, delta, RING_D ** -0.5, n_valid=n_valid,
        mm_dtype=torch.float32, **kw)
    dparam = dcoeff if dcoeff is not None else dtable
    return [x.numpy() for x in (out, lse, dq, dk, dv)] + [
        None if dparam is None else dparam.numpy()]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bias", ["none", "dense", "poly", "rel"])
def test_ring_attention_matches_one_device(rings, world, bias):
    """The plain ring on R ranks (37 tokens, padded to R shards, the keys
    past 37 masked) against the unfused attention: the output and the
    gradients of q, k, v and the bias (a dense bias sliced to each rank's
    rows; the polynomial coefficients / relative table summed over the
    ranks)."""
    inputs, got = rings
    case, arr = inputs[world, f"plain_{bias}"]
    ranks = got[world]
    name, n = case["name"], case["n"]
    want_out, want_grads = one_device_plain(case, arr)
    assert share(assembled(ranks, f"{name}:out", n), want_out) < RING_TOL
    for t, want in zip("qkv", want_grads):
        err = share(assembled(ranks, f"{name}:d{t}", n), want)
        assert err < RING_GRAD_TOL, (t, err)
    if bias == "dense":
        dbias = np.concatenate([r[f"{name}:dbias"] for r in ranks],
                               axis=1)[:, :n, :n]
        assert share(dbias, want_grads[3]) < RING_GRAD_TOL
    if bias in ("poly", "rel"):
        dparam = sum(r[f"{name}:dparam"] for r in ranks)
        assert share(dparam, want_grads[3]) < RING_GRAD_TOL


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("bias", ["none", "poly", "rel", "masked_hop"])
def test_ring_flash_matches_the_streaming_twins(rings, world, bias):
    """The kernel ring (RingFlashAttention on the chunk twins, float32
    products) on R ranks against the streaming twins on the whole sequence:
    out, lse, dq, dk, dv and the generated bias' parameter gradient summed
    over the ranks. masked_hop: the last shard holds padding only, so every
    row's hop over it is a key chunk masked whole; the merge keeps every
    value finite."""
    inputs, got = rings
    case, arr = inputs[world, f"flash_{bias}"]
    ranks = got[world]
    name, n = case["name"], case["n"]
    want = one_device_flash(case, arr)
    got_out = assembled(ranks, f"{name}:out", n)
    got_lse = np.concatenate([r[f"{name}:lse"] for r in ranks], 2)[:, :, :n]
    assert np.isfinite(got_out).all() and np.isfinite(got_lse).all()
    assert share(got_out, want[0]) < RING_TOL
    np.testing.assert_allclose(got_lse, want[1], rtol=0, atol=RING_TOL)
    for t, w in zip("qkv", want[2:5]):
        g = assembled(ranks, f"{name}:d{t}", n)
        assert np.isfinite(g).all()
        assert share(g, w) < RING_GRAD_TOL, (t, share(g, w))
    if want[5] is not None:
        dparam = sum(r[f"{name}:dparam"] for r in ranks)
        assert share(dparam, want[5]) < RING_GRAD_TOL


# ---- the CP train step on two ranks ----

def spec(pe="rope-mixed", opt="sgd", steps=STEPS, **extra):
    run_keys = ("mutant", "k")  # the run's, not the config's
    cfg = dict(KW, pos_encoding=pe,
               **{k: v for k, v in extra.items() if k not in run_keys})
    return dict(cfg=cfg, opt=opt, steps=steps,
                **{k: v for k, v in extra.items() if k in run_keys})


RUNS = {
    **{f"apply_{pe}": spec(pe, steps=0) for pe in PE_MODES},
    **{f"sgd_{pe}": spec(pe) for pe in ("relative", "rope-mixed")},
    **{f"flash_{pe}": spec(pe, attention_impl="flash")
       for pe in ("relative", "rope-mixed")},
    "adamw": spec(opt="adamw", steps=OPT_STEPS),
    "flash_adamw": spec("relative", opt="adamw", steps=OPT_STEPS,
                        attention_impl="flash"),
    "flash_zero1": spec("relative", opt="zero1", steps=OPT_STEPS,
                        attention_impl="flash"),
    **{f"remat_{policy}": spec("relative", attention_impl="flash",
                               remat=True, remat_policy=policy)
       for policy in ("full", "softmax")},
    "multi_step": spec("relative", attention_impl="flash", k=STEPS),
    "mutant_no_seq_sum": spec("relative", mutant="no_seq_sum"),
    "mutant_dkdv_stay": spec("relative", attention_impl="flash",
                             mutant="dkdv_stay"),
}


def jax_init(kw):
    """The JAX package's init, carried over by utils/convert."""
    jparams = jvit.init_params(jax.random.PRNGKey(0), JaxViTConfig(**kw))
    full = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                           ViTConfig(**kw))
    return {k: full[k].numpy() for k in jparams}


@functools.lru_cache(maxsize=None)
def run_init(pe, jax_params=False):
    """A run's initial params: the port's init, or (for the run held to
    the JAX make_cp_train_step) the JAX package's, carried over."""
    kw = dict(KW, pos_encoding=pe)
    if jax_params:
        return jax_init(kw)
    return {k: v.numpy() for k, v in vit.init_params(
        torch.Generator().manual_seed(0), ViTConfig(**kw),
        device="cpu").items()}


def inputs():
    bundle = datasets.synthetic("mnist", n_train=56, n_test=8, seed=7)
    order = np.random.default_rng(7).permutation(56)
    slots = np.full(4 * BATCH, -1, np.int64)
    pad = {2 * BATCH + 3, 2 * BATCH + 12, 3 * BATCH + 1, 3 * BATCH + 9,
           3 * BATCH + 10, 3 * BATCH + 14, BATCH + 15, 3 * BATCH}
    slots[[i for i in range(4 * BATCH) if i not in pad]] = order
    return bundle, slots.reshape(4, BATCH)


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("cp_steps")
    bundle, idx = inputs()
    with one_intra_op_thread():
        params = {name: run_init(s["cfg"]["pos_encoding"], name == "adamw")
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


def one_device(steps, name):
    """The port's one-device run of a run's SGD steps: (logits of the
    initial params, params after the steps, metrics)."""
    s = RUNS[name]
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


@pytest.mark.parametrize("pe", PE_MODES)
def test_apply_cp_matches_apply(steps, pe):
    """apply_cp on two ranks (9 tokens a rank, one padding token) against
    models.vit.apply, in every PE mode, on both ranks."""
    bundle = steps["bundle"]
    cfg = ViTConfig(**RUNS[f"apply_{pe}"]["cfg"])
    params = {k: torch.from_numpy(v) for k, v in
              steps["params"][f"apply_{pe}"].items()}
    pre = ts.make_preprocess(cfg, bundle.mean, bundle.std, 28)
    with torch.no_grad():
        want = vit.apply(params, pre(torch.from_numpy(bundle.test_x)),
                         cfg).numpy()
    for rank in (0, 1):
        np.testing.assert_allclose(steps["runs"][f"apply_{pe}", rank][
            "logits"], want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["sgd_relative", "sgd_rope-mixed",
                                  "flash_relative", "flash_rope-mixed"])
def test_cp_step_matches_the_one_device_port(steps, name):
    """A 3-step SGD trajectory on two ranks (padded rows in two batches)
    against the one-device run: the plain ring against the unfused
    attention, the kernel ring's chunk twins against the one-device kernel
    twins; both ranks hold the same params."""
    want_logits, want_p, want_m = one_device(steps, name)
    flash = RUNS[name]["cfg"]["attention_impl"] == "flash"
    tol = FLASH_CP_TOL if flash else CP_TOL
    got = steps["runs"][name, 0]
    init = steps["params"][name]
    np.testing.assert_allclose(got["logits"], want_logits, rtol=0,
                               atol=tol * np.abs(want_logits).max())
    assert update_err(got, want_p, init) < tol
    np.testing.assert_allclose(got["metrics"][:, 0], want_m[:, 0], rtol=tol)
    np.testing.assert_array_equal(got["metrics"][:, 2], want_m[:, 2])
    other = steps["runs"][name, 1]
    for key in got:
        np.testing.assert_array_equal(got[key], other[key], err_msg=key)


@pytest.mark.parametrize("mutant,bound", [
    ("mutant_no_seq_sum", CP_TOL), ("mutant_dkdv_stay", FLASH_CP_TOL)])
def test_mutants_miss_the_cp_bound(steps, mutant, bound):
    """Without the gradient sum over the ring, or with the dk / dv
    accumulators left on the rank that computed them, the step misses its
    bound by more than 10x."""
    twin = "sgd_relative" if mutant.endswith("seq_sum") else "flash_relative"
    _, want_p, _ = one_device(steps, twin)
    err = update_err(steps["runs"][mutant, 0], want_p,
                     steps["params"][mutant])
    assert err > 10 * bound, err


@pytest.mark.parametrize("run,twin", [("flash_zero1", "flash_adamw")])
def test_zero1_cp_bit_equal_to_cp(steps, run, twin):
    """ZeRO-1 x CP (the moments sliced over both ranks) against CP with the
    replicated AdamW: params, moments, count, metrics, bit for bit."""
    for rank in (0, 1):
        a, b = steps["runs"][run, rank], steps["runs"][twin, rank]
        assert set(a) == set(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("run", ["remat_full", "remat_softmax",
                                 "multi_step"])
def test_remat_cp_bit_equal_to_cp(steps, run):
    """Remat of the CP block (each block recomputed in the backward, its
    ring hops with it; under "softmax" the collectives run again while the
    other ops are saved), and the k-step driver (its 3 steps in one call,
    eagerly under a process group), give the kernel ring's run bit for
    bit."""
    for rank in (0, 1):
        a, b = steps["runs"][run, rank], steps["runs"]["flash_relative", rank]
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_cp_matches_jax_make_cp_train_step(steps):
    """The port's two-rank AdamW run (the plain ring) against the JAX
    make_cp_train_step on a 1 x 2 mesh: the same params, the same index
    matrix, the same schedule."""
    bundle, idx = steps["bundle"], steps["idx"]
    s = RUNS["adamw"]
    jcfg = JaxViTConfig(**s["cfg"])
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=2,
                           lr=LR)
    mesh = jmesh.make_mesh(num_devices=2, seq_parallel=2)
    tx = jts.make_optimizer(jtcfg, OPT_STEPS)
    rep = NamedSharding(mesh, P())
    placed = jax.device_put({k: jnp.asarray(v) for k, v in
                             steps["params"]["adamw"].items()}, rep)
    opt = jax.device_put(tx.init(placed), rep)
    fn = jts.make_cp_train_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), k=OPT_STEPS,
        guard_padded_steps=False)
    p, o, m = fn(placed, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:OPT_STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))
    want = {k: np.asarray(v) for k, v in jax.device_get(p).items()}
    want_m = np.asarray(m)
    want_nu = {k: np.asarray(v) for k, v in
               jax.device_get(o[0].nu).items()}

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


# ---- the bounded driver's ring ----

BOUNDED_KW = dict(img_size=64, patch_size=4, in_chans=3, embed_dim=32,
                  depth=2, num_heads=2, attention_impl="reference")
BOUNDED_RUNS = {f"{par}_{pe}": dict(cfg=dict(BOUNDED_KW, pos_encoding=pe),
                                    seq=2 if par == "cp" else 1, steps=2)
                for par, pe in (("cp", "rope-axial"), ("cp", "relative"),
                                ("dp", "relative"))}
# N = 577 (96 px): n_pad 1,024, so the second shard holds 65 valid tokens:
# its rows' generated bias at row0 = 512, its keys' dk / dv riding home and
# its rows' share of the relative table's gradient all count.
BOUNDED_RUNS["cp_relative_n577"] = dict(
    cfg=dict(BOUNDED_KW, pos_encoding="relative", img_size=96), seq=2,
    steps=2)


def bounded_inputs():
    rng = np.random.default_rng(3)
    arrays = dict(images=rng.integers(0, 256, (4, 64, 64, 3), np.uint8),
                  labels=rng.integers(0, 10, (4,)).astype(np.int64),
                  mask=np.array([1, 1, 1, 0], np.float32),
                  mean=np.float32(datasets.NORMALIZATION["cifar10"][0]),
                  std=np.float32(datasets.NORMALIZATION["cifar10"][1]))
    for name, spec_ in BOUNDED_RUNS.items():
        cfg = ViTConfig(**spec_["cfg"])
        init = vit.init_params(torch.Generator().manual_seed(5), cfg,
                               device="cpu")
        arrays.update({f"{name}:p:{k}": v.numpy() for k, v in init.items()})
        if cfg.img_size != 64:
            arrays[f"{name}:images"] = rng.integers(
                0, 256, (4, cfg.img_size, cfg.img_size, 3), np.uint8)
    return arrays


@pytest.fixture(scope="module")
def bounded_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cp_bounded")
    with one_intra_op_thread():
        arrays = bounded_inputs()
    np.savez(out / "bounded.npz", **arrays)
    (out / "bounded.json").write_text(json.dumps(BOUNDED_RUNS))
    launch("bounded", out, 2)
    launch("force_ring", out, 1)
    got = {}
    for name in BOUNDED_RUNS:
        for r in (0, 1):
            with np.load(out / f"bounded_{name}_rank{r}.npz") as z:
                got[name, r] = {k: z[k] for k in z.files}
    with np.load(out / "force_ring.npz") as z:
        forced = {k: z[k] for k in z.files}
    return arrays, got, forced


def one_device_bounded(arrays, name):
    """The one-device bounded step (float32 products, the fused AdamW) on
    the same whole batch: (params, metrics, evaluation)."""
    from torch_cp_worker import bounded_run

    z = {k: torch.from_numpy(v) for k, v in arrays.items()
         if ":" not in k}
    z.update({k.split(":", 1)[1]: torch.from_numpy(v)
              for k, v in arrays.items() if k.startswith(f"{name}:")})
    return bounded_run(ViTConfig(**BOUNDED_RUNS[name]["cfg"]), z,
                       BOUNDED_RUNS[name]["steps"])


@pytest.mark.parametrize("name", list(BOUNDED_RUNS))
def test_bounded_ring_matches_the_one_device_step(bounded_runs, name):
    """Two AdamW steps of the bounded driver (N = 257; a masked example)
    over two ranks, as the KV ring of R = 2 (n_pad 1,024: the second
    shard holds padding only, so every q-chunk's second hop is a key chunk
    masked whole; at N = 577 it holds 65 valid tokens) and as data
    parallelism (the ring of one rank over two data ranks), against the
    one-device bounded step: losses, params and the bounded evaluation;
    both ranks hold the same params."""
    arrays, got, _ = bounded_runs
    want_p, want_m, want_eval = one_device_bounded(arrays, name)
    g = got[name, 0]
    np.testing.assert_allclose(g["metrics"][:, 0], want_m[:, 0],
                               rtol=BOUNDED_TOL)
    np.testing.assert_array_equal(g["metrics"][:, 1:], want_m[:, 1:])
    np.testing.assert_allclose(g["evaluation"][0], want_eval[0],
                               rtol=BOUNDED_TOL)
    np.testing.assert_array_equal(g["evaluation"][1:], want_eval[1:])
    for key, want in want_p.items():
        np.testing.assert_allclose(g[f"p:{key}"], want, **PARAM_TOL,
                                   err_msg=key)
    for key in g:
        np.testing.assert_array_equal(g[key], got[name, 1][key],
                                      err_msg=key)


@pytest.mark.parametrize("pe", ["relative"])
def test_force_ring_on_one_rank_is_the_plain_step(bounded_runs, pe):
    """force_ring on a process group of one rank runs the ring's code path
    (a ring of one rank: one hop, the merge, the all_reduce of one) and
    gives the one-device bounded step's metrics and params bit for bit."""
    _, _, forced = bounded_runs
    keys = [k for k in forced if k.startswith(f"cp_{pe}:ring:")]
    assert keys
    for key in keys:
        np.testing.assert_array_equal(
            forced[key], forced[key.replace(":ring:", ":plain:")],
            err_msg=key)


def test_bounded_ring_refuses_kv_chunk_and_a_local_mesh():
    """kv_chunk does not compose with a mesh (the JAX words); a mesh of
    local devices, or seq_parallel / force_ring without a mesh, raise."""
    cfg = ViTConfig(**dict(BOUNDED_KW, pos_encoding="rope-axial"))
    make = functools.partial(bounded.make_bounded_step, cfg,
                             TrainConfig(dataset="cifar10"), None, None)
    fake = types.SimpleNamespace(distributed=True, ranks=(0, 1),
                                 seq_parallel=2, model_parallel=1,
                                 shape={"data": 1, "seq": 2},
                                 seq_ring=None, seq_rank=0)
    with pytest.raises(ValueError, match="kv_chunk does not compose"):
        make(kv_chunk=512, mesh=fake, seq_parallel=2)
    with pytest.raises(ValueError, match="needs a mesh whose 'seq' axis"):
        make(mesh=fake, seq_parallel=4)
    with pytest.raises(ValueError, match="process group"):
        make(mesh=tmesh.make_mesh(devices=["cpu"]))
    for kw in (dict(seq_parallel=2), dict(force_ring=True)):
        with pytest.raises(ValueError, match="require a mesh"):
            make(**kw)


# ---- fit and the CLI on two ranks ----

LAST = "mnist_rope-mixed_last.npz"


def small_data(monkeypatch, n_train=64, n_test=32):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                  seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    out = tmp_path_factory.mktemp("cp_fit")
    launch("fit", out, 2)
    return out, [json.loads((out / f"fit_rank{r}.json").read_text())
                 for r in range(2)]


def rows(history):
    return [{k: v for k, v in h.items() if k != "images_per_sec"}
            for h in history]


def last_state(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_cp_fit_writes_one_csv_and_reference_checkpoints(fits):
    """fit with sequence_parallel 2, alone and with --zero1 (with q_chunk:
    tests/test_torch_train.py::test_fit_refuses_bounded_stepping): rank 0
    alone writes the CSV, `_best.npz` and `_last.npz` (the
    reference keys and shapes, the moments as the canonical flat vectors);
    both ranks report the same rows over 2 devices."""
    out, summaries = fits
    cfg = ViTConfig(**FIT_KW)
    ref = {k: v.shape for k, v in vit.init_params(
        torch.Generator(), cfg, device="cpu").items()}
    total = loop.moment_flattener(vit.init_params(
        torch.Generator(), cfg, device="cpu"), cfg).total
    for name in ("cp", "cpz"):
        lead, other = summaries[0][name], summaries[1][name]
        assert other["log_file"] is None
        assert rows(other["history"]) == rows(lead["history"])
        assert lead["num_devices"] == 2
        assert np.isfinite(lead["history"][0]["train_loss"])
        assert [str(p) for p in (out / name / "logs").glob("*.csv")] == [
            lead["log_file"]]
        state = last_state(out / name / "ckpts" / LAST)
        for key, shape in ref.items():
            assert state[key].shape == shape, key
        assert state["__opt.1"].shape == state["__opt.2"].shape == (total,)
        assert int(state["__opt.0"]) == 2


def test_zero1_cp_last_state_bit_equal_to_cp(fits):
    """One epoch with and without --zero1 leaves the same `_last.npz`, bit
    for bit: the moments sliced over both ranks, gathered into the
    canonical vectors, are the replicated optimizer's."""
    out, summaries = fits
    z = last_state(out / "cpz" / "ckpts" / LAST)
    d = last_state(out / "cp" / "ckpts" / LAST)
    assert set(z) == set(d)
    for key in z:
        np.testing.assert_array_equal(z[key], d[key], err_msg=key)
    assert rows(summaries[0]["cp"]["history"]) == rows(
        summaries[0]["cpz"]["history"])


def test_cp_last_state_resumes_at_world_size_1(fits, monkeypatch, tmp_path):
    """The two-rank `_last.npz` resumes in one process for a second
    epoch."""
    out, _ = fits
    shutil.copytree(out / "cp" / "ckpts", tmp_path / "ckpts")
    small_data(monkeypatch)
    tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=2,
                       synthetic_data=True, resume=True,
                       log_dir=str(tmp_path / "logs"),
                       ckpt_dir=str(tmp_path / "ckpts"))
    resumed = loop.fit(ViTConfig(**FIT_KW), tcfg, verbose=False,
                       device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert int(last_state(tmp_path / "ckpts" / LAST)["__opt.0"]) == 4


# ---- unit cases, no processes ----

def test_make_mesh_seq_axis(monkeypatch):
    """On a process group of 6 ranks with seq_parallel 3, rank 5 is data
    rank 1 of 2 and seq rank 2 of 3, takes the second half of each batch,
    and its ring is its data row (ranks 3, 4, 5; next 3, previous 4); the
    data width must divide the batch; seq_parallel must divide the world.
    With model_parallel 2 (TP x CP, tests/test_torch_tp_cp.py) rank 5 is
    seq rank 2 and model rank 1 of the one data position, and its ring is
    its model position's ranks 1, 3, 5 (next 1, previous 3)."""
    monkeypatch.setattr(distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed, "world_size", lambda: 6)
    monkeypatch.setattr(distributed, "rank", lambda: 5)
    monkeypatch.setattr(distributed, "device", lambda: torch.device("cpu"))
    made = []
    monkeypatch.setattr(distributed, "new_group",
                        lambda ranks: made.append(list(ranks)) or len(made))
    mesh = tmesh.make_mesh(batch_size=8, seq_parallel=3)
    assert mesh.shape == {tmesh.DATA_AXIS: 2, tmesh.SEQ_AXIS: 3}
    assert (mesh.rank, mesh.size, mesh.seq_rank) == (1, 2, 2)
    assert made == [[0, 1, 2], [3, 4, 5]]
    ring = mesh.seq_ring
    assert (ring.group, ring.rank, ring.size, ring.next, ring.prev) == (
        2, 2, 3, 3, 4)
    assert ts._columns(mesh, 8) == slice(4, 8)
    assert ts._world(mesh) == (5, 6)
    with pytest.raises(ValueError, match="not a multiple of the data width"):
        tmesh.make_mesh(batch_size=9, seq_parallel=3)
    with pytest.raises(ValueError, match="not divisible by model_parallel=1"
                       " × seq_parallel=4"):
        tmesh.make_mesh(seq_parallel=4)
    made.clear()
    mesh = tmesh.make_mesh(seq_parallel=3, model_parallel=2)
    assert mesh.shape == {tmesh.DATA_AXIS: 1, tmesh.SEQ_AXIS: 3,
                          tmesh.MODEL_AXIS: 2}
    assert (mesh.rank, mesh.size, mesh.seq_rank, mesh.model_rank) == (
        0, 1, 2, 1)
    # data x seq per model position, the model rows, the rings
    assert made == [[0, 2, 4], [1, 3, 5], [0, 1], [2, 3], [4, 5],
                    [0, 2, 4], [1, 3, 5]]
    ring = mesh.seq_ring
    assert (ring.group, ring.rank, ring.size, ring.next, ring.prev) == (
        7, 2, 3, 1, 3)
    assert (mesh.data_group, mesh.model_group) == (2, 5)


def test_ring_of_one_rank_makes_no_call(monkeypatch):
    """A hop over None or a ring of one rank returns its tensors and calls
    nothing; RingShift's autograd is then the identity."""
    monkeypatch.setattr(distributed.dist, "batch_isend_irecv",
                        lambda ops: pytest.fail("a hop was sent"))
    x = torch.arange(4.0, requires_grad=True)
    one = distributed.Ring(group=None, rank=0, size=1, next=0, prev=0)
    for ring in (None, one):
        assert distributed.ring_shift(ring, [x])[0] is x
        y, = distributed.ring_shift_grad(ring, x)
        assert y is x


def test_fit_refuses_dropout_under_cp(monkeypatch):
    """Dropout under context parallelism raises the JAX fit's ValueError
    (checked before any process group is needed: a fake two-rank world)."""
    monkeypatch.setattr(loop, "make_mesh", lambda **kw: types.SimpleNamespace(
        distributed=True))
    with pytest.raises(ValueError, match="do not support dropout"):
        loop.fit(ViTConfig(**dict(FIT_KW, drop_rate=0.1)),
                 TrainConfig(dataset="mnist", sequence_parallel=2),
                 device="cpu")
