"""PyTorch port, pipeline x context parallelism and pipeline x tensor x
context parallelism over torch.distributed (parallel/pp_tp_cp.py: the
GPipe schedule of parallel/pipeline_parallel.py with the TP x CP block in
each stage; train_step.make_train_step on a pipe and a sequence axis; fit
and the train CLI with --pipeline_parallel and --sequence_parallel), on
the CPU.

The ranks run as in tests/test_torch_tp_cp.py (tests/torch_comp_worker.py,
gloo, one intra-op thread each): one launch of four ranks (data 1 x pipe 2
x seq 2, the lone PP x CP) and one of eight (data 1 x pipe 2 x seq 2 x
model 2), each running all of its cases: the forward in the six PE modes
and on the kernels' twins, the steps, the mutants, a fit (the eight-rank
one at data 2 x seq 2 x model 2: the data axis) and a CLI run. Same model
and tolerances as tests/test_torch_tp_cp.py; the JAX cross-check is
make_pp_tp_cp_train_step on a 1 x 2 x 2 x 2 CPU mesh.

The bubble ticks of the schedule launch nothing, which is right only
while the ranks of a ring share their active ticks: the "apart" mutant
runs sequence rank 1 one microbatch ahead of its ring partner and misses
the bound, and a launch that hung instead would fail at the worker's
LAUNCH_TIMEOUT.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.parallel import mesh as jmesh
from vit_rpe_rope_tpu.parallel import pp_tp as jpp_tp
from vit_rpe_rope_tpu.parallel import tensor_parallel as jtp
from vit_rpe_rope_tpu.parallel.mesh import DATA_AXIS, NamedSharding, P
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.parallel import pp_tp_cp
from vit_rpe_rope_tpu_torch.train import loop

from test_torch_tp_cp import (
    BATCH, FIT_KW, LR, OPT_STEPS, PE_MODES, STEPS, STREAM, adamw_bound_check,
    check_apply, check_bit_equal, check_fits, check_mutant, check_shards,
    check_step, fake_group, one_thread, run_composition, spec)

assert one_thread  # the autouse fixture of one intra-op thread, here too

APPLY = {**{pe: spec(pe) for pe in PE_MODES},
         "stream_relative": spec("relative", **STREAM),
         "stream_polynomial": spec("polynomial", **STREAM)}
STEPS_RUNS = {
    "ppcp": {"sgd_rope-mixed": spec(),
             "sgd_relative": spec("relative", n_micro=4),
             "stream_relative": spec("relative", **STREAM),
             "multi_step": spec(k=STEPS),
             "mutant_no_seq_sum": spec(mutant="no_seq_sum"),
             "mutant_apart": spec(mutant="apart")},
    "pptpcp": {"sgd_rope-mixed": spec(),
               "sgd_relative": spec("relative", n_micro=4),
               "stream_relative": spec("relative", **STREAM),
               "adamw": spec(opt="adamw", steps=OPT_STEPS),
               "mutant_no_model_sync": spec("relative",
                                            mutant="no_model_sync"),
               "mutant_apart": spec(mutant="apart")},
}
FITS = {"ppcp": {"ppcp": dict(pipeline_parallel=2, sequence_parallel=2)},
        "pptpcp": {"tpcp_data2": dict(sequence_parallel=2,
                                      model_parallel=2)}}
MODES = ("ppcp", "pptpcp")


@pytest.fixture(scope="module")
def ppcp(tmp_path_factory):
    return run_composition(tmp_path_factory, "ppcp", APPLY,
                           STEPS_RUNS["ppcp"], FITS["ppcp"])


@pytest.fixture(scope="module")
def pptpcp(tmp_path_factory):
    return run_composition(tmp_path_factory, "pptpcp", APPLY,
                           STEPS_RUNS["pptpcp"], FITS["pptpcp"],
                           jax_step=jax_pp_tp_cp_step)


@pytest.mark.parametrize("mode,name", [(m, n) for m in MODES for n in APPLY])
def test_apply_pp_tp_cp_matches_the_one_device_apply(request, mode, name):
    """apply_pp_tp_cp at P = 2, M = 2 (the lone PP x CP, and with T = 2)
    in every PE mode and on the kernels' twins: the logits of vit.apply on
    every rank."""
    check_apply(request.getfixturevalue(mode), name, APPLY[name])


@pytest.mark.parametrize("mode,name", [
    (m, n) for m in MODES
    for n in ("sgd_rope-mixed", "sgd_relative", "stream_relative")])
def test_pp_cp_step_matches_the_one_device_port(request, mode, name):
    """The PP x CP and PP x TP x CP steps against the one-device step: 3
    SGD steps in rope-mixed and relative (M = 4: six ticks, three of them
    bubbles on each stage) and on the kernels' twins."""
    check_step(request.getfixturevalue(mode), name, STEPS_RUNS[mode][name])


@pytest.mark.parametrize("mode,mutant,twin", [
    ("ppcp", "mutant_no_seq_sum", "sgd_rope-mixed"),
    ("ppcp", "mutant_apart", "sgd_rope-mixed"),
    ("pptpcp", "mutant_no_model_sync", "sgd_relative"),
    ("pptpcp", "mutant_apart", "sgd_rope-mixed")])
def test_mutants_miss_the_pp_cp_bound(request, mode, mutant, twin):
    """The gradient not summed over the ring, the per-head PE params' not
    summed over the model axis, and a ring whose ranks run their
    microbatches on other ticks: each misses the bound by 10x."""
    check_mutant(request.getfixturevalue(mode), mutant,
                 STEPS_RUNS[mode][twin])


def test_bit_equal_to_the_plain_pp_cp_step(ppcp):
    """The k-step driver (eager under a process group) against one step a
    call. (Remat with the ring is held under TP x CP,
    tests/test_torch_tp_cp.py; inside the schedule, under PP x TP,
    tests/test_torch_pipeline_parallel.py.)"""
    check_bit_equal(ppcp, "multi_step", "sgd_rope-mixed")


@pytest.mark.parametrize("mode", MODES)
def test_replicated_params_bit_equal_and_blocks_sharded(request, mode):
    """Each rank holds its stage's depth / P blocks (of H / T heads); the
    ranks of one ring hold the same shards, other stages and model
    positions other ones; every replicated param is the same on every
    rank."""
    run = request.getfixturevalue(mode)
    t = 2 if mode == "pptpcp" else 1
    check_shards(run, "sgd_relative", lambda r: (r // (2 * t), r % t),
                 "blocks.mlp.fc1.weight")
    fc1 = run["runs"]["sgd_relative", 0]["local:blocks.mlp.fc1.weight"]
    assert fc1.shape == (1, 4 * 64 // t, 64)


def jax_pp_tp_cp_step(bundle, idx, params):
    """The JAX make_pp_tp_cp_train_step's AdamW run (OPT_STEPS steps, M =
    2, on a 1 x 2 x 2 x 2 CPU mesh) from `params` over the index matrix:
    (params, metrics, the second moment), in the reference layout."""
    t = 2
    jcfg = JaxViTConfig(**STEPS_RUNS["pptpcp"]["adamw"]["cfg"])
    jtcfg = JaxTrainConfig(dataset="mnist", batch_size=BATCH, epochs=2,
                           lr=LR)
    mesh = jmesh.make_mesh(num_devices=4 * t, model_parallel=t,
                           seq_parallel=2, pipe_parallel=2)
    tx = jts.make_optimizer(jtcfg, OPT_STEPS)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    stacked = jvit.stack_block_params(jtp.prepare_tp_params(jparams, jcfg),
                                      jcfg)
    specs = jpp_tp.pp_tp_param_specs(stacked)
    placed = jax.device_put(stacked, {k: NamedSharding(mesh, sp)
                                      for k, sp in specs.items()})
    opt = jax.jit(tx.init)(placed)
    rep = NamedSharding(mesh, P())
    fn = jts.make_pp_tp_cp_train_step(
        jcfg, jtcfg, mesh, tx,
        jts.make_preprocess(jcfg, bundle.mean, bundle.std, 28), n_micro=2,
        k=OPT_STEPS, guard_padded_steps=False)
    p, o, m = fn(placed, opt, jnp.asarray([0], jnp.int32),
                 jax.device_put(bundle.train_x, rep),
                 jax.device_put(bundle.train_y, rep),
                 jax.device_put(jnp.asarray(idx[:OPT_STEPS], jnp.int32),
                                NamedSharding(mesh, P(None, DATA_AXIS))))

    def reference(tree):
        return {k: np.asarray(v) for k, v in jtp.restore_reference_params(
            jvit.unstack_block_params(jax.device_get(tree), jcfg),
            jcfg).items()}

    return reference(p), np.asarray(m), reference(o[0].nu)


def test_pp_tp_cp_matches_jax_make_pp_tp_cp_train_step(pptpcp):
    """The port's AdamW run at data 1 x pipe 2 x seq 2 x model 2 against
    the JAX make_pp_tp_cp_train_step on a 1 x 2 x 2 x 2 mesh
    (jax_pp_tp_cp_step, run while the ranks ran): the same params, the
    same index matrix, the same schedule (M = 2)."""
    want, want_m, want_nu = pptpcp["jax"]
    adamw_bound_check(pptpcp["runs"]["adamw", 0], want, want_m, want_nu,
                      pptpcp["params"]["adamw"])


@pytest.mark.parametrize("mode", MODES)
def test_pp_cp_fit_and_cli_write_reference_checkpoints(request, mode,
                                                       monkeypatch,
                                                       tmp_path):
    """fit at data 1 x pipe 2 x seq 2 (four ranks) and at data 2 x seq 2 x
    model 2 (eight ranks), and the train CLI with --pipeline_parallel 2
    --sequence_parallel 2 (and --model_parallel 2 on eight ranks):
    tests/test_torch_tp_cp.py's check_fits."""
    check_fits(request.getfixturevalue(mode), list(FITS[mode]), monkeypatch,
               tmp_path)


# ---- no processes ----

@pytest.mark.parametrize("case", ["zero1", "grad_accum", "dropout"])
def test_fit_refuses_what_jax_refuses_under_pp_cp(case):
    """The refusals with a pipe and a sequence axis, in the JAX words:
    configs.TrainConfig refuses --zero1 with a pipe axis; the fit refuses
    grad_accum with a pipe axis and dropout (on a faked process group of
    eight ranks: each check comes before any collective); apply_pp_tp_cp
    refuses dropout itself."""
    base = dict(dataset="mnist", batch_size=32, pipeline_parallel=2,
                sequence_parallel=2)
    if case == "zero1":
        with pytest.raises(ValueError, match="zero1 is incompatible with "
                           "pipeline parallelism > 1"):
            TrainConfig(**base, zero1=True)
        return
    cfg = ViTConfig(**FIT_KW)
    if case == "grad_accum":
        base["grad_accum"] = 2
        match = ("grad_accum > 1 is not supported with pipeline "
                 "parallelism \\(use --pp_microbatches")
    else:
        cfg = ViTConfig(**dict(FIT_KW, drop_path_rate=0.1))
        with pytest.raises(ValueError, match="pp×tp×cp does not support "
                           "dropout"):
            pp_tp_cp.apply_pp_tp_cp({}, None, cfg, None, 2)
        match = ("sequence_parallel/pipeline_parallel do not support "
                 "dropout rates > 0")
    with pytest.raises(ValueError, match=match), fake_group(8, 0):
        loop.fit(cfg, TrainConfig(**base), verbose=False, device="cpu")
