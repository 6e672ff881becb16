"""The gloo ranks of tests/test_torch_tp_cp.py and
tests/test_torch_pp_tp_cp.py (the compositions with the sequence axis), on
the CPU with one intra-op thread each, through tests/torch_tp_worker.py's
`launch` and `main` (torch imported once, the ranks forked):

  MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=W \\
      python tests/torch_comp_worker.py MODE DIR [ARGS...]

MODE is a composition: tpcp (4 ranks, data 1 x seq 2 x model 2), ppcp (4
ranks, data 1 x pipe 2 x seq 2) or pptpcp (8 ranks, data 1 x pipe 2 x
seq 2 x model 2). Each reads DIR/inputs.npz (each run's initial params
"p:<run>:<key>" in the reference layout, train_x, train_y, the index
matrix idx, mean, std, the eval images eval_x) and DIR/config.json
({"apply": {run: spec}, "steps": {run: spec}, "fits": {run: spec},
"batch", "lr", "sgd_lr"}; a spec holds the ViTConfig fields, n_micro, the
STREAMING_THRESHOLD to set and, for a step run, the optimizer, steps,
accum, k steps a dispatch and the mutant). An apply run writes
DIR/<run>_rank<r>.npz: the logits of the composed forward
(train_step._mesh_forward) on the eval images and, on the kernels'
twins, those of the lone context-parallel forward at the same ring width
(context_parallel.apply_cp on the whole params, a data x seq mesh of the
same ranks: the ring's rounding points without the other axes). A step
run writes DIR/<run>_rank<r>.npz: the logits of the step's forward on the
eval images, the params after the steps gathered in the reference layout
("p:<key>"), the rank's local params ("local:<key>"), the metrics and,
for AdamW, both moments as canonical flat vectors. The mutants, for the
test to show that its bound catches them: "no_model_sync" sums the
per-head PE params' gradients over no model axis, "no_seq_sum" sums no
gradient over Mesh.data_group (at data width 1: over the ring), "apart"
runs the pipeline's ticks of sequence rank 1 one microbatch ahead of its
ring partners'; and, for an apply run on the kernels' twins, "bf16_lse"
rounds each hop's log-sum-exp to bfloat16 before the ring's logaddexp
merge (a precision fault of the size the flash bound must still catch).

Then each fit run ({"world": ..., TrainConfig fields}) trains one epoch
of loop.fit on 96 synthetic MNIST images (three steps of 32) under
DIR/<run>, and one train CLI run (ARGS) under DIR/cli; writes
DIR/fit_rank<r>.json with each run's summary.
"""

import importlib
import json
import pathlib
import sys

import numpy as np
import torch

import torch_tp_worker as tpw
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.ops import flash_attention
from vit_rpe_rope_tpu_torch.parallel import context_parallel as cp
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel as pp
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

FIT_KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
              num_heads=4, pos_encoding="rope-mixed",
              attention_impl="reference")
MESHES = {"tpcp": dict(seq_parallel=2, model_parallel=2),
          "ppcp": dict(pipe_parallel=2, seq_parallel=2),
          "pptpcp": dict(pipe_parallel=2, seq_parallel=2, model_parallel=2)}
WORLDS = {"tpcp": 4, "ppcp": 4, "pptpcp": 8}


def launch(mode, out, *args, during=None):
    return tpw.launch(mode, out, WORLDS[mode], *args, script=__file__,
                      during=during)


def mutate(mutant, mesh):
    """Patch the step into a known-wrong version; returns the undo."""
    if mutant == "no_model_sync":
        return tpw.mutate(mutant)
    if mutant == "no_seq_sum":
        real = distributed.all_reduce_sum

        def skipped(tensor, group=None):
            return tensor if group is mesh.data_group else real(tensor,
                                                                 group)

        distributed.all_reduce_sum = skipped
        return lambda: setattr(distributed, "all_reduce_sum", real)
    if mutant == "bf16_lse":
        real_fwd = flash_attention.streaming_chunk_fwd

        def rounded(*args, **kw):
            out, lse = real_fwd(*args, **kw)
            return out, lse.bfloat16().float()

        flash_attention.streaming_chunk_fwd = rounded
        return lambda: setattr(flash_attention, "streaming_chunk_fwd",
                               real_fwd)
    if mutant == "apart":
        real = pp._walk

        def walk(chain, n_micro, like, run, reverse=False):
            def ahead(t, m, received):
                return run(t, (m + 1) % n_micro, received)

            return real(chain, n_micro, like,
                        ahead if mesh.seq_rank == 1 else run, reverse)

        pp._walk = walk
        return lambda: setattr(pp, "_walk", real)
    return lambda: None


def initial(arrays, name):
    return {k.split(":", 2)[2]: torch.from_numpy(v)
            for k, v in arrays.items() if k.startswith(f"p:{name}:")}


def run_apply(out, rank, conf, arrays, mesh, cp_mesh):
    threshold = flash_attention.STREAMING_THRESHOLD
    for name, spec in conf["apply"].items():
        cfg = ViTConfig(**spec["cfg"])
        flash_attention.STREAMING_THRESHOLD = spec.get("threshold", threshold)
        pre = ts.make_preprocess(cfg, arrays["mean"], arrays["std"], 28)
        params = loop._layout(mesh).shard_reference(initial(arrays, name),
                                                    cfg, mesh)
        forward = ts._mesh_forward(mesh, spec["n_micro"])[0]
        images = pre(torch.from_numpy(arrays["eval_x"]))
        undo = mutate(spec.get("mutant"), mesh)
        with torch.no_grad():
            saved = dict(logits=forward(params, images, cfg).numpy())
        undo()
        with torch.no_grad():
            if cfg.attention_impl == "flash":  # the lone ring's rounding
                saved["cp_logits"] = cp.apply_cp(
                    initial(arrays, name), images, cfg, cp_mesh).numpy()
        flash_attention.STREAMING_THRESHOLD = threshold
        np.savez(out / f"{name}_rank{rank}.npz", **saved)


def run_steps(out, rank, conf, arrays, mesh):
    x = torch.from_numpy(arrays["train_x"])
    y = torch.from_numpy(arrays["train_y"])
    idx = torch.from_numpy(arrays["idx"])
    threshold = flash_attention.STREAMING_THRESHOLD
    for name, spec in conf["steps"].items():
        cfg = ViTConfig(**spec["cfg"])
        flash_attention.STREAMING_THRESHOLD = spec.get("threshold", threshold)
        undo = mutate(spec.get("mutant"), mesh)
        pre = ts.make_preprocess(cfg, arrays["mean"], arrays["std"], 28)
        init = initial(arrays, name)
        params = loop._layout(mesh).shard_reference(init, cfg, mesh)
        forward = ts._mesh_forward(mesh, spec["n_micro"])[0]
        with torch.no_grad():
            logits = forward(params, pre(torch.from_numpy(arrays["eval_x"])),
                             cfg)
        for v in params.values():
            v.requires_grad_(True)
        if spec["opt"] == "sgd":
            update, state = tpw.sgd(conf["sgd_lr"]), None
        else:
            tcfg = TrainConfig(dataset="mnist", batch_size=conf["batch"],
                               epochs=2, lr=conf["lr"])
            opt_init, update = ts.make_optimizer(tcfg, spec["steps"], params,
                                                 cfg=cfg, mesh=mesh)
            state = opt_init(params)
        accum, k = spec.get("accum", 1), spec.get("k", 1)
        if k > 1:  # the k-step driver, one call for all the steps
            step = ts.make_train_multi_step(cfg, update, pre, k, accum=accum,
                                            feed="gather", mesh=mesh,
                                            n_micro=spec["n_micro"])
            params, state, m = step(params, state, 0, x, y, idx)
            metrics = list(m.numpy())
        else:
            step = ts.make_train_step(cfg, update, pre, accum=accum,
                                      mesh=mesh, n_micro=spec["n_micro"])
            metrics = []
            for s in range(spec["steps"]):
                params, state, m = step(params, state, s * accum, x, y, idx)
                metrics.append(m.numpy())
        undo()
        flash_attention.STREAMING_THRESHOLD = threshold
        whole = loop._layout(mesh).gather_reference(params, cfg, mesh)
        saved = {f"p:{k}": v.detach().numpy() for k, v in whole.items()}
        saved.update({f"local:{k}": v.detach().numpy()
                      for k, v in params.items()})
        saved.update(metrics=np.stack(metrics), logits=logits.numpy())
        if spec["opt"] != "sgd":
            flat = loop.moment_flattener(init, cfg)
            leaves = loop.mesh_opt_to_disk(state, flat, cfg, mesh, params,
                                           False)
            saved.update(count=leaves[0], mu=leaves[1].numpy(),
                         nu=leaves[2].numpy())
        np.savez(out / f"{name}_rank{rank}.npz", **saved)


def run_fits(out, rank, conf, argv):
    tpw.small_data(96, 32)
    cfg = ViTConfig(**FIT_KW)
    summaries = {}
    for name, spec in conf["fits"].items():
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=1,
                           synthetic_data=True, seed=0,
                           log_dir=str(out / name / "logs"),
                           ckpt_dir=str(out / name / "ckpts"), **spec)
        summaries[name] = tpw.summary_of(
            loop.fit(cfg, tcfg, verbose=rank == 0, device="cpu"))
    summaries["cli"] = tpw.summary_of(train_cli.main(argv))
    (out / f"fit_rank{rank}.json").write_text(json.dumps(summaries))


def run_rank(mode: str, out: pathlib.Path, rank: int):
    if not distributed.initialize(device="cpu"):
        raise RuntimeError("no process group: WORLD_SIZE is not set")
    try:
        conf = json.loads((out / "config.json").read_text())
        with np.load(out / "inputs.npz") as z:
            arrays = {k: z[k] for k in z.files}
        mesh = make_mesh(batch_size=conf["batch"], **MESHES[mode])
        run_apply(out, rank, conf, arrays, mesh,
                  make_mesh(seq_parallel=MESHES[mode]["seq_parallel"]))
        run_steps(out, rank, conf, arrays, mesh)
        run_fits(out, rank, conf, sys.argv[3:])
    finally:
        distributed.finalize()


if __name__ == "__main__":
    # a rank's first custom-op call (the kernels' twins), first checkpoint
    # (remat) or first pipeline step imports it: once, before the fork,
    # not once a rank
    importlib.import_module("torch._dynamo")
    tpw.main(run_rank)
