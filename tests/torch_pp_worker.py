"""The gloo ranks of tests/test_torch_pipeline_parallel.py (and of the
pipeline-parallel cases of test_torch_cli.py and test_torch_train.py), on
the CPU with one intra-op thread each, through tests/torch_tp_worker.py's
`launch` and `main` (torch imported once, the ranks forked):

  MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=W \\
      python tests/torch_pp_worker.py MODE DIR [ARGS...]

two (2 ranks) and four (4 ranks) read DIR/inputs.npz (each run's initial
params "p:<run>:<key>" in the reference layout, train_x, train_y, the
index matrix idx, mean, std, the eval images eval_x) and DIR/config.json
({"apply2"/"apply4": {run: spec}, "steps2"/"steps4": {run: spec},
"batch", "lr", "sgd_lr"}; a spec holds the ViTConfig fields, n_micro, the
STREAMING_THRESHOLD to set and, for a step run, the optimizer, steps, k
steps a dispatch and the mutant). An apply run writes
DIR/<run>_rank<r>.npz: the logits of pipeline_parallel.apply_pp on
the eval images at P = 2 (two) or P = 4 (four). A step run writes
DIR/<run>_rank<r>.npz: the logits of the step's forward on the eval
images, the params after the steps gathered in the reference layout
("p:<key>"), the rank's local params ("local:<key>"), the metrics and,
for AdamW, both moments as canonical flat vectors; at data 1 x pipe 2
(two) or data 1 x pipe 2 x model 2 (four). Two mutants of the step, for
the test to show that its bound catches them: "no_hop_cotangent" sends
zeros back along the stage chain in the schedule's backward,
"no_stage_sum" sums the replicated params' gradients over the data axis
only, not over the stages.

four then runs loop.fit on 96 synthetic MNIST images, three steps of 32:
one epoch at data 2 x pipe 2 under DIR/pp, one at data 1 x pipe 2 x
model 2 under DIR/pptp, and DIR/resume/ckpts/mnist_rope-mixed_last.npz (a
one-device `_last.npz` put there by the test) resumed for a second epoch
at data 1 x pipe 2 x model 2; then one train CLI run (ARGS) under DIR/cli;
writes DIR/fit_rank<r>.json with each run's summary.

fit_one / cli (2 ranks, pipeline_parallel 2): one loop.fit, or one train
CLI run (train.main(ARGS)), on 32 synthetic MNIST images under DIR;
writes DIR/<mode>_rank<r>.json with the summary.
"""

import dataclasses
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
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel as pp
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

FIT_KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
              num_heads=4, pos_encoding="rope-mixed",
              attention_impl="reference")


def launch(mode, out, world, *args):
    return tpw.launch(mode, out, world, *args, script=__file__)


def mutate(mutant, mesh):
    """The mesh of a known-wrong step, and the undo of the patch it
    needs."""
    if mutant == "no_stage_sum":
        return dataclasses.replace(mesh, replica_group=mesh.data_group), \
            lambda: None
    if mutant == "no_hop_cotangent":
        real = distributed.stage_hop

        def dropped(chain, send=None, recv_like=None, reverse=False):
            if reverse and send is not None:
                send = torch.zeros_like(send)
            return real(chain, send, recv_like, reverse)

        distributed.stage_hop = dropped
        return mesh, lambda: setattr(distributed, "stage_hop", real)
    return mesh, lambda: None


def initial(arrays, name):
    return {k.split(":", 2)[2]: torch.from_numpy(v)
            for k, v in arrays.items() if k.startswith(f"p:{name}:")}


def run_apply(out, rank, conf, arrays, mesh, suffix):
    threshold = flash_attention.STREAMING_THRESHOLD
    for name, spec in conf[f"apply{suffix}"].items():
        cfg = ViTConfig(**spec["cfg"])
        flash_attention.STREAMING_THRESHOLD = spec.get("threshold", threshold)
        pre = ts.make_preprocess(cfg, arrays["mean"], arrays["std"], 28)
        params = pp.shard_reference(initial(arrays, name), cfg, mesh)
        with torch.no_grad():
            logits = pp.apply_pp(params, pre(torch.from_numpy(
                arrays["eval_x"])), cfg, mesh, spec["n_micro"])
        flash_attention.STREAMING_THRESHOLD = threshold
        np.savez(out / f"{name}_rank{rank}.npz", logits=logits.numpy())


def run_steps(out, rank, conf, arrays, mesh, suffix):
    x = torch.from_numpy(arrays["train_x"])
    y = torch.from_numpy(arrays["train_y"])
    idx = torch.from_numpy(arrays["idx"])
    threshold = flash_attention.STREAMING_THRESHOLD
    for name, spec in conf[f"steps{suffix}"].items():
        cfg = ViTConfig(**spec["cfg"])
        flash_attention.STREAMING_THRESHOLD = spec.get("threshold", threshold)
        run_mesh, undo = mutate(spec.get("mutant"), mesh)
        pre = ts.make_preprocess(cfg, arrays["mean"], arrays["std"], 28)
        init = initial(arrays, name)
        params = pp.shard_reference(init, cfg, mesh)
        forward = ts._mesh_forward(run_mesh, spec["n_micro"])[0]
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
                                                 cfg=cfg, mesh=run_mesh)
            state = opt_init(params)
        k = spec.get("k", 1)
        if k > 1:  # the k-step driver, one call for all the steps
            step = ts.make_train_multi_step(cfg, update, pre, k,
                                            feed="gather", mesh=run_mesh,
                                            n_micro=spec["n_micro"])
            params, state, m = step(params, state, 0, x, y, idx)
            metrics = list(m.numpy())
        else:
            step = ts.make_train_step(cfg, update, pre, mesh=run_mesh,
                                      n_micro=spec["n_micro"])
            metrics = []
            for s in range(spec["steps"]):
                params, state, m = step(params, state, s, x, y, idx)
                metrics.append(m.numpy())
        undo()
        flash_attention.STREAMING_THRESHOLD = threshold
        saved = {f"p:{k}": v.detach().numpy()
                 for k, v in pp.gather_reference(params, cfg, mesh).items()}
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


def load(out):
    conf = json.loads((out / "config.json").read_text())
    with np.load(out / "inputs.npz") as z:
        return conf, {k: z[k] for k in z.files}


def run_two(out: pathlib.Path, rank: int):
    conf, arrays = load(out)
    mesh = make_mesh(batch_size=conf["batch"], pipe_parallel=2)
    run_apply(out, rank, conf, arrays, mesh, "2")
    run_steps(out, rank, conf, arrays, mesh, "2")


def run_four(out: pathlib.Path, rank: int, argv):
    conf, arrays = load(out)
    run_apply(out, rank, conf, arrays, make_mesh(pipe_parallel=4), "4")
    run_steps(out, rank, conf, arrays,
              make_mesh(batch_size=conf["batch"], pipe_parallel=2,
                        model_parallel=2), "4")
    tpw.small_data(96, 32)
    cfg = ViTConfig(**FIT_KW)
    summaries = {}
    for name, t, epochs in (("pp", 1, 1), ("pptp", 2, 1), ("resume", 2, 2)):
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                           synthetic_data=True, seed=0, pipeline_parallel=2,
                           model_parallel=t, resume=epochs > 1,
                           log_dir=str(out / name / "logs"),
                           ckpt_dir=str(out / name / "ckpts"))
        summaries[name] = tpw.summary_of(
            loop.fit(cfg, tcfg, verbose=rank == 0, device="cpu"))
    summaries["cli"] = tpw.summary_of(train_cli.main(argv))
    (out / f"fit_rank{rank}.json").write_text(json.dumps(summaries))


def run_fit_one(out: pathlib.Path, rank: int):
    tpw.small_data(32, 16)
    cfg = ViTConfig(**dict(FIT_KW, embed_dim=32, num_heads=2))
    tcfg = TrainConfig(dataset="mnist", batch_size=16, epochs=1,
                       synthetic_data=True, pipeline_parallel=2,
                       pp_microbatches=4, log_dir=str(out / "logs"),
                       ckpt_dir=str(out / "ckpts"))
    summary = loop.fit(cfg, tcfg, verbose=False, device="cpu")
    (out / f"fit_one_rank{rank}.json").write_text(
        json.dumps(tpw.summary_of(summary)))


def run_rank(mode: str, out: pathlib.Path, rank: int):
    if mode == "cli":  # the CLI joins the group itself
        tpw.run_cli(out, rank, sys.argv[3:])
        return
    if not distributed.initialize(device="cpu"):
        raise RuntimeError("no process group: WORLD_SIZE is not set")
    try:
        if mode == "four":
            run_four(out, distributed.rank(), sys.argv[3:])
        else:
            {"two": run_two, "fit_one": run_fit_one}[mode](
                out, distributed.rank())
    finally:
        distributed.finalize()


if __name__ == "__main__":
    if sys.argv[1] == "four":  # the remat runs' first checkpoint call
        importlib.import_module("torch._dynamo")  # imports it: once
    tpw.main(run_rank)
