"""The gloo ranks of tests/test_torch_context_parallel.py, on the CPU with
one intra-op thread each, through tests/torch_tp_worker.py's `launch` and
`main` (torch imported once, the ranks forked):

  MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=W \\
      python tests/torch_cp_worker.py MODE DIR [ARGS...]

ring (W = R ranks, one ring): reads DIR/ring_<R>.npz (for each case
"<case>:<name>": the whole q, k, v and cotangent g [B, H, N, D], the
bias parameters, and a JSON list of the cases in DIR/ring_<R>.json with
each one's ring ("plain" or "flash"), bias kind, valid token count and
shard length), pads the tokens to R shards and writes
DIR/ring_<R>_rank<r>.npz: the rank's out, dq, dk, dv (its own tokens),
its share of the bias parameters' gradient and, for the kernel ring, lse.

steps (2 ranks, sequence_parallel 2): reads DIR/inputs.npz and
DIR/config.json as torch_tp_worker's steps mode does (runs of the CP
train step: "cfg", "opt" sgd / adamw / zero1, "steps", "mutant", "k"
steps a call of the k-step driver) and
writes DIR/<run>_rank<r>.npz: the logits of the initial params on the
eval images (context_parallel.apply_cp), the params after the steps
("p:<key>"), the metrics and, for AdamW, both moments as canonical flat
vectors. The mutants: "no_seq_sum" sums no gradient over the ring,
"dkdv_stay" leaves the dk / dv accumulators where they were computed
instead of riding the ring home.

bounded (2 ranks): reads DIR/bounded.npz and DIR/bounded.json (runs of
the bounded driver: "cfg", "seq" the ring width (1: data parallelism over
the two ranks), "steps") and writes DIR/bounded_<run>_rank<r>.npz (the
params after the steps, the metrics, one bounded evaluation).

force_ring (1 rank): the bounded step of run cp_relative on a mesh of one
rank with force_ring, and without it (the one-device path), on
DIR/bounded.npz; writes DIR/force_ring.npz.

fit (2 ranks, sequence_parallel 2): loop.fit on 64 synthetic MNIST
images, one epoch under DIR/cp and with --zero1 under DIR/cpz; writes
DIR/fit_rank<r>.json. cli
(2 ranks): one train CLI run (train.main(ARGS)); DIR/cli_rank<r>.json.
"""

import json
import pathlib
import sys

import numpy as np
import torch

import torch_tp_worker as tpw
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa
from vit_rpe_rope_tpu_torch.parallel import context_parallel as cp
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import mesh as tmesh
from vit_rpe_rope_tpu_torch.train import bounded, loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

FIT_KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=32, depth=1,
              num_heads=2, pos_encoding="rope-mixed")


def launch(mode, out, world, *args):
    return tpw.launch(mode, out, world, *args, script=__file__)


def arrays(path):
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def shard(x, nl, r_total, rank, dim):
    """This rank's slice of the tokens of x, padded with zeros to
    nl · r_total along dim."""
    return fa._pad_seq(x, nl * r_total, dim).narrow(dim, rank * nl, nl)


def run_ring(out: pathlib.Path, rank: int):
    world = distributed.world_size()
    ring = tmesh.make_mesh(seq_parallel=world).seq_ring
    inputs = arrays(out / f"ring_{world}.npz")
    saved = {}
    for case in json.loads((out / f"ring_{world}.json").read_text()):
        name, nl, n_valid = case["name"], case["nl"], case["n_valid"]
        q, k, v, g = (shard(inputs[f"{name}:{t}"], nl, world, rank, 2)
                      .requires_grad_(t != "g") for t in "qkvg")
        scale = q.shape[-1] ** -0.5
        kind = case["bias"]
        arg, dense = None, None
        if kind in ("poly", "rel"):
            arg = inputs[f"{name}:bias_arg"].requires_grad_()
        elif kind == "dense":
            full = inputs[f"{name}:bias"]
            pad = nl * world - full.shape[1]
            dense = torch.nn.functional.pad(full, (0, pad, 0, pad))[
                :, rank * nl:(rank + 1) * nl].requires_grad_()
        ring_kind = {"poly": "poly", "rel": "rel"}.get(kind)
        grid = case.get("grid", 0)
        if case["ring"] == "flash":
            o = cp.ring_flash_attention(q, k, v, scale, ring, n_valid,
                                        ring_kind, arg, grid,
                                        mm_dtype=torch.float32)
            with torch.no_grad():
                _, lse = cp.ring_flash_fwd(
                    q, k, v, scale, ring, n_valid,
                    cp._generated(ring_kind, arg, grid), torch.float32)
            saved[f"{name}:lse"] = lse.numpy()
        else:
            o = cp.ring_attention(q, k, v, scale, ring, bias=dense,
                                  n_valid=n_valid, bias_kind=ring_kind,
                                  bias_arg=arg, bias_grid=grid)
        leaves = [q, k, v] + [t for t in (arg, dense) if t is not None]
        grads = torch.autograd.grad(o, leaves, g)
        saved.update({f"{name}:out": o.detach().numpy(),
                      **{f"{name}:d{t}": x.numpy()
                         for t, x in zip("qkv", grads)}})
        if arg is not None:
            saved[f"{name}:dparam"] = grads[3].numpy()
        if dense is not None:
            saved[f"{name}:dbias"] = grads[3].numpy()
    np.savez(out / f"ring_{world}_rank{rank}.npz", **saved)


def mutate(mutant):
    """Patch the CP step into a known-wrong version; returns the undo."""
    if mutant == "no_seq_sum":
        real = tmesh.Mesh.sum_over_data
        tmesh.Mesh.sum_over_data = lambda self, tensor: tensor
        return lambda: setattr(tmesh.Mesh, "sum_over_data", real)
    if mutant == "dkdv_stay":
        real_bwd, real_shift = cp.ring_flash_bwd, distributed.ring_shift

        def stay(ring, tensors, reverse=False):
            tensors = list(tensors)
            if len(tensors) == 4:  # k, v move on; dk, dv stay
                return real_shift(ring, tensors[:2], reverse) + tensors[2:]
            return tensors  # the accumulators' last hop

        def bwd(*args, **kw):
            distributed.ring_shift = stay
            try:
                return real_bwd(*args, **kw)
            finally:
                distributed.ring_shift = real_shift

        cp.ring_flash_bwd = bwd
        return lambda: setattr(cp, "ring_flash_bwd", real_bwd)
    return lambda: None


def run_steps(out: pathlib.Path, rank: int):
    conf = json.loads((out / "config.json").read_text())
    z = arrays(out / "inputs.npz")
    x, y, idx = z["train_x"], z["train_y"], z["idx"]
    mesh = tmesh.make_mesh(batch_size=conf["batch"], seq_parallel=2)
    for name, spec in conf["runs"].items():
        cfg = ViTConfig(**spec["cfg"])
        undo = mutate(spec.get("mutant"))
        pre = ts.make_preprocess(cfg, z["mean"].numpy(), z["std"].numpy(), 28)
        params = {k.split(":", 2)[2]: v.clone() for k, v in z.items()
                  if k.startswith(f"p:{name}:")}
        with torch.no_grad():
            logits = cp.apply_cp(params, pre(z["eval_x"]), cfg, mesh)
        for v in params.values():
            v.requires_grad_(True)
        if spec["opt"] == "sgd":
            update, state = tpw.sgd(conf["sgd_lr"]), None
        else:
            tcfg = TrainConfig(dataset="mnist", batch_size=conf["batch"],
                               epochs=2, lr=conf["lr"],
                               zero1=spec["opt"] == "zero1")
            opt_init, update = ts.make_optimizer(
                tcfg, max(spec["steps"], 1), params, cfg=cfg, mesh=mesh)
            state = opt_init(params)
        metrics = [np.zeros(3, np.float32)]
        if spec.get("k", 1) > 1:  # the k-step driver, one call
            step = ts.make_train_multi_step(cfg, update, pre, spec["k"],
                                            feed="gather", mesh=mesh)
            params, state, m = step(params, state, 0, x, y, idx)
            metrics += list(m.numpy())
        else:
            step = ts.make_train_step(cfg, update, pre, mesh=mesh)
            for s in range(spec["steps"]):
                params, state, m = step(params, state, s, x, y, idx)
                metrics.append(m.numpy())
        undo()
        saved = {f"p:{k}": v.detach().numpy() for k, v in params.items()}
        saved.update(metrics=np.stack(metrics[1:] or metrics),
                     logits=logits.numpy())
        if spec["opt"] != "sgd":
            flat = loop.moment_flattener(params, cfg)
            leaves = loop.mesh_opt_to_disk(state, flat, cfg, mesh, params,
                                           spec["opt"] == "zero1")
            saved.update(count=leaves[0], mu=leaves[1].numpy(),
                         nu=leaves[2].numpy())
        np.savez(out / f"{name}_rank{rank}.npz", **saved)


def bounded_run(cfg, z, steps, mesh=None, seq=1, force_ring=False):
    """The bounded driver's steps on the whole batch of `z` with float32
    products and the fused AdamW: (params, metrics, evaluation)."""
    params = {k[2:]: v.clone().requires_grad_()
              for k, v in z.items() if k.startswith("p:")}
    pre = ts.make_preprocess(cfg, z["mean"].numpy(), z["std"].numpy(),
                             cfg.img_size)
    tcfg = TrainConfig(dataset="cifar10", batch_size=len(z["labels"]),
                       epochs=2)
    init, update = ts.make_optimizer(tcfg, 2, params)
    step = bounded.make_bounded_step(
        cfg, tcfg, update, pre, q_chunk=512, mm_dtype=torch.float32,
        mesh=mesh, seq_parallel=seq, force_ring=force_ring)
    state = init(params)
    metrics = []
    for s in range(steps):
        params, state, m = step(params, state, s, z["images"], z["labels"],
                                z["mask"])
        metrics.append(m.numpy())
    evaluation = step.evaluate(params, 0, z["images"], z["labels"],
                               z["mask"]).numpy()
    return ({k: v.detach().numpy() for k, v in params.items()},
            np.stack(metrics), evaluation)


def run_bounded(out: pathlib.Path, rank: int):
    conf = json.loads((out / "bounded.json").read_text())
    z = arrays(out / "bounded.npz")
    meshes = {seq: tmesh.make_mesh(batch_size=len(z["labels"]),
                                   seq_parallel=seq) for seq in (1, 2)}
    for name, spec in conf.items():
        cfg = ViTConfig(**spec["cfg"])
        sub = {k.split(":", 1)[1]: v for k, v in z.items()
               if k.startswith(f"{name}:")}
        params, metrics, evaluation = bounded_run(
            cfg, {**z, **sub}, spec["steps"], meshes[spec["seq"]],
            spec["seq"])
        np.savez(out / f"bounded_{name}_rank{rank}.npz", metrics=metrics,
                 evaluation=evaluation,
                 **{f"p:{k}": v for k, v in params.items()})


def run_force_ring(out: pathlib.Path, rank: int):
    conf = json.loads((out / "bounded.json").read_text())
    z = arrays(out / "bounded.npz")
    mesh = tmesh.make_mesh()
    saved = {}
    for name, spec in conf.items():
        if name != "cp_relative":
            continue
        cfg = ViTConfig(**spec["cfg"])
        sub = {k.split(":", 1)[1]: v for k, v in z.items()
               if k.startswith(f"{name}:")}
        for label, kw in (("ring", dict(mesh=mesh, force_ring=True)),
                          ("plain", dict(mesh=mesh))):
            params, metrics, evaluation = bounded_run(
                cfg, {**z, **sub}, spec["steps"], **kw)
            saved.update({f"{name}:{label}:metrics": metrics,
                          f"{name}:{label}:evaluation": evaluation,
                          **{f"{name}:{label}:p:{k}": v
                             for k, v in params.items()}})
    np.savez(out / "force_ring.npz", **saved)


def run_fit(out: pathlib.Path, rank: int):
    tpw.small_data(64, 32)
    cfg = ViTConfig(**FIT_KW)
    summaries = {}
    for name, extra in (("cp", {}), ("cpz", dict(zero1=True))):
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=1,
                           synthetic_data=True, seed=0, sequence_parallel=2,
                           log_dir=str(out / name / "logs"),
                           ckpt_dir=str(out / name / "ckpts"), **extra)
        summaries[name] = tpw.summary_of(loop.fit(cfg, tcfg, verbose=False,
                                                  device="cpu"))
    (out / f"fit_rank{rank}.json").write_text(json.dumps(summaries))


def run_cli(out: pathlib.Path, rank: int, argv):
    tpw.small_data(32, 16)
    summary = train_cli.main(argv)
    (out / f"cli_rank{rank}.json").write_text(
        json.dumps(tpw.summary_of(summary)))


def run_rank(mode: str, out: pathlib.Path, rank: int):
    if mode == "cli":  # the CLI joins the group itself
        run_cli(out, rank, sys.argv[3:])
        return
    if not distributed.initialize(device="cpu"):
        raise RuntimeError("no process group: WORLD_SIZE is not set")
    try:
        {"ring": run_ring, "steps": run_steps, "bounded": run_bounded,
         "force_ring": run_force_ring, "fit": run_fit}[mode](
            out, distributed.rank())
    finally:
        distributed.finalize()


if __name__ == "__main__":
    tpw.main(run_rank)
