"""One rank of the two-rank gloo runs of tests/test_torch_data_parallel.py,
on the CPU with one intra-op thread:

  MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=2 RANK=r LOCAL_RANK=r \\
      python tests/torch_dp_worker.py {steps,fit} DIR

steps: reads DIR/inputs.npz (params "p:<key>", train_x, train_y, the index
matrix idx) and DIR/config.json (the ViTConfig fields, lr, batch, epochs,
steps), runs 3 train steps of each run in RUNS through
train_step.make_train_step over the process group's mesh, and writes
DIR/<run>_rank<r>.npz: the params, the metrics and, for AdamW, both moments
as canonical flat vectors (ZeRO-1's slices gathered). Two runs are mutants
of the data-parallel step, for the test to show that its bound catches
them: "local_count" divides by this rank's real examples instead of the
global count, "no_all_reduce" skips the gradient sum over the ranks.

fit: four loop.fit runs on 96 synthetic MNIST images (three steps of 32),
under DIR/{zero1,dp}: one epoch with and without --zero1, then each
resumed for a second epoch from its own `_last.npz` with --zero1 toggled
(rank 0 copies each `_last.npz` to last_epoch<e>.npz beside it); writes
DIR/fit_rank<r>.json with each run's summary.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

# name: (optimizer, grad_accum, mutant)
RUNS = {"dp_sgd": ("sgd", 1, None), "dp_sgd_accum2": ("sgd", 2, None),
        "dp_adamw": ("adamw", 1, None), "zero1": ("zero1", 1, None),
        "mutant_local_count": ("sgd", 1, "local_count"),
        "mutant_no_all_reduce": ("sgd", 1, "no_all_reduce")}


def sgd(lr):
    def update(grads, state, params):
        with torch.no_grad():
            for key in params:
                params[key].sub_(lr * grads[key])
        return params, state

    return update


def mutate(mutant, mesh):
    """Patch the data-parallel step into a known-wrong version."""
    if mutant == "local_count":
        real_count = ts._real_count
        ts._real_count = lambda rows: real_count(
            rows[..., ts._columns(mesh, rows.shape[-1])])
    elif mutant == "no_all_reduce":
        distributed.all_reduce_sum = lambda tensor: tensor


def run_steps(out: pathlib.Path, rank: int):
    conf = json.loads((out / "config.json").read_text())
    cfg = ViTConfig(**conf["cfg"])
    with np.load(out / "inputs.npz") as z:
        init = {k[2:]: torch.from_numpy(z[k]) for k in z.files
                if k.startswith("p:")}
        x, y = torch.from_numpy(z["train_x"]), torch.from_numpy(z["train_y"])
        idx = torch.from_numpy(z["idx"])
        mean, std = z["mean"], z["std"]
    pre = ts.make_preprocess(cfg, mean, std, x.shape[1])
    mesh = make_mesh(batch_size=conf["batch"])
    real = (ts._real_count, distributed.all_reduce_sum)
    for name, (opt, accum, mutant) in RUNS.items():
        mutate(mutant, mesh)
        params = {k: v.clone().requires_grad_() for k, v in init.items()}
        if opt == "sgd":
            update, state = sgd(conf["sgd_lr"]), None
        else:
            tcfg = TrainConfig(dataset="mnist", batch_size=conf["batch"],
                               epochs=conf["epochs"], lr=conf["lr"],
                               zero1=opt == "zero1")
            opt_init, update = ts.make_optimizer(
                tcfg, conf["steps"], params, cfg=cfg, mesh=mesh)
            state = opt_init(params)
        step = ts.make_train_step(cfg, update, pre, accum=accum, mesh=mesh)
        metrics = []
        for s in range(conf["steps"]):
            params, state, m = step(params, state, s * accum, x, y, idx)
            metrics.append(m.numpy())
        ts._real_count, distributed.all_reduce_sum = real
        saved = {f"p:{k}": v.detach().numpy() for k, v in params.items()}
        saved["metrics"] = np.stack(metrics)
        if opt != "sgd":
            flat = loop.moment_flattener(params, cfg)
            leaves = (loop.zero1_opt_to_disk(state, flat, mesh)
                      if opt == "zero1" else
                      loop.opt_to_disk(state, flat, cfg))
            saved.update(count=leaves[0], mu=leaves[1].numpy(),
                         nu=leaves[2].numpy())
        np.savez(out / f"{name}_rank{rank}.npz", **saved)


def run_fit(out: pathlib.Path, rank: int):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=96, n_test=32, seed=seed)

    datasets.get_dataset = get_dataset
    cfg = ViTConfig(img_size=16, patch_size=4, in_chans=1, embed_dim=32,
                    depth=2, num_heads=2, pos_encoding="rope-axial",
                    attention_impl="reference")
    summaries = {}
    for name, zero1, epochs in (("zero1", True, 1), ("dp", False, 1),
                                ("zero1", False, 2), ("dp", True, 2)):
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                           synthetic_data=True, seed=0, zero1=zero1,
                           resume=epochs > 1,
                           log_dir=str(out / name / f"logs{epochs}"),
                           ckpt_dir=str(out / name / "ckpts"))
        summary = loop.fit(cfg, tcfg, verbose=rank == 0, device="cpu")
        last = out / name / "ckpts" / "mnist_rope-axial_last.npz"
        if rank == 0:
            shutil.copy(last, last.with_name(f"last_epoch{epochs}.npz"))
        summaries[f"{name}_{epochs}"] = {
            k: summary[k] for k in ("log_file", "ckpt_path", "num_devices",
                                    "history", "best_acc")}
    (out / f"fit_rank{rank}.json").write_text(json.dumps(summaries))


def main():
    torch.set_num_threads(1)
    mode, out = sys.argv[1], pathlib.Path(sys.argv[2])
    assert distributed.initialize(device="cpu")
    try:
        {"steps": run_steps, "fit": run_fit}[mode](out, distributed.rank())
    finally:
        distributed.finalize()


if __name__ == "__main__":
    main()
