"""The gloo ranks of tests/test_torch_tensor_parallel.py (and of the
tensor-parallel cases of test_torch_cli.py and test_torch_train.py), on the
CPU with one intra-op thread each:

  MASTER_ADDR=127.0.0.1 MASTER_PORT=... WORLD_SIZE=W \\
      python tests/torch_tp_worker.py MODE DIR [ARGS...]

The process imports torch and the port once, then forks the W ranks (each
with torchrun's RANK and LOCAL_RANK) and waits for them: W interpreters
that each import torch would cost W times the start-up. A rank that fails
makes the others be killed and the process exit with 1; a rank dies with
the process.

steps (2 ranks, model_parallel 2): reads DIR/inputs.npz (each run's initial
params "p:<run>:<key>", train_x, train_y, the index matrix idx, mean, std,
the eval images) and DIR/config.json ({"runs": {run: spec}, "batch",
"lr", "sgd_lr"}; a spec holds the ViTConfig fields, the optimizer, steps,
accum, k steps a dispatch, the mutant and the STREAMING_THRESHOLD to
set), and for each run
writes DIR/<run>_rank<r>.npz: the logits of the initial params on the
eval images, the params after the steps gathered in the reference layout
("p:<key>"), the rank's local params ("local:<key>"), the metrics and,
for AdamW, both moments as canonical flat vectors. Two runs are mutants
of the tensor-parallel step, for the test to show that its bound catches
them: "no_model_sync" skips the per-head PE params' gradient sum over the
model axis, "no_f_bwd" skips the all-reduce in Megatron f's backward.

fit (4 ranks, data 2 x model 2): loop.fit on 96 synthetic MNIST images,
three steps of 32: one epoch with and without --zero1 under DIR/{tp,
tpz}, and DIR/resume/ckpts/mnist_rope-mixed_last.npz (a one-device
`_last.npz` put there by the test) resumed for a second epoch with
--zero1; writes DIR/fit_rank<r>.json with each run's summary.

fit_one / cli (2 ranks, model_parallel 2): one loop.fit, or one train CLI
run (train.main(ARGS)), on 32 synthetic MNIST images under DIR; writes
DIR/<mode>_rank<r>.json with the summary.

The tests start the ranks with `launch` (import this module from tests/).
tests/torch_cp_worker.py runs its own modes through the same `launch` and
`main` (script= and run_rank=).
"""

import contextlib
import ctypes
import importlib
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.ops import flash_attention
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel as tp
from vit_rpe_rope_tpu_torch.parallel.mesh import make_mesh
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 240  # seconds for one launch

FIT_KW = dict(img_size=16, patch_size=4, in_chans=1, embed_dim=64, depth=2,
              num_heads=4, pos_encoding="rope-mixed",
              attention_impl="reference")


def free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(mode: str, out: pathlib.Path, world: int, *args,
           script: str = __file__) -> str:
    """Run `world` ranks of this worker (or of `script`, a worker that
    calls this module's main) (torchrun's environment on a free localhost
    port, one intra-op thread each) in `out`; raise with their output if
    one fails or the launch outlasts LAUNCH_TIMEOUT. Returns the ranks'
    output."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, script, mode, str(out), *args], cwd=out, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log = proc.communicate(timeout=LAUNCH_TIMEOUT)[0]
    finally:
        proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f"the ranks of {mode} failed:\n{log}")
    return log


def sgd(lr):
    def update(grads, state, params):
        with torch.no_grad():
            for key in params:
                params[key].sub_(lr * grads[key])
        return params, state

    return update


def mutate(mutant):
    """Patch the tensor-parallel step into a known-wrong version; returns
    the undo."""
    if mutant == "no_model_sync":
        real = tp.model_sync_keys
        tp.model_sync_keys = lambda params, cfg: []
        return lambda: setattr(tp, "model_sync_keys", real)
    if mutant == "no_f_bwd":
        f = distributed._IdentityFwdSumBwd
        real = f.backward
        f.backward = staticmethod(lambda ctx, g: (g, None))
        return lambda: setattr(f, "backward", staticmethod(real))
    return lambda: None


def run_steps(out: pathlib.Path, rank: int):
    conf = json.loads((out / "config.json").read_text())
    with np.load(out / "inputs.npz") as z:
        arrays = {k: z[k] for k in z.files}
    x = torch.from_numpy(arrays["train_x"])
    y = torch.from_numpy(arrays["train_y"])
    idx = torch.from_numpy(arrays["idx"])
    threshold = flash_attention.STREAMING_THRESHOLD
    mesh = make_mesh(batch_size=conf["batch"], model_parallel=2)
    for name, spec in conf["runs"].items():
        cfg = ViTConfig(**spec["cfg"])
        flash_attention.STREAMING_THRESHOLD = spec.get("threshold",
                                                       threshold)
        undo = mutate(spec.get("mutant"))
        pre = ts.make_preprocess(cfg, arrays["mean"], arrays["std"], 28)
        init = {k.split(":", 2)[2]: torch.from_numpy(v)
                for k, v in arrays.items() if k.startswith(f"p:{name}:")}
        params = tp.shard_reference(init, cfg, mesh)
        with torch.no_grad():
            logits = tp.apply_tp(params, pre(torch.from_numpy(
                arrays["eval_x"])), cfg, mesh)
        for v in params.values():
            v.requires_grad_(True)
        if spec["opt"] == "sgd":
            update, state = sgd(conf["sgd_lr"]), None
        else:
            tcfg = TrainConfig(dataset="mnist", batch_size=conf["batch"],
                               epochs=2, lr=conf["lr"],
                               zero1=spec["opt"] == "zero1")
            opt_init, update = ts.make_optimizer(
                tcfg, spec["steps"], params, cfg=cfg, mesh=mesh)
            state = opt_init(params)
        accum, k = spec.get("accum", 1), spec.get("k", 1)
        if k > 1:  # the k-step driver, one call for all the steps
            step = ts.make_train_multi_step(cfg, update, pre, k, accum=accum,
                                            feed="gather", mesh=mesh)
            params, state, m = step(params, state, 0, x, y, idx)
            metrics = list(m.numpy())
        else:
            step = ts.make_train_step(cfg, update, pre, accum=accum,
                                      mesh=mesh)
            metrics = []
            for s in range(spec["steps"]):
                params, state, m = step(params, state, s * accum, x, y, idx)
                metrics.append(m.numpy())
        undo()
        flash_attention.STREAMING_THRESHOLD = threshold
        saved = {f"p:{k}": v.detach().numpy()
                 for k, v in tp.gather_reference(params, cfg, mesh).items()}
        saved.update({f"local:{k}": v.detach().numpy()
                      for k, v in params.items()})
        saved.update(metrics=np.stack(metrics), logits=logits.numpy())
        if spec["opt"] != "sgd":
            flat = loop.moment_flattener(init, cfg)
            leaves = loop.mesh_opt_to_disk(state, flat, cfg, mesh, params,
                                         spec["opt"] == "zero1")
            saved.update(count=leaves[0], mu=leaves[1].numpy(),
                         nu=leaves[2].numpy())
        np.savez(out / f"{name}_rank{rank}.npz", **saved)


def small_data(n_train: int, n_test: int):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        return datasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                                  seed=seed)

    datasets.get_dataset = get_dataset


def summary_of(summary: dict) -> dict:
    return {k: summary[k] for k in ("log_file", "ckpt_path", "num_devices",
                                    "history", "best_acc", "num_params")}


def run_fit(out: pathlib.Path, rank: int):
    small_data(96, 32)
    cfg = ViTConfig(**FIT_KW)
    summaries = {}
    for name, zero1, epochs in (("tp", False, 1), ("tpz", True, 1),
                                ("resume", True, 2)):
        tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=epochs,
                           synthetic_data=True, seed=0, zero1=zero1,
                           model_parallel=2, resume=epochs > 1,
                           log_dir=str(out / name / "logs"),
                           ckpt_dir=str(out / name / "ckpts"))
        summary = loop.fit(cfg, tcfg, verbose=rank == 0, device="cpu")
        summaries[name] = summary_of(summary)
    (out / f"fit_rank{rank}.json").write_text(json.dumps(summaries))


def run_fit_one(out: pathlib.Path, rank: int):
    small_data(32, 16)
    cfg = ViTConfig(**dict(FIT_KW, embed_dim=32, depth=1))
    tcfg = TrainConfig(dataset="mnist", batch_size=16, epochs=1,
                       synthetic_data=True, model_parallel=2,
                       log_dir=str(out / "logs"), ckpt_dir=str(out / "ckpts"))
    summary = loop.fit(cfg, tcfg, verbose=False, device="cpu")
    (out / f"fit_one_rank{rank}.json").write_text(
        json.dumps(summary_of(summary)))


def run_cli(out: pathlib.Path, rank: int, argv):
    small_data(32, 16)
    summary = train_cli.main(argv)
    (out / f"cli_rank{rank}.json").write_text(json.dumps(summary_of(summary)))


def run_rank(mode: str, out: pathlib.Path, rank: int):
    if mode == "cli":  # the CLI joins the group itself
        run_cli(out, rank, sys.argv[3:])
        return
    if not distributed.initialize(device="cpu"):
        raise RuntimeError("no process group: WORLD_SIZE is not set")
    try:
        {"steps": run_steps, "fit": run_fit,
         "fit_one": run_fit_one}[mode](out, distributed.rank())
    finally:
        distributed.finalize()


def main(run_rank=run_rank):
    """Fork the WORLD_SIZE ranks, each running run_rank(mode, out, rank),
    and wait for them."""
    torch.set_num_threads(1)
    mode, out = sys.argv[1], pathlib.Path(sys.argv[2])
    if mode == "steps":  # the remat runs' first checkpoint call imports
        importlib.import_module("torch._dynamo")  # it: once, not per rank
    supervisor = os.getpid()
    ranks = {}
    for rank in range(int(os.environ["WORLD_SIZE"])):
        pid = os.fork()
        if pid:
            ranks[pid] = rank
            continue
        # the rank: killed if the supervising process dies (PR_SET_PDEATHSIG)
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)
        if os.getppid() != supervisor:
            os._exit(1)
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank))
        code = 0
        try:
            run_rank(mode, out, rank)
        except BaseException:
            traceback.print_exc()
            code = 1
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    failed = []
    while ranks:
        pid, status = os.wait()
        rank = ranks.pop(pid)
        if status:
            failed.append(rank)
            for other in ranks:
                os.kill(other, signal.SIGKILL)
    if failed:
        print(f"rank(s) {failed} failed", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
