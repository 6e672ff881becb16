"""One epoch each of the long-sequence model (patch 4, embed 128, depth 2, 4
heads, 256 px: N=4,097, batch 4) in rope-axial through the PyTorch port's
train CLI on synthetic CIFAR-10, with and without bounded-program stepping
(--q_chunk 2048), at several seeds and learning rates: how steadily the
task trains on the card at the CLI's default learning rate and at half of
it. Needs a CUDA device; imports no JAX.

    python3 scripts/torch_bounded_epochs.py [--out results.json]

Prints one line per run (seconds, the epoch's train/test loss and accuracy)
and writes all of them as JSON to --out (default
logs/torch_bounded_epochs.json).
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vit_rpe_rope_tpu_torch.cli import train as train_cli  # noqa: E402

MODEL = ["--img_size", "256", "--patch_size", "4", "--embed_dim", "128",
         "--depth", "2", "--num_heads", "4", "--batch_size", "4"]
RUNS = (("bounded seed1", ["--q_chunk", "2048", "--seed", "1"]),
        ("bounded seed2", ["--q_chunk", "2048", "--seed", "2"]),
        ("bounded seed0 lr5e-4", ["--q_chunk", "2048", "--lr", "5e-4"]),
        ("monolithic seed0 lr5e-4", ["--lr", "5e-4"]),
        ("monolithic seed1", ["--seed", "1"]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out",
                        default="logs/torch_bounded_epochs.json")
    args = parser.parse_args(argv)
    out = os.path.abspath(args.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    results = {}
    for label, extra in RUNS:
        argv = ["--dataset", "cifar10", "--synthetic", "--epochs", "1",
                "--pos_encoding", "rope-axial"] + MODEL + extra
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)  # logs/ and checkpoints/ land in the scratch dir
            try:
                t0 = time.perf_counter()
                summary = train_cli.main(argv)
                seconds = time.perf_counter() - t0
            finally:
                os.chdir(cwd)
        results[label] = dict(seconds=seconds, **summary["history"][0])
        print("RESULT", label, json.dumps(results[label]), flush=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
