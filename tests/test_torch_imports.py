"""PyTorch port, import hygiene and device policy: the port imports neither
jax nor the JAX package, and its entry points refuse to run on the CPU
unless asked to."""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "vit_rpe_rope_tpu_torch"
# The JAX package's name is a prefix of the port's: match it only where it
# is not followed by "_torch".
JAX_PACKAGE = re.compile(r"\bvit_rpe_rope_tpu\b(?!_torch)")
IMPORTS = re.compile(
    r"(?:^\s*(?:import|from)\s+|import_module\(\s*[\"'])([\w.]+)",
    re.MULTILINE)


def port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))


def test_port_modules_import_without_jax():
    modules = port_modules()
    for name in ("ops.flash_attention", "ops.fused_adamw", "ops.cuda_build",
                 "train.loop", "train.train_step", "cli.train",
                 "data.datasets", "utils.flatten", "utils.checkpoint",
                 "viz.similarity", "viz.rope_freq",
                 "cli.pe_similarity_visualizer", "cli.rope_visualizer",
                 "utils.native", "utils.nan_check", "ops.launches",
                 "quant", "serving", "utils.convert", "parallel.mesh",
                 "parallel.distributed", "parallel.tensor_parallel",
                 "parallel.context_parallel", "parallel.pipeline_parallel",
                 "parallel.pp_tp", "parallel.tp_cp", "parallel.pp_tp_cp",
                 "utils.trajectory_parity"):
        assert f"vit_rpe_rope_tpu_torch.{name}" in modules
    code = (
        "import importlib, re, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or re.match(r'vit_rpe_rope_tpu(\\.|$)', m)]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_port_sources_name_no_jax():
    sources = (list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
               + sorted((ROOT / "tests").glob("torch_*_worker.py"))
               + sorted((ROOT / "scripts").glob("torch_*.py")))
    for path in sources:
        for name in IMPORTS.findall(path.read_text()):
            assert name.split(".")[0] != "jax", (path, name)
            assert not JAX_PACKAGE.match(name), (path, name)


def test_prefix_safe_pattern():
    found = IMPORTS.findall(
        "from vit_rpe_rope_tpu.models import vit\n"
        "import vit_rpe_rope_tpu\n"
        "    from vit_rpe_rope_tpu_torch import serving\n"
        "importlib.import_module('jax.numpy')\n")
    assert found == ["vit_rpe_rope_tpu.models", "vit_rpe_rope_tpu",
                     "vit_rpe_rope_tpu_torch", "jax.numpy"]
    assert [bool(JAX_PACKAGE.match(n)) for n in found] == [True, True, False,
                                                           False]


def test_entry_points_refuse_cpu_without_request(monkeypatch, tmp_path):
    from vit_rpe_rope_tpu_torch import serving
    from vit_rpe_rope_tpu_torch.cli import predict, train
    from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
    from vit_rpe_rope_tpu_torch.models import vit
    from vit_rpe_rope_tpu_torch.train import loop
    from vit_rpe_rope_tpu_torch.utils import checkpoint
    from vit_rpe_rope_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=1,
                    num_heads=2, pos_encoding="none")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vit.init_params(torch.Generator(), cfg)
    params = vit.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.Predictor.from_params(params, cfg, 0.5, 0.5, 32)
    ckpt = checkpoint.save(str(tmp_path / "m.npz"), params)
    inputs = str(tmp_path / "x.npz")
    np.savez(inputs, images=np.zeros((2, 32, 32, 3), np.uint8))
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict.main([ckpt, "--input", inputs, "--grid_size", "4",
                      "--num_heads", "2"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--synthetic", "--log_dir", str(tmp_path / "logs"),
                    "--ckpt_dir", str(tmp_path / "ckpts")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.fit(cfg, TrainConfig(dataset="cifar10", synthetic_data=True,
                                  log_dir=str(tmp_path / "logs"),
                                  ckpt_dir=str(tmp_path / "ckpts")))
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_sources_build_into_their_own_libraries():
    """Each CUDA source has its own library, keyed by its text and the
    shared header's (no nvcc here: only the names are checked)."""
    from vit_rpe_rope_tpu_torch.ops import cuda_build, flash_attention
    from vit_rpe_rope_tpu_torch.ops import fused_adamw

    sources = (flash_attention.SOURCE, flash_attention.BWD_SOURCE,
               fused_adamw.SOURCE)
    paths = [cuda_build.library_path(s) for s in sources]
    assert [p.name.split("-")[0] for p in paths] == ["attn_fwd", "attn_bwd",
                                                     "adamw"]
    assert all(p.parent == cuda_build.BUILD_DIR for p in paths)
    assert all(s.exists() for s in sources)


def test_ptxas_report_reads_registers_and_spills_per_entry():
    """The -Xptxas -v report kept beside each library, read entry by entry
    (what chip_smoke.py prints in its first phase)."""
    from vit_rpe_rope_tpu_torch.ops import cuda_build

    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1aILi32EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1aILi32EEvv
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 37 registers
"""
    assert cuda_build.ptxas_report(text) == [("_Z1aILi32EEvv", 128, 8),
                                             ("_Z1bv", 37, 0)]
    assert cuda_build.ptxas_report("") == []
