"""PyTorch port, --debug_nans (utils/nan_check.py) and --profile_dir
(train/loop.py) on the CPU.

* The sanitizer raises FloatingPointError at the first NaN, naming the op,
  in the forward, in the backward and in the optimizer; a run poisoned
  with a normalisation std of 0 raises in the port's fit as in the JAX
  package's (whose jax_debug_nans is switched off again afterwards: JAX
  fit leaves it on). (A NaN learning rate does not serve for the JAX
  side: its de-optimized rerun of the sharded step ends in a
  RecursionError after about two minutes on the CPU.)
* A clean run under the sanitizer writes the CSV row of a run without it,
  and the sanitizer is off again when fit returns or raises.
* --profile_dir writes a Chrome trace (*.pt.trace.json) that names the
  train step's ops, from fit and from the train CLI.
"""

import csv
import glob
import json

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu.train import loop as jloop
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.utils import nan_check


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and the
    workers of a parallel test run do not compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


KW = dict(img_size=28, patch_size=7, in_chans=1, embed_dim=32, depth=2,
          num_heads=2, pos_encoding="rope-mixed")


@pytest.fixture
def small_data(monkeypatch):
    """64 training and 16 test examples in both packages (byte-identical
    procedural data)."""
    torch_synthetic, jax_synthetic = datasets.synthetic, jdatasets.synthetic
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: torch_synthetic(
            dataset, n_train=64, n_test=16, seed=seed))
    monkeypatch.setattr(
        jdatasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: jax_synthetic(
            dataset, n_train=64, n_test=16, seed=seed))


def sanitizer_off():
    return (not nan_check.ACTIVE and not torch.is_anomaly_enabled()
            and _get_current_dispatch_mode() is None)


def test_forward_nan_raises_naming_the_op():
    x = torch.ones(3, requires_grad=True)
    with pytest.raises(FloatingPointError, match="aten.log"):
        with nan_check.debug_nans():
            torch.log(-x)
    assert sanitizer_off()


def test_backward_nan_raises_naming_the_op():
    """sqrt(x - x) is 0 in the forward; its backward adds +inf and -inf."""
    x = torch.ones(3, requires_grad=True)
    with nan_check.debug_nans():
        y = torch.sqrt(x - x).sum()
        assert float(y) == 0.0
        with pytest.raises(FloatingPointError, match="aten.add"):
            torch.autograd.grad(y, x)
    assert sanitizer_off()


def test_model_forward_nan_raises():
    cfg = ViTConfig(**KW)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    params["blocks.1.mlp.fc1.weight"][3, 5] = float("nan")
    x = torch.rand(2, 28, 28, 1)
    assert torch.isnan(vit.apply(params, x, cfg)).all()  # not sanitized
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        with nan_check.debug_nans():
            vit.apply(params, x, cfg)


def test_uninitialised_allocations_are_not_checked():
    """torch.empty and its kin may hold NaN bit patterns: never checked. A
    kernel's output is checked by its wrapper (nan_check.check), only while
    the sanitizer is on."""
    poisoned = torch.full((4,), float("nan"))
    with nan_check.debug_nans():
        torch.empty(4096)
        torch.empty_like(poisoned)
        torch.empty_strided((4, 4), (1, 4))
        with pytest.raises(FloatingPointError, match="kernel_x"):
            nan_check.check("kernel_x", torch.zeros(2), None, poisoned)
    nan_check.check("kernel_x", poisoned)  # off: a no-op


def cfgs(**tkw):
    common = dict(dataset="mnist", batch_size=32, epochs=1,
                  synthetic_data=True)
    common.update(tkw)
    return common


@pytest.fixture
def poisoned_data(monkeypatch):
    """small_data with a normalisation std of 0: the pre-processed images
    are infinite, and the patch embedding's first product makes NaNs."""
    torch_synthetic, jax_synthetic = datasets.synthetic, jdatasets.synthetic

    def poisoned(synthetic):
        def get_dataset(dataset, data_dir, use_synthetic, seed):
            bundle = synthetic(dataset, n_train=64, n_test=16, seed=seed)
            bundle.std = np.zeros_like(bundle.std)
            return bundle
        return get_dataset

    monkeypatch.setattr(datasets, "get_dataset", poisoned(torch_synthetic))
    monkeypatch.setattr(jdatasets, "get_dataset", poisoned(jax_synthetic))


def test_poisoned_fit_raises_in_both_packages(tmp_path, poisoned_data):
    with pytest.raises(FloatingPointError, match="NaN in the output of aten"):
        loop.fit(ViTConfig(**KW), TrainConfig(
            debug_nans=True, log_dir=str(tmp_path / "t"),
            ckpt_dir=str(tmp_path / "t"), **cfgs()), verbose=False,
            device="cpu")
    assert sanitizer_off()
    try:
        with pytest.raises(FloatingPointError):
            jloop.fit(JaxViTConfig(**KW), JaxTrainConfig(
                debug_nans=True, log_dir=str(tmp_path / "j"),
                ckpt_dir=str(tmp_path / "j"), **cfgs()), verbose=False)
    finally:
        jax.config.update("jax_debug_nans", False)


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_nan_in_the_optimizer_raises(tmp_path, small_data,
                                     steps_per_dispatch):
    """A NaN learning rate: the forward and backward are clean, the AdamW
    update (its twin here) makes the first NaN."""
    with pytest.raises(FloatingPointError, match="aten.mul"):
        loop.fit(ViTConfig(**KW), TrainConfig(
            debug_nans=True, log_dir=str(tmp_path), ckpt_dir=str(tmp_path),
            **cfgs(lr=float("nan"), steps_per_dispatch=steps_per_dispatch)),
            verbose=False, device="cpu")
    assert sanitizer_off()


def csv_row(log_dir):
    (path,) = glob.glob(f"{log_dir}/*.csv")
    with open(path) as f:
        return list(csv.reader(f))[1]


@pytest.mark.parametrize("steps_per_dispatch", [1, 2])
def test_clean_run_rows_do_not_depend_on_the_sanitizer(tmp_path, small_data,
                                                        steps_per_dispatch):
    rows = []
    for flag in (False, True):
        d = str(tmp_path / str(flag))
        loop.fit(ViTConfig(**KW), TrainConfig(
            debug_nans=flag, log_dir=d, ckpt_dir=d,
            **cfgs(steps_per_dispatch=steps_per_dispatch)), verbose=False,
            device="cpu")
        rows.append(csv_row(d))
        assert sanitizer_off()
    assert rows[0] == rows[1]


def trace_names(profile_dir):
    (path,) = glob.glob(f"{profile_dir}/*.pt.trace.json")
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_profile_dir_writes_a_trace_of_the_train_step(tmp_path, small_data):
    d = str(tmp_path / "run")
    loop.fit(ViTConfig(**KW), TrainConfig(
        profile_dir=str(tmp_path / "prof"), log_dir=d, ckpt_dir=d,
        **cfgs()), verbose=False, device="cpu")
    names = trace_names(tmp_path / "prof")
    # the forward's products, its softmax and the AdamW twin's updates
    assert {"aten::mm", "aten::exp", "aten::sqrt"} <= names, sorted(names)
    assert any(n and n.startswith("autograd::engine") for n in names)


def test_profile_dir_stops_when_fit_raises(tmp_path, small_data):
    with pytest.raises(FloatingPointError):
        loop.fit(ViTConfig(**KW), TrainConfig(
            profile_dir=str(tmp_path / "prof"), debug_nans=True,
            log_dir=str(tmp_path), ckpt_dir=str(tmp_path),
            **cfgs(lr=float("nan"))), verbose=False, device="cpu")
    assert "aten::mm" in trace_names(tmp_path / "prof")
    assert torch.autograd.profiler._is_profiler_enabled is False


@pytest.mark.parametrize("flags", [
    ["--profile_dir", "PROF"], ["--debug_nans"],
    ["--remat", "--remat_policy", "dots", "--drop_rate", "0.1"],
    ["--steps_per_dispatch", "2", "--grad_accum", "2", "--remat"]])
def test_train_cli_takes_the_ported_flags(tmp_path, small_data, monkeypatch,
                                          flags):
    monkeypatch.chdir(tmp_path)
    flags = [str(tmp_path / "prof") if f == "PROF" else f for f in flags]
    summary = train_cli.main([
        "--dataset", "mnist", "--synthetic", "--epochs", "1",
        "--batch_size", "16", "--img_size", "28", "--patch_size", "7",
        "--embed_dim", "32", "--depth", "2", "--num_heads", "2",
        "--pos_encoding", "rope-mixed", "--device", "cpu", *flags])
    assert np.isfinite(summary["history"][0]["train_loss"])
    if "--profile_dir" in flags:
        assert "aten::mm" in trace_names(tmp_path / "prof")
    assert sanitizer_off()
