"""PyTorch port, antialiased downsampling in train_step.make_preprocess, on
the CPU: the resize against jax.image.resize(..., "bilinear") when it
shrinks and when it enlarges, and the train CLI on models smaller than the
data's images (--dataset cifar10 --img_size 16, --dataset mnist with a model
below 28 px), whose best checkpoint serves its test accuracy through the
Predictor on images at the data's size.

Tolerance: 1e-6 on the normalized images (float32 filters summed in
another order; the largest difference seen is below 2e-7 before the
normalization's division by std).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch import serving
from vit_rpe_rope_tpu_torch.cli import train
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.train import train_step as ts

TOL = 1e-6


@pytest.mark.parametrize("size,img,chans", [
    (32, 16, 3), (32, 8, 3), (32, 24, 3), (28, 14, 1), (28, 16, 1),
    (28, 20, 1), (224, 112, 3), (32, 64, 3), (28, 32, 1), (16, 32, 3),
    (32, 32, 3)])
def test_preprocess_matches_jax_resize(size, img, chans):
    dataset = "mnist" if chans == 1 else "cifar10"
    mean, std = datasets.NORMALIZATION[dataset]
    kw = dict(img_size=img, patch_size=4 if img % 4 == 0 else 2,
              in_chans=chans)
    u8 = np.random.default_rng(size + img).integers(
        0, 256, (3, size, size, chans), dtype=np.uint8)
    want = jts.make_preprocess(JaxViTConfig(**kw), mean, std, size)(
        jnp.asarray(u8))
    got = ts.make_preprocess(ViTConfig(**kw), mean, std, size)(
        torch.from_numpy(u8))
    assert tuple(got.shape) == (3, img, img, chans)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("dataset,img", [("cifar10", 16), ("mnist", 16)])
def test_train_cli_trains_below_the_data_size(dataset, img, tmp_path,
                                              monkeypatch, capsys):
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: datasets.synthetic(
            dataset, n_train=64, n_test=32, seed=seed))
    summary = train.main([
        "--dataset", dataset, "--synthetic", "--epochs", "1",
        "--img_size", str(img), "--patch_size", "4", "--batch_size", "32",
        "--depth", "1", "--embed_dim", "32", "--num_heads", "2",
        "--pos_encoding", "rope-axial", "--log_dir", str(tmp_path / "logs"),
        "--ckpt_dir", str(tmp_path / "ckpts"), "--device", "cpu"])
    assert "Done. Best Test Acc" in capsys.readouterr().out
    row = summary["history"][0]
    assert np.isfinite(row["train_loss"]) and np.isfinite(row["test_loss"])
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        summary["ckpt_path"], grid_size=img // 4, num_heads=2)
    assert (cfg.img_size, native) == (img, datasets.NATIVE_SIZE[dataset])
    test = datasets.synthetic(dataset, n_train=64, n_test=32, seed=0)
    preds = serving.Predictor.from_params(params, cfg, mean, std, native,
                                          device="cpu").predict(test.test_x)
    assert 100.0 * float((preds == test.test_y).mean()) == pytest.approx(
        summary["best_acc"], abs=1e-9)
