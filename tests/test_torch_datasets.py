"""PyTorch port, datasets: the procedural dataset is byte-identical to the
JAX package's, and small IDX (plain and .gz), CIFAR-10 pickle and CIFAR-10
binary files written here decode to the same arrays in both packages."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu_torch.data import datasets


def assert_bundles_equal(got, want):
    assert got.name == want.name and got.in_chans == want.in_chans
    for field in ("train_x", "train_y", "test_x", "test_y", "mean", "std"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("dataset,n_train,seed", [
    ("mnist", 50, 0), ("cifar10", 40, 3), ("cifar10", 12800, 0)])
def test_synthetic_is_byte_identical(dataset, n_train, seed):
    n_test = 2560 if n_train == 12800 else 20
    assert_bundles_equal(
        datasets.synthetic(dataset, n_train=n_train, n_test=n_test, seed=seed),
        jdatasets.synthetic(dataset, n_train=n_train, n_test=n_test,
                            seed=seed))


def write_idx(path, arr, gz=False):
    header = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        f">{arr.ndim}I", *arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(path + ".gz", "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_idx_decodes_like_jax(tmp_path, gz):
    rng = np.random.default_rng(1)
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    for prefix, n in (("train", 7), ("t10k", 5)):
        write_idx(str(raw / f"{prefix}-images-idx3-ubyte"),
                  rng.integers(0, 256, (n, 28, 28)), gz)
        write_idx(str(raw / f"{prefix}-labels-idx1-ubyte"),
                  rng.integers(0, 10, (n,)), gz)
    got = datasets.get_dataset("mnist", str(tmp_path))
    assert got.train_x.shape == (7, 28, 28, 1) and got.test_y.shape == (5,)
    assert_bundles_equal(got, jdatasets.get_dataset("mnist", str(tmp_path)))


def cifar_records(rng, n):
    labels = rng.integers(0, 10, n)
    pixels = rng.integers(0, 256, (n, 3072))
    return labels, pixels


def test_cifar10_pickle_decodes_like_jax(tmp_path):
    rng = np.random.default_rng(2)
    root = tmp_path / "cifar-10-batches-py"
    os.makedirs(root)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels, pixels = cifar_records(rng, 3)
        with open(root / name, "wb") as f:
            pickle.dump({b"data": pixels.astype(np.uint8),
                         b"labels": labels.tolist()}, f)
    got = datasets.get_dataset("cifar10", str(tmp_path))
    assert got.train_x.shape == (15, 32, 32, 3) and got.test_x.shape[0] == 3
    assert_bundles_equal(got, jdatasets.get_dataset("cifar10", str(tmp_path)))


def test_cifar10_binary_decodes_like_jax(tmp_path):
    rng = np.random.default_rng(3)
    root = tmp_path / "cifar-10-batches-bin"
    os.makedirs(root)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] + [
            "test_batch.bin"]:
        labels, pixels = cifar_records(rng, 4)
        rec = np.concatenate([labels[:, None], pixels], axis=1).astype(np.uint8)
        rec.tofile(root / name)
    got = datasets.get_dataset("cifar10", str(tmp_path))
    assert got.train_x.shape == (20, 32, 32, 3)
    assert_bundles_equal(got, jdatasets.get_dataset("cifar10", str(tmp_path)))


@pytest.mark.parametrize("dataset", ["mnist", "cifar10"])
def test_missing_files_name_the_synthetic_flag(tmp_path, dataset):
    with pytest.raises(FileNotFoundError, match="--synthetic"):
        datasets.get_dataset(dataset, str(tmp_path))
