"""PyTorch port, the C++ decoders (utils/native.py over native/dataio.cpp):
IDX (raw and .gz) and CIFAR-10 binary batches written here decode to the
numpy paths' arrays and to the JAX package's decode of the same files, bit
for bit; a malformed file is refused; the library is built under
build/native/ (never at native/libdataio.so), once when several builds
start together; data/datasets.py records which decoder ran, native or
numpy.

The JAX side is `vit_rpe_rope_tpu.data.datasets`' own decode (its C++
library where it is built, its numpy path otherwise)."""

import gzip
import os
import pathlib
import pickle
import subprocess
import threading

import numpy as np
import pytest

from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.utils import native


def write_idx(path, arr, gz=False):
    header = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    data = header + arr.astype(np.uint8).tobytes()
    if gz:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        pathlib.Path(path).write_bytes(data)


@pytest.fixture(scope="module")
def lib():
    lib = native.load()
    assert lib is not None, "the C++ decoders did not build (g++ and zlib " \
                            "are in the image)"
    return lib


@pytest.mark.parametrize("shape,gz", [((7, 28, 28), False), ((7, 28, 28), True),
                                      ((13,), False), ((2, 3, 4), True)])
def test_idx_decode_matches_numpy_and_jax(lib, tmp_path, shape, gz):
    arr = np.random.default_rng(len(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    path = str(tmp_path / "images-idx-ubyte")
    write_idx(path, arr, gz=gz)
    got = native.idx_decode(path)  # resolves the .gz twin
    assert got.dtype == np.uint8 and got.shape == shape
    np.testing.assert_array_equal(got, arr)
    np.testing.assert_array_equal(got, jdatasets._read_idx(path))
    before = datasets.DECODERS["idx", "native"]
    np.testing.assert_array_equal(datasets._read_idx(path), arr)
    assert datasets.DECODERS["idx", "native"] == before + 1


@pytest.mark.parametrize("payload", [b"\x01\x02\x03", b"\x00\x00\x09\x01",
                                     b"\x00\x00\x08\x07" + b"\x00" * 28])
def test_idx_decode_refuses_garbage(lib, tmp_path, payload):
    path = tmp_path / "bad"
    path.write_bytes(payload)
    assert native.idx_decode(str(path)) is None


@pytest.mark.parametrize("n", [1, 5])
def test_cifar_decode_matches_numpy_and_jax(lib, tmp_path, n):
    rec = np.random.default_rng(n).integers(0, 256, (n, 3073), dtype=np.uint8)
    rec[:, 0] %= 10
    path = tmp_path / "data_batch_1.bin"
    rec.tofile(path)
    images, labels = native.cifar_decode(str(path))
    np.testing.assert_array_equal(labels, rec[:, 0].astype(np.int32))
    want = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(images, want)
    assert labels.dtype == np.int32 and images.dtype == np.uint8


def test_cifar_decode_refuses_a_ragged_file(lib, tmp_path):
    path = tmp_path / "short.bin"
    path.write_bytes(bytes(3073 + 5))
    assert native.cifar_decode(str(path)) is None


def test_chw_to_hwc_matches_numpy(lib):
    chw = np.random.default_rng(2).integers(0, 256, (4, 3, 8, 8),
                                            dtype=np.uint8)
    np.testing.assert_array_equal(native.chw_to_hwc(chw),
                                  chw.transpose(0, 2, 3, 1))


def write_cifar(root, fmt, per_batch=3, seed=3):
    rng = np.random.default_rng(seed)
    names = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]
    if fmt == "bin":
        d = root / "cifar-10-batches-bin"
        os.makedirs(d)
        for name in names:
            rec = rng.integers(0, 256, (per_batch, 3073), dtype=np.uint8)
            rec[:, 0] %= 10
            rec.tofile(d / f"{name}.bin")
    else:
        d = root / "cifar-10-batches-py"
        os.makedirs(d)
        for name in names:
            data = rng.integers(0, 256, (per_batch, 3072), dtype=np.uint8)
            labels = [int(v) for v in rng.integers(0, 10, per_batch)]
            with open(d / name, "wb") as f:
                pickle.dump({b"data": data, b"labels": labels}, f)


@pytest.mark.parametrize("fmt,key", [("bin", "cifar_bin"),
                                     ("py", "chw_to_hwc")])
def test_datasets_decode_natively_and_match_jax(lib, tmp_path, fmt, key):
    write_cifar(tmp_path, fmt)
    before = datasets.DECODERS[key, "native"]
    got = datasets.load_cifar10(str(tmp_path))
    assert datasets.DECODERS[key, "native"] == before + 6
    want = jdatasets.load_cifar10(str(tmp_path))
    for field in ("train_x", "train_y", "test_x", "test_y"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("fmt,key", [("bin", "cifar_bin"),
                                     ("py", "chw_to_hwc")])
def test_datasets_record_the_numpy_fallback(tmp_path, monkeypatch, fmt, key):
    """Without the library the numpy paths decode the same arrays, and the
    record says so."""
    write_cifar(tmp_path, fmt, seed=4)
    want = datasets.load_cifar10(str(tmp_path))
    monkeypatch.setattr(native, "load", lambda: None)
    before = datasets.DECODERS[key, "numpy"]
    got = datasets.load_cifar10(str(tmp_path))
    assert datasets.DECODERS[key, "numpy"] == before + 6
    for field in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_mnist_loader_decodes_natively(lib, tmp_path):
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    rng = np.random.default_rng(5)
    files = {"train-images-idx3-ubyte": rng.integers(0, 256, (6, 28, 28)),
             "train-labels-idx1-ubyte": rng.integers(0, 10, (6,)),
             "t10k-images-idx3-ubyte": rng.integers(0, 256, (3, 28, 28)),
             "t10k-labels-idx1-ubyte": rng.integers(0, 10, (3,))}
    for i, (name, arr) in enumerate(files.items()):
        write_idx(str(raw / name), arr.astype(np.uint8), gz=i % 2 == 1)
    before = datasets.DECODERS["idx", "native"]
    got = datasets.load_mnist(str(tmp_path))
    assert datasets.DECODERS["idx", "native"] == before + 4
    want = jdatasets.load_mnist(str(tmp_path))
    for field in ("train_x", "train_y", "test_x", "test_y"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_library_lives_under_build(lib):
    path = native.library_path()
    repo = pathlib.Path(native.__file__).resolve().parents[2]
    assert path.parent == repo / "build" / "native" and path.exists()
    assert path.name.startswith("libdataio-") and path.suffix == ".so"


def test_build_writes_only_its_build_dir(tmp_path, monkeypatch):
    """A fresh build (into a temporary BUILD_DIR) links into a temporary
    file beside the library and renames it; no command names native/'s
    library; builds started together give one library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    real_run = subprocess.run
    commands = []

    def run(cmd, **kw):
        commands.append(list(cmd))
        return real_run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", run)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(set(paths)) == 1 and paths[0].exists()
    assert paths[0].parent == tmp_path / "native"
    assert len(commands) == 1  # the lock kept the others from compiling
    out = pathlib.Path(commands[0][commands[0].index("-o") + 1])
    assert out.parent == tmp_path / "native" and out != paths[0]
    assert not any(str(arg).endswith("native/libdataio.so")
                   for arg in commands[0])
    assert sorted(p.name for p in (tmp_path / "native").iterdir()) == \
        sorted(["lock", paths[0].name])
