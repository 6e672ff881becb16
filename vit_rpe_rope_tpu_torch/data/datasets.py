"""Dataset decoding: MNIST IDX files, CIFAR-10 python/binary batches, and a
deterministic procedural fallback — the JAX package's data/datasets.py.

The reference delegates to torchvision: MNIST with Resize(img_size) +
Normalize(0.1307, 0.3081), CIFAR-10 with Normalize((0.4914, 0.4822,
0.4465), (0.2023, 0.1994, 0.2010)), batch 128, shuffle train only, no
augmentation. Here the standard on-disk formats are decoded directly with
the C++ decoders of native/dataio.cpp (utils/native.py: IDX raw and .gz,
CIFAR binary batches, the CHW->HWC transpose of the python batches), or
with numpy where that library cannot be built (the same bytes either way),
with a procedural dataset (--synthetic) when the files are absent. Each
decode adds one to DECODERS[(format, "native" | "numpy")], so a caller can
see which path ran. Decoded arrays are uint8 NHWC; float conversion, resize
and normalization run on the device in the train step
(train/train_step.make_preprocess).
"""

from __future__ import annotations

import collections
import gzip
import os
import pickle
import struct

import numpy as np

from vit_rpe_rope_tpu_torch.utils import native

# Normalization constants, exactly the reference's.
NORMALIZATION = {
    "mnist": (np.array([0.1307], np.float32), np.array([0.3081], np.float32)),
    "cifar10": (
        np.array([0.4914, 0.4822, 0.4465], np.float32),
        np.array([0.2023, 0.1994, 0.2010], np.float32),
    ),
}

NATIVE_SIZE = {"mnist": 28, "cifar10": 32}

# Decodes since import, by (format, decoder): format "idx", "cifar_bin" or
# "chw_to_hwc"; decoder "native" (utils/native.py) or "numpy".
DECODERS: collections.Counter = collections.Counter()


class DatasetBundle:
    """Decoded dataset: uint8 NHWC images + int32 labels, host-side."""

    def __init__(self, name, train_x, train_y, test_x, test_y):
        self.name = name
        self.train_x, self.train_y = train_x, train_y
        self.test_x, self.test_y = test_x, test_y
        self.mean, self.std = NORMALIZATION[name]
        self.num_classes = 10
        self.in_chans = train_x.shape[-1]


# ---------------------------------------------------------------------------
# MNIST — IDX format
# ---------------------------------------------------------------------------

def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path):
    arr = native.idx_decode(path)  # handles the .gz twin too
    if arr is not None:
        DECODERS["idx", "native"] += 1
        return arr
    DECODERS["idx", "numpy"] += 1
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def load_mnist(root: str) -> DatasetBundle:
    raw = os.path.join(root, "MNIST", "raw")
    if not os.path.isdir(raw):
        raw = root  # also accept the files directly under root

    def p(name):
        return os.path.join(raw, name)

    train_x = _read_idx(p("train-images-idx3-ubyte"))[..., None]
    train_y = _read_idx(p("train-labels-idx1-ubyte")).astype(np.int32)
    test_x = _read_idx(p("t10k-images-idx3-ubyte"))[..., None]
    test_y = _read_idx(p("t10k-labels-idx1-ubyte")).astype(np.int32)
    return DatasetBundle("mnist", train_x, train_y, test_x, test_y)


# ---------------------------------------------------------------------------
# CIFAR-10 — python pickle batches or the binary format
# ---------------------------------------------------------------------------

def _chw_to_hwc(chw):
    hwc = native.chw_to_hwc(chw)
    if hwc is not None:
        DECODERS["chw_to_hwc", "native"] += 1
        return hwc
    DECODERS["chw_to_hwc", "numpy"] += 1
    return chw.transpose(0, 2, 3, 1)


def load_cifar10(root: str) -> DatasetBundle:
    py_dir = os.path.join(root, "cifar-10-batches-py")
    bin_dir = os.path.join(root, "cifar-10-batches-bin")
    if os.path.isdir(py_dir):
        def read_batch(name):
            with open(os.path.join(py_dir, name), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            chw = d[b"data"].reshape(-1, 3, 32, 32)
            return _chw_to_hwc(chw), np.array(d[b"labels"], np.int32)

        xs, ys = zip(*(read_batch(f"data_batch_{i}") for i in range(1, 6)))
        train_x, train_y = np.concatenate(xs), np.concatenate(ys)
        test_x, test_y = read_batch("test_batch")
    elif os.path.isdir(bin_dir):
        def read_bin(name):
            path = os.path.join(bin_dir, name)
            decoded = native.cifar_decode(path)
            if decoded is not None:
                DECODERS["cifar_bin", "native"] += 1
                return decoded
            DECODERS["cifar_bin", "numpy"] += 1
            rec = np.fromfile(path, dtype=np.uint8)
            rec = rec.reshape(-1, 3073)
            y = rec[:, 0].astype(np.int32)
            x = rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return x, y

        xs, ys = zip(*(read_bin(f"data_batch_{i}.bin") for i in range(1, 6)))
        train_x, train_y = np.concatenate(xs), np.concatenate(ys)
        test_x, test_y = read_bin("test_batch.bin")
    else:
        raise FileNotFoundError(
            f"CIFAR-10 not found under {root} (expected cifar-10-batches-py/ "
            "or cifar-10-batches-bin/)"
        )
    return DatasetBundle("cifar10", np.ascontiguousarray(train_x), train_y,
                         np.ascontiguousarray(test_x), test_y)


# ---------------------------------------------------------------------------
# Procedural fallback — deterministic, learnable, clearly synthetic
# ---------------------------------------------------------------------------

def synthetic(dataset: str, n_train: int = 12800, n_test: int = 2560,
              seed: int = 0) -> DatasetBundle:
    """Class-conditional blob images: class k places a Gaussian blob at one of
    10 fixed grid positions (plus noise), so spatial position carries the
    label — positional encodings matter, and any working model beats random
    quickly. The same numpy draws as the JAX package's, so the bytes are
    identical."""
    size = NATIVE_SIZE[dataset]
    chans = 1 if dataset == "mnist" else 3
    rng = np.random.default_rng(seed)
    centers = [(r, c) for r in (0.25, 0.5, 0.75) for c in (0.25, 0.5, 0.75)]
    centers.append((0.85, 0.85))  # 10th class
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size

    def make(n, label_seed):
        labels = np.arange(n, dtype=np.int32) % 10
        rng_l = np.random.default_rng(label_seed)
        rng_l.shuffle(labels)
        imgs = np.empty((n, size, size, chans), np.uint8)
        jitter = rng.normal(0, 0.02, (n, 2)).astype(np.float32)
        noise = rng.normal(0, 18.0, (n, size, size, chans)).astype(np.float32)
        for i in range(n):
            cy, cx = centers[labels[i]]
            blob = 215.0 * np.exp(
                -(((yy - cy - jitter[i, 0]) ** 2 + (xx - cx - jitter[i, 1]) ** 2)
                  / (2 * 0.01))
            )
            img = blob[..., None] + noise[i] + 20.0
            imgs[i] = np.clip(img, 0, 255).astype(np.uint8)
        return imgs, labels

    train_x, train_y = make(n_train, seed + 1)
    test_x, test_y = make(n_test, seed + 2)
    return DatasetBundle(dataset, train_x, train_y, test_x, test_y)


def get_dataset(dataset: str, data_dir: str = "./data",
                use_synthetic: bool = False, seed: int = 0) -> DatasetBundle:
    if use_synthetic:
        return synthetic(dataset, seed=seed)
    loader = load_mnist if dataset == "mnist" else load_cifar10
    try:
        return loader(data_dir)
    except (FileNotFoundError, OSError) as e:
        raise FileNotFoundError(
            f"{dataset} data not found under {data_dir} ({e}). Place the "
            "standard files there or pass --synthetic for a procedural "
            "dataset."
        ) from None
