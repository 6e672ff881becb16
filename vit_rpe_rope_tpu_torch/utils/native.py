"""ctypes binding of the C++ data decoders (native/dataio.cpp, shared with
the JAX package and not edited here) — the port's own copy of the JAX
package's utils/native.py.

The source is compiled with the flags of native/Makefile at first use into
build/native/libdataio-<hash of the source>.so. The build holds a file lock
and links into a temporary file that is renamed into place, so concurrent
processes (test workers) never load a half-written library; native/ is
never written. Where there is no compiler, or the build fails, `load()`
returns None and each decoder returns None: callers (data/datasets.py)
then take the numpy path and record that they did.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import numpy as np

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "dataio.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's CXXFLAGS and link line.
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdataio-{digest}.so"


@contextlib.contextmanager
def _file_lock(path: pathlib.Path):
    with open(path, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build() -> pathlib.Path:
    """Compile dataio.cpp unless its library exists; returns its path.
    Raises when there is no C++ compiler or the compiler fails."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build " + SOURCE.name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _file_lock(BUILD_DIR / "lock"):
        if lib_path.exists():  # another process built it meanwhile
            return lib_path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE), "-lz"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"{cxx} failed on {SOURCE.name} "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    return lib_path


def _bind(lib):
    lib.idx_decode.restype = ctypes.c_int64
    lib.idx_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32)]
    lib.cifar_decode_batch.restype = ctypes.c_int64
    lib.cifar_decode_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.chw_to_hwc.restype = None
    lib.chw_to_hwc.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64]


def load():
    """The loaded library, or None when it cannot be built or loaded (one
    attempt per process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError, subprocess.SubprocessError):
            return None
        _bind(lib)
        _lib = lib
        return _lib


def idx_decode(path: str) -> np.ndarray | None:
    """An IDX file (raw, or its .gz twin where only that exists) as a uint8
    ndarray; None without the library or on a malformed file."""
    lib = load()
    if lib is None:
        return None
    if not os.path.exists(path) and os.path.exists(path + ".gz"):
        path = path + ".gz"
    dims = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int32()
    size = lib.idx_decode(path.encode(), None, 0, dims, ctypes.byref(ndim))
    if size < 0:
        return None
    out = np.empty(size, np.uint8)
    got = lib.idx_decode(path.encode(), out.ctypes.data_as(ctypes.c_void_p),
                         size, dims, ctypes.byref(ndim))
    if got != size:
        return None
    return out.reshape(tuple(dims[i] for i in range(ndim.value)))


def cifar_decode(path: str):
    """One CIFAR-10 binary batch -> (images NHWC uint8, labels int32); None
    without the library or on a malformed file."""
    lib = load()
    if lib is None:
        return None
    n = lib.cifar_decode_batch(path.encode(), None, None, 0)
    if n < 0:
        return None
    images = np.empty((n, 32, 32, 3), np.uint8)
    labels = np.empty((n,), np.int32)
    got = lib.cifar_decode_batch(
        path.encode(), images.ctypes.data_as(ctypes.c_void_p),
        labels.ctypes.data_as(ctypes.c_void_p), n)
    if got != n:
        return None
    return images, labels


def chw_to_hwc(chw: np.ndarray) -> np.ndarray | None:
    """[N, C, H, W] uint8 -> [N, H, W, C]; None without the library."""
    lib = load()
    if lib is None:
        return None
    n, c, h, w = chw.shape
    chw = np.ascontiguousarray(chw, dtype=np.uint8)
    out = np.empty((n, h, w, c), np.uint8)
    lib.chw_to_hwc(chw.ctypes.data_as(ctypes.c_void_p),
                   out.ctypes.data_as(ctypes.c_void_p), n, c, h * w)
    return out
