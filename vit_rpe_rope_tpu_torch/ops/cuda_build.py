"""Build and load the port's hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library with
a plain C interface, at first use, into BUILD_DIR, keyed by a hash of the
source and of the headers beside it; the wrappers bind it with ctypes. The
compiler's resource report (-Xptxas -v) is kept beside each library as .log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): nvcc is "
                           "needed to build the kernels in " + str(CSRC))
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(source: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile `source` unless its library exists already; returns the
    library's path. Raises with the compiler's output when nvcc fails."""
    lib_path = library_path(source)
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}\n"
                           f"{proc.stderr}")
    lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib_path)  # atomic: concurrent builders race safely
    return lib_path


def build_all(sources) -> list:
    """Build several sources at once, one nvcc each, all started together.
    Raises after all have finished, with every failure's output."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = [pool.submit(build, s) for s in sources]
    errors = [f.exception() for f in futures if f.exception() is not None]
    if errors:
        raise RuntimeError("\n".join(str(e) for e in errors))
    return [f.result() for f in futures]


def ptxas_report(text: str) -> list:
    """The kernels of a `-Xptxas -v` report (a library's .log): one
    (mangled name, registers, spill bytes stored) per compiled entry."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def load(source: pathlib.Path, bind) -> ctypes.CDLL:
    """The loaded library of `source` (built first if needed); `bind(lib)`
    declares its functions' ctypes signatures once."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
        return lib
