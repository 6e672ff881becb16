"""Fused multi-tensor AdamW on a hand-written CUDA kernel (ops/csrc/adamw.cu)
— the port of the JAX package's Pallas `_adamw_kernel` and its driver
`make_fused_adamw`.

Math is exactly torch/optax AdamW (decoupled weight decay on ALL params,
bias-corrected moments), in float32:
    mu    <- b1·mu + (1-b1)·g
    nu    <- b2·nu + (1-b2)·g²
    p     <- p − lr·( (mu/(1−b1^t)) / (sqrt(nu/(1−b2^t)) + eps) + wd·p )
lr (the schedule at the pre-increment count) and the bias corrections are
float32 scalars computed on the host, as `make_fused_adamw.update` computes
them.

`adamw_update` is the kernel's wrapper: on CUDA tensors it launches the
kernel once for all leaves (once per MAX_GRADS leaves; every model of the
repo has fewer) and counts each launch in LAUNCHES_ADAMW, on CPU tensors it
runs `adamw_plain`, the kernel's plain PyTorch twin. Both update p, mu and
nu in place (the JAX kernel returns new arrays).

The kernel reads the leaves' records and its chunk list from a device table
(`build_table`) that the wrapper keeps per set of p, mu and nu storages
(`table_key`: their pointers and sizes) and builds again, after the full
checks, only when that set changes (TABLE_BUILDS counts the builds). The
gradients, new tensors every step, go to the kernel by value, so a step with
an unchanged parameter set makes no host-to-device copy.

`adamw_update_table` launches the same kernel through its second entry,
which reads lr, c1, c2 and a live flag from four float32 values in device
memory (a row of `hyper_rows`) when it runs: the update of a step captured
in a CUDA graph (train_step.make_train_multi_step), whose host fills those
values before each replay; a row whose flag is 0 leaves p, mu and nu as
they were. It counts its launches in LAUNCHES_ADAMW_TABLE.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build
from vit_rpe_rope_tpu_torch.utils import nan_check

SOURCE = cuda_build.CSRC / "adamw.cu"

# Elements per CTA, and gradient pointers one launch takes by value
# (csrc/adamw.cu CHUNK and MAX_GRADS).
CHUNK = 4096
MAX_GRADS = 480

# Launches of the CUDA kernel since the count was last reset: through the
# by-value entry, and through the device-table entry.
LAUNCHES_ADAMW = 0
LAUNCHES_ADAMW_TABLE = 0

# Device tables built since the count was last reset.
TABLE_BUILDS = 0

# Device tables kept, the most recently used last.
_TABLES: collections.OrderedDict = collections.OrderedDict()
_KEPT_TABLES = 8
# Tables read by a captured CUDA graph: never dropped while the process runs
# (a replay reads them by address).
_CAPTURED_TABLES: dict = {}


def _bind(lib):
    lib.adamw_chunk.restype = ctypes.c_int
    lib.adamw_chunk.argtypes = ()
    lib.adamw_max_grads.restype = ctypes.c_int
    lib.adamw_max_grads.argtypes = ()
    lib.adamw_step.restype = ctypes.c_int
    lib.adamw_step.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p]          # leaves chunks
        + [ctypes.c_int] * 3                        # n_chunks leaf0 n_grads
        + [ctypes.POINTER(ctypes.c_void_p)]         # grads (host array)
        + [ctypes.c_float] * 9 + [ctypes.c_void_p])  # hyper stream
    lib.adamw_step_table.restype = ctypes.c_int
    lib.adamw_step_table.argtypes = (
        [ctypes.c_void_p, ctypes.c_void_p]          # leaves chunks
        + [ctypes.c_int] * 3                        # n_chunks leaf0 n_grads
        + [ctypes.POINTER(ctypes.c_void_p)]         # grads (host array)
        + [ctypes.c_void_p]                         # (lr, c1, c2, live)
        + [ctypes.c_float] * 6 + [ctypes.c_void_p])  # b1 .. wd, stream
    if (lib.adamw_chunk(), lib.adamw_max_grads()) != (CHUNK, MAX_GRADS):
        raise RuntimeError("adamw.cu's CHUNK / MAX_GRADS differ from "
                           "fused_adamw.CHUNK / MAX_GRADS")


def _library():
    return cuda_build.load(SOURCE, _bind)


def adamw_plain(params, grads, mus, nus, lr, c1, c2, b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.01):
    """The kernel's function in plain PyTorch over lists of float32 leaves,
    in place, rounded op by op as the kernel rounds it."""
    omb1, omb2 = float(np.float32(1.0 - b1)), float(np.float32(1.0 - b2))
    with torch.no_grad():
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.mul_(b1).add_(g * omb1)
            nu.mul_(b2).add_((g * omb2) * g)
            update = (mu / c1) / ((nu / c2).sqrt() + eps) + weight_decay * p
            p.sub_(lr * update)


def adamw_exact(params, grads, mus, nus, lr, c1, c2, b1=0.9, b2=0.999,
                eps=1e-8, weight_decay=0.01):
    """The kernel's function with every operation rounded to float32 as
    IEEE rounds it, the reference the kernel is held to bit for bit: each
    operation runs in float64 on float32 values and is rounded to float32,
    which gives the correctly rounded float32 result of +, -, *, / and sqrt.
    (adamw_plain rounds at the same points, but PyTorch's float32 sqrt on
    the CPU is not correctly rounded, and on CUDA it divides by a Python
    scalar as a product with the reciprocal.) Returns new lists (p, mu,
    nu); the inputs are left as they are."""
    out = ([], [], [])
    for p, g, mu, nu in zip(params, grads, mus, nus):
        def s(v):  # a float32 scalar as a tensor (no reciprocal on CUDA)
            return torch.full((), float(np.float32(v)), dtype=torch.float64,
                              device=p.device)

        def r(x):
            return x.float().double()

        pd, gd, mud, nud = (t.double() for t in (p, g, mu, nu))
        m = r(r(s(b1) * mud) + r(s(1.0 - b1) * gd))
        v = r(r(s(b2) * nud) + r(r(s(1.0 - b2) * gd) * gd))
        denom = r(r(r(v / s(c2)).sqrt()) + s(eps))
        update = r(r(r(m / s(c1)) / denom) + r(s(weight_decay) * pd))
        for lst, x in zip(out, (pd - r(s(lr) * update), m, v)):
            lst.append(x.float())
    return out


def table_key(params, mus, nus):
    """What the device table depends on: the device, and the storage
    pointers of p, mu, nu and the sizes of every leaf."""
    ptr = torch.Tensor.data_ptr
    return (params[0].get_device(), *map(ptr, params), *map(ptr, mus),
            *map(ptr, nus), *map(torch.Tensor.numel, params))


def build_table(p_ptrs, mu_ptrs, nu_ptrs, numels, chunk=CHUNK,
                max_grads=MAX_GRADS):
    """The kernel's table for leaves at these pointers, a pure function of
    them: one int64 array holding a record (p, mu, nu, numel) per leaf, then
    a (leaf, first element) pair per `chunk` elements of each leaf, in leaf
    order; and the launches as (first leaf, leaves, first chunk, chunks),
    at most `max_grads` leaves each."""
    numels = np.asarray(numels, np.int64)
    per_leaf = -(-numels // chunk)
    first = np.cumsum(per_leaf) - per_leaf
    leaf_of = np.repeat(np.arange(len(numels)), per_leaf)
    starts = (np.arange(per_leaf.sum()) - first[leaf_of]) * chunk
    leaves = np.stack([np.asarray(p_ptrs, np.int64),
                       np.asarray(mu_ptrs, np.int64),
                       np.asarray(nu_ptrs, np.int64), numels], axis=1)
    table = np.concatenate([leaves.ravel(),
                            np.stack([leaf_of, starts], axis=1).ravel()])
    launches = []
    for leaf0 in range(0, len(numels), max_grads):
        leaf1 = min(leaf0 + max_grads, len(numels))
        launches.append((leaf0, leaf1 - leaf0, int(first[leaf0]),
                         int(per_leaf[leaf0:leaf1].sum())))
    return table, launches


def _device_table(params, mus, nus):
    """The cached (table tensor, launches) of these storages; built, after
    the full checks, when they are new."""
    global TABLE_BUILDS
    key = table_key(params, mus, nus)
    capturing = params[0].is_cuda and torch.cuda.is_current_stream_capturing()
    entry = _CAPTURED_TABLES.get(key) or _TABLES.get(key)
    if entry is not None:
        if key in _TABLES:
            _TABLES.move_to_end(key)
        if capturing:
            _CAPTURED_TABLES[key] = entry
        return entry
    if capturing:
        raise RuntimeError("the AdamW device table of these parameters must "
                           "be built before a CUDA graph capture (run one "
                           "step first)")
    device = params[0].device
    for i, (p, mu, nu) in enumerate(zip(params, mus, nus, strict=True)):
        for name, t in (("param", p), ("mu", mu), ("nu", nu)):
            if t.dtype != torch.float32 or t.device != device:
                raise TypeError(f"leaf {i}: {name} must be float32 on "
                                f"{device}, got {t.dtype} on {t.device}")
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} has shape "
                                 f"{tuple(t.shape)}, param {tuple(p.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {i}: {name} must be contiguous (it "
                                 f"is updated in place)")
    table, launches = build_table(
        [p.data_ptr() for p in params], [m.data_ptr() for m in mus],
        [n.data_ptr() for n in nus], [p.numel() for p in params])
    entry = (torch.from_numpy(table).to(device), launches,
             [p.numel() for p in params])
    TABLE_BUILDS += 1
    _TABLES[key] = entry
    while len(_TABLES) > _KEPT_TABLES:
        _TABLES.popitem(last=False)
    return entry


def _grad_pointers(grads, params, numels):
    """The gradients' device pointers, checked against the leaves; the list
    of contiguous copies made (autograd may hand a transposed view), which
    must live until the launch is enqueued."""
    if len(grads) != len(numels):
        raise ValueError(f"{len(grads)} grads for {len(numels)} params")
    dev = params[0].get_device()
    keep, g_ptrs = [], []
    for i, (g, n) in enumerate(zip(grads, numels)):
        if g.dtype != torch.float32 or g.get_device() != dev:
            raise TypeError(f"leaf {i}: grad must be float32 on "
                            f"{params[0].device}, got {g.dtype} on "
                            f"{g.device}")
        if g.numel() != n:
            raise ValueError(f"leaf {i}: grad has {g.numel()} elements, "
                             f"param {n}")
        if not g.is_contiguous():
            g = g.contiguous()
            keep.append(g)
        g_ptrs.append(g.data_ptr())
    return g_ptrs, keep


def _launch_all(params, mus, nus, grads, launch_one):
    """One launch per group of MAX_GRADS leaves: launch_one(base, chunks,
    n_chunks, leaf0, n_leaves, grad pointer array, stream) -> CUDA error."""
    table, launches, numels = _device_table(params, mus, nus)
    g_ptrs, keep = _grad_pointers(grads, params, numels)
    base = table.data_ptr()
    chunks = base + 8 * 4 * len(numels)
    n = 0
    with torch.cuda.device(params[0].get_device()):
        stream = torch.cuda.current_stream().cuda_stream
        for leaf0, n_leaves, c0, n_chunks in launches:
            if n_chunks == 0:  # only empty leaves: nothing to launch
                continue
            err = launch_one(
                base, chunks + 16 * c0, n_chunks, leaf0, n_leaves,
                (ctypes.c_void_p * n_leaves)(*g_ptrs[leaf0:leaf0 + n_leaves]),
                stream)
            if err != 0:
                raise RuntimeError(f"adamw launch failed: CUDA error {err}")
            n += 1
    del keep  # the copies lived until their launches were enqueued
    return n


def adamw_update(params, grads, mus, nus, lr, c1, c2, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.01):
    """The kernel's wrapper over lists of float32 leaves (p, g, mu, nu of
    one shape each). CPU tensors run the plain twin; CUDA tensors launch
    the kernel on the current stream, or raise."""
    global LAUNCHES_ADAMW
    if not params:
        return
    if params[0].device.type == "cpu":
        adamw_plain(params, grads, mus, nus, lr, c1, c2, b1, b2, eps,
                    weight_decay)
        return
    lib = _library()
    LAUNCHES_ADAMW += _launch_all(
        params, mus, nus, grads,
        lambda *a: lib.adamw_step(*a[:6], lr, c1, c2, b1, b2, 1.0 - b1,
                                  1.0 - b2, eps, weight_decay, a[6]))
    nan_check.check("adamw", *params)


def hyper_rows(rows, device):
    """[len(rows), 4] float32 (lr, c1, c2, live) rows for
    adamw_update_table, from (lr, c1, c2, live) tuples (live: 0 or 1)."""
    return torch.tensor(rows, dtype=torch.float32).reshape(-1, 4).to(device)


def adamw_update_table(params, grads, mus, nus, hyper, b1=0.9, b2=0.999,
                       eps=1e-8, weight_decay=0.01):
    """The kernel's device-table entry: as adamw_update, with lr, c1, c2 and
    the live flag read from `hyper`, four contiguous float32 values on the
    leaves' device (a row of hyper_rows), when the kernel runs; a flag of 0
    leaves every leaf as it was. CPU tensors run the plain twin on the
    values read on the host."""
    global LAUNCHES_ADAMW_TABLE
    if not params:
        return
    if hyper.shape != (4,) or hyper.dtype != torch.float32 \
            or hyper.device != params[0].device or not hyper.is_contiguous():
        raise ValueError("hyper must be 4 contiguous float32 values on the "
                         "params' device")
    if params[0].device.type == "cpu":
        lr, c1, c2, live = hyper.tolist()
        if live != 0.0:
            adamw_plain(params, grads, mus, nus, lr, c1, c2, b1, b2, eps,
                        weight_decay)
        return
    if hyper.data_ptr() % 16:
        raise ValueError("hyper must be 16-byte aligned")
    lib = _library()
    LAUNCHES_ADAMW_TABLE += _launch_all(
        params, mus, nus, grads,
        lambda *a: lib.adamw_step_table(*a[:6], hyper.data_ptr(), b1, b2,
                                        1.0 - b1, 1.0 - b2, eps, weight_decay,
                                        a[6]))


def bias_corrections(count: int, b1: float, b2: float):
    """(1 − b1^t, 1 − b2^t) at t = count, in float32."""
    t = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t))


def make_fused_adamw(template: dict, schedule, b1=0.9, b2=0.999, eps=1e-8,
                     weight_decay=0.01, step=adamw_update):
    """Returns (init, update) with the JAX driver's contract over a params
    DICT:

        state = init(params)                       # (mu, nu, count)
        params, state = update(grads, state, params)

    `step` applies one update to lists of leaves (default: the kernel's
    wrapper; adamw_plain runs the twin on any device). params, mu and nu
    are updated in place and returned.

    For a step captured in a CUDA graph, update carries two more functions:
    update.hyper(count) -> (lr, c1, c2) of the step that brings the count
    to `count`, the values `update` itself uses, and
    update.from_table(grads, state, params, row), the update through
    adamw_update_table on a device row of hyper_rows; it leaves the count
    to the caller, who advances it by the live steps."""
    keys = list(template)

    def init(params):
        return ({k: torch.zeros_like(params[k]) for k in keys},
                {k: torch.zeros_like(params[k]) for k in keys}, 0)

    def hyper(count):
        lr = float(schedule(count - 1))  # lr of the pre-increment count
        return (lr, *bias_corrections(count, b1, b2))

    def leaves(grads, state, params):
        mu, nu, _ = state
        return ([params[k] for k in keys], [grads[k] for k in keys],
                [mu[k] for k in keys], [nu[k] for k in keys])

    def update(grads, state, params):
        mu, nu, count = state
        count += 1
        step(*leaves(grads, state, params), *hyper(count), b1, b2, eps,
             weight_decay)
        return params, (mu, nu, count)

    def from_table(grads, state, params, row):
        adamw_update_table(*leaves(grads, state, params), row, b1, b2, eps,
                           weight_decay)
        return params, state

    update.hyper = hyper
    update.from_table = from_table
    return init, update
