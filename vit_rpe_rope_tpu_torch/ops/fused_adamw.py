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
kernel once for all leaves (and counts the launch in LAUNCHES_ADAMW), on
CPU tensors it runs `adamw_plain`, the kernel's plain PyTorch twin. Both
update p, mu and nu in place (the JAX kernel returns new arrays).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "adamw.cu"

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES_ADAMW = 0


def _bind(lib):
    lib.adamw_chunk.restype = ctypes.c_int
    lib.adamw_chunk.argtypes = ()
    lib.adamw_step.restype = ctypes.c_int
    lib.adamw_step.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
                               + [ctypes.c_float] * 9 + [ctypes.c_void_p])


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


def adamw_update(params, grads, mus, nus, lr, c1, c2, b1=0.9, b2=0.999,
                 eps=1e-8, weight_decay=0.01):
    """The kernel's wrapper over lists of float32 leaves (p, g, mu, nu of
    one shape each). CPU tensors run the plain twin; CUDA tensors launch
    the kernel once on the current stream, or raise."""
    global LAUNCHES_ADAMW
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        adamw_plain(params, grads, mus, nus, lr, c1, c2, b1, b2, eps,
                    weight_decay)
        return
    rows, keep = [], []
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus,
                                           strict=True)):
        for name, t in (("param", p), ("grad", g), ("mu", mu), ("nu", nu)):
            if t.dtype != torch.float32 or t.device != device:
                raise TypeError(f"leaf {i}: {name} must be float32 on "
                                f"{device}, got {t.dtype} on {t.device}")
            if t.shape != p.shape:
                raise ValueError(f"leaf {i}: {name} has shape "
                                 f"{tuple(t.shape)}, param {tuple(p.shape)}")
        for name, t in (("param", p), ("mu", mu), ("nu", nu)):
            if not t.is_contiguous():
                raise ValueError(f"leaf {i}: {name} must be contiguous (it "
                                 f"is updated in place)")
        g = g.contiguous()  # autograd may hand a transposed view
        keep.append(g)
        rows.append([p.data_ptr(), g.data_ptr(), mu.data_ptr(),
                     nu.data_ptr(), p.numel()])
    lib = _library()
    # One host->device copy: the leaf records, then a (leaf, first element)
    # pair for each chunk of each leaf.
    numels = np.array([r[4] for r in rows], np.int64)
    per_leaf = -(-numels // lib.adamw_chunk())
    first = np.repeat(np.cumsum(per_leaf) - per_leaf, per_leaf)
    chunks = np.stack([np.repeat(np.arange(len(rows)), per_leaf),
                       (np.arange(per_leaf.sum()) - first) * lib.adamw_chunk()],
                      axis=1)
    table = torch.from_numpy(np.concatenate(
        [np.array(rows, np.int64).ravel(), chunks.ravel()])).pin_memory().to(
            device, non_blocking=True)
    with torch.cuda.device(device):
        err = lib.adamw_step(
            table.data_ptr(), table.data_ptr() + 8 * 5 * len(rows),
            len(chunks), lr, c1, c2, b1, b2, float(np.float32(1.0 - b1)),
            float(np.float32(1.0 - b2)), eps, weight_decay,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"adamw launch failed: CUDA error {err}")
    LAUNCHES_ADAMW += 1


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
    are updated in place and returned."""
    keys = list(template)

    def init(params):
        return ({k: torch.zeros_like(params[k]) for k in keys},
                {k: torch.zeros_like(params[k]) for k in keys}, 0)

    def update(grads, state, params):
        mu, nu, count = state
        count += 1
        lr = float(schedule(count - 1))  # lr of the pre-increment count
        c1, c2 = bias_corrections(count, b1, b2)
        step([params[k] for k in keys], [grads[k] for k in keys],
             [mu[k] for k in keys], [nu[k] for k in keys], lr, c1, c2, b1,
             b2, eps, weight_decay)
        return params, (mu, nu, count)

    return init, update
