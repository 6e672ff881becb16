"""The NaN sanitizer of --debug_nans (the JAX package's jax_debug_nans).

Inside `debug_nans()` every floating-point result of an aten op, in the
forward and in the backward, is checked as it is made, and the first one
that holds a NaN raises FloatingPointError naming the op. The kernels
write their outputs through ctypes, which no dispatch mode sees, so their
wrappers call `check` on what they wrote (a no-op unless the sanitizer is
on). Autograd's anomaly mode with check_nan=True is on as well, for any
gradient the two miss. Every check reads a value on the host: a debugging
mode, as in JAX.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ACTIVE = False  # read by the kernels' wrappers

# Allocations hold whatever the memory held, which can read as NaN.
_UNINITIALISED = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_like.default,
    torch.ops.aten.empty_strided.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
}


def _raise_on_nan(name, tensors):
    for t in tensors:
        if (isinstance(t, torch.Tensor) and t.is_floating_point()
                and bool(torch.isnan(t).any())):
            raise FloatingPointError(f"NaN in the output of {name} "
                                     f"(shape {tuple(t.shape)}, {t.dtype})")


def check(name: str, *tensors) -> None:
    """Raise FloatingPointError when the sanitizer is on and one of
    `tensors` (None entries are skipped) holds a NaN."""
    if ACTIVE:
        _raise_on_nan(name, tensors)


class _NanCheckMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func not in _UNINITIALISED:
            _raise_on_nan(func, tree_leaves(out))
        return out


@contextlib.contextmanager
def debug_nans():
    """The sanitizer on for the body, off again when it returns or
    raises."""
    global ACTIVE
    with torch.autograd.detect_anomaly(check_nan=True), _NanCheckMode():
        ACTIVE = True
        try:
            yield
        finally:
            ACTIVE = False
