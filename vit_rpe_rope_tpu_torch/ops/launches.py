"""The kernels' launch counts (the LAUNCHES* integers of the wrappers'
modules, and quant's count of torch._int_mm calls) read and advanced
together.

A wrapper adds one to its count where it launches its kernel. Inside a CUDA
graph capture that launch is recorded, not run, and every replay runs it
again without the wrapper: the graph driver (train/train_step) takes the
counts a capture added back off (`counts`, `add`) and adds them again per
replay, so that the counts stay those of launches that reached the card.
"""

from __future__ import annotations

import importlib

MODULES = ("vit_rpe_rope_tpu_torch.ops.flash_attention",
           "vit_rpe_rope_tpu_torch.ops.fused_adamw",
           "vit_rpe_rope_tpu_torch.ops.block_fused",
           "vit_rpe_rope_tpu_torch.quant")


def counts() -> dict:
    """{(module, name): count} of every LAUNCHES* count."""
    out = {}
    for name in MODULES:
        mod = importlib.import_module(name)
        for attr in dir(mod):
            if attr.startswith("LAUNCHES"):
                out[name, attr] = getattr(mod, attr)
    return out


def since(before: dict) -> dict:
    """The counts added since `before` (a `counts()`), nonzero only."""
    now = counts()
    return {key: now[key] - before.get(key, 0) for key in now
            if now[key] != before.get(key, 0)}


def add(delta: dict, times: int = 1) -> None:
    """Add `times` x delta to the counts."""
    for (name, attr), n in delta.items():
        mod = importlib.import_module(name)
        setattr(mod, attr, getattr(mod, attr) + times * n)
