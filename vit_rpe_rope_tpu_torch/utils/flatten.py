"""Flat parameter vector <-> named dict of tensors.

The JAX package keeps its optimizer moments on disk as ONE contiguous f32
vector per moment, in the key order of a template dict (the depth-stacked
params, models.vit.stack_block_params); this class fixes that order so the
port reads and writes the same `_last.npz` files. Moments are elementwise
per-parameter state, so the re-layout is exact.
"""

from __future__ import annotations

import torch


class Flattener:
    def __init__(self, template: dict):
        self.keys = list(template)
        self.shapes = [tuple(template[k].shape) for k in self.keys]
        self.sizes = [int(template[k].numel()) for k in self.keys]
        self.offsets = []
        off = 0
        for s in self.sizes:
            self.offsets.append(off)
            off += s
        self.total = off
        self.dtypes = [template[k].dtype for k in self.keys]

    def flatten(self, tree: dict) -> torch.Tensor:
        """dict -> [total] f32 vector (order fixed by the template)."""
        return torch.cat([tree[k].reshape(-1).float() for k in self.keys])

    def unflatten(self, vec: torch.Tensor) -> dict:
        out = {}
        for k, shape, size, off, dt in zip(self.keys, self.shapes, self.sizes,
                                           self.offsets, self.dtypes):
            out[k] = vec[off:off + size].reshape(shape).to(dt)
        return out
