"""The block's plain layers, shared by models.vit, train/bounded.py and
ops/block_vjp.py, and the dropout masks of models.vit and
ops/reference_attention."""

from __future__ import annotations

import torch


def layer_norm(x, weight, bias, eps):
    """torch nn.LayerNorm semantics (biased variance), stats in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(x.dtype)


def linear(x, weight, bias=None):
    """x [..., in] @ torch-layout weight [out, in] (+ bias)."""
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def keep_mask(shape, keep, generator):
    """Bernoulli(keep) mask of `shape` drawn from `generator` on its device:
    u < keep for u uniform in [0, 1), as jax.random.bernoulli draws it.
    Every dropout mask of the port is drawn here, in the forward's order."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < keep


def drop(x, mask, keep):
    """Inverted dropout: x / keep where mask holds, else 0."""
    return torch.where(mask, x / keep, torch.zeros_like(x))
