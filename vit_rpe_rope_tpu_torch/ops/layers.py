"""The block's plain layers, shared by models.vit, train/bounded.py and
ops/block_vjp.py."""

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
