"""Unfused multi-head attention — the trusted oracle, and the route of
attention-prob dropout (the mask lives on the materialized probabilities).

PE plugs in through the reference's three modes: q/k rotation (cos/sin
supplied, cls token excluded), an additive [H, N, N] logits bias, or
neither. Logits and softmax statistics are float32 whatever the input dtype.
"""

from __future__ import annotations

import torch

from vit_rpe_rope_tpu_torch.ops import layers
from vit_rpe_rope_tpu_torch.ops.rotary import apply_rotary_emb


def rotate_qk_skip_cls(q, k, freqs_cis):
    """Rotate q/k [B, H, N, D] on tokens 1..N-1, leaving the cls token
    (index 0) unrotated."""
    cos, sin = freqs_cis
    q_rot, k_rot = apply_rotary_emb(q[:, :, 1:], k[:, :, 1:], cos, sin)
    q = torch.cat([q[:, :, :1], q_rot], dim=2)
    k = torch.cat([k[:, :, :1], k_rot], dim=2)
    return q, k


def attention(q, k, v, scale, bias=None, freqs_cis=None, dropout_rate=0.0,
              generator=None):
    """Scaled dot-product MHA over [B, H, N, D] inputs -> [B, H, N, D].

    bias: optional [H, N, N] additive logits bias (relative / polynomial).
    freqs_cis: optional (cos, sin) for rotary PE (axial / mixed).
    dropout_rate / generator: train-mode inverted dropout on the softmax
    probabilities (the reference's Attention.attn_drop), its mask drawn from
    `generator`; off when the rate is 0 or there is no generator.
    """
    if freqs_cis is not None:
        q, k = rotate_qk_skip_cls(q, k, freqs_cis)
    # Products of the input dtype accumulated in f32 (exact for bf16 inputs).
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias[None].float()
    # The JAX oracle's one-pass normalization: probs = exp(logits - lse).
    m = logits.amax(dim=-1, keepdim=True)
    lse = m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
    probs = torch.exp(logits - lse)
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        probs = layers.drop(probs, layers.keep_mask(probs.shape, keep,
                                                    generator), keep)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)
