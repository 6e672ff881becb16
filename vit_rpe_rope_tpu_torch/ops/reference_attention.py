"""Unfused multi-head attention — the trusted oracle, and the route of
attention-prob dropout (the mask lives on the materialized probabilities).

PE plugs in through the reference's three modes: q/k rotation (cos/sin
supplied, cls token excluded), an additive [H, N, N] logits bias, or
neither. Logits and softmax statistics are float32 whatever the input dtype.

The probabilities carry the name "attn_softmax" (ATTN_SOFTMAX, the JAX
package's checkpoint_name): inside not_saving(ATTN_SOFTMAX), where the
"softmax" remat policy of models.vit runs a block, they are not held for
the backward; the shifted logits they are computed from are held instead
and the probabilities recomputed from them (_ProbsFromShifted).
"""

from __future__ import annotations

import contextlib

import torch

from vit_rpe_rope_tpu_torch.ops import layers
from vit_rpe_rope_tpu_torch.ops.rotary import apply_rotary_emb

ATTN_SOFTMAX = "attn_softmax"
_NOT_SAVED: list = []  # names the active remat policy does not save


@contextlib.contextmanager
def not_saving(name: str):
    """Inside, the value named `name` is recomputed in the backward from
    its input rather than held (a JAX policy that saves every value but
    checkpoint_name(x, name))."""
    _NOT_SAVED.append(name)
    try:
        yield
    finally:
        _NOT_SAVED.pop()


def saves(name: str) -> bool:
    return name not in _NOT_SAVED


def _probs_times_v(shifted, v, mask, keep):
    """probs = exp(shifted), dropped where mask is False (None: no
    dropout), times v: products of v's dtype accumulated in float32."""
    probs = torch.exp(shifted)
    if mask is not None:
        probs = layers.drop(probs, mask, keep)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


class _ProbsFromShifted(torch.autograd.Function):
    """_probs_times_v holding shifted, v and the mask for the backward, not
    the probabilities: the backward recomputes them from shifted and
    differentiates the same operations, so the gradients are those of
    the plain operations bit for bit."""

    @staticmethod
    def forward(ctx, shifted, v, mask, keep):
        # A strided view of v would hold the whole qkv product; the plain
        # product holds only the contiguous copy of v it makes.
        v = v.contiguous()
        ctx.save_for_backward(shifted, v, mask)
        ctx.keep = keep
        return _probs_times_v(shifted, v, mask, keep)

    @staticmethod
    def backward(ctx, g):
        shifted, v, mask = ctx.saved_tensors
        wanted = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(want)
                      for t, want in zip((shifted, v), wanted)]
            out = _probs_times_v(*inputs, mask, ctx.keep)
        grads = iter(torch.autograd.grad(
            out, [t for t in inputs if t.requires_grad], g))
        return (*(next(grads) if want else None for want in wanted),
                None, None)


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
    shifted = logits - lse
    mask, keep = None, 1.0
    if dropout_rate > 0.0 and generator is not None:
        keep = 1.0 - dropout_rate
        mask = layers.keep_mask(shifted.shape, keep, generator)
    if saves(ATTN_SOFTMAX) or not torch.is_grad_enabled():
        return _probs_times_v(shifted, v, mask, keep)
    return _ProbsFromShifted.apply(shifted, v, mask, keep)
