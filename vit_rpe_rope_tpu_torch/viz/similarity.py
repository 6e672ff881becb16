"""PE similarity analytics: the reference visualizer's per-method similarity
matrices.

Each function returns (similarity [S, S] float32 numpy array, grid_size):

* absolute — cosine similarity of the learned embeddings (the cls token
  receives no position, so rows 0..S-1 of the table);
* relative / polynomial — the attention bias averaged over heads, cls
  row/col stripped, divided by its largest magnitude into [-1, 1];
* rope-axial / rope-mixed — an all-ones probe rotated to every position,
  cosine similarity between positions (mixed selects one head).

The biases and rotation tables come from the port's PE functions on
`device` (default: the CUDA device; raises when there is none unless
device="cpu"); the float64 cosine similarity and the normalisation run in
numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.pe import polynomial, relative, rope_axial, rope_mixed
from vit_rpe_rope_tpu_torch.utils.device import resolve_device


def _cfg(grid_size, num_heads, head_dim=32, poly_degree=3,
         poly_shared=True, rope_theta=100.0, pe="none", compat=False):
    return ViTConfig(
        img_size=grid_size * 4, patch_size=4, embed_dim=num_heads * head_dim,
        num_heads=num_heads, depth=1, pos_encoding=pe,
        poly_degree=poly_degree, poly_shared_heads=poly_shared,
        rope_theta=rope_theta, rope_mixed_compat_scramble=compat)


def _on(array, device):
    return torch.as_tensor(np.asarray(array, np.float32),
                           device=resolve_device(device))


def _numpy(t):
    return t.detach().cpu().numpy()


def _cosine_sim(x):
    x = np.asarray(x, np.float64)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    xn = x / np.maximum(norms, 1e-12)
    return (xn @ xn.T).astype(np.float32)


def absolute_similarity(table, grid_size):
    """table: [1, max_len, d] learned APE; no device work."""
    s = grid_size * grid_size
    emb = np.asarray(table)[0, :s, :]
    return _cosine_sim(emb), grid_size


def _bias_similarity(bias):
    bias = np.asarray(bias, np.float32)
    if bias.ndim == 3:
        bias = bias.mean(axis=0)
    seq = bias.shape[0] - 1
    grid = int(np.sqrt(seq))
    bias = bias[1:, 1:]  # strip cls row/col
    peak = np.abs(bias).max()
    if peak > 0:
        bias = bias / peak
    return bias, grid


def relative_similarity(table, grid_size, device=None):
    del grid_size  # the grid comes from the table itself
    table = np.asarray(table)
    seq_len = (table.shape[1] + 1) // 2
    cfg = _cfg(int(np.sqrt(seq_len - 1)), table.shape[0], pe="relative")
    bias = relative.attn_bias(
        {"pos_embed.relative_position_bias_table": _on(table, device)}, cfg)
    return _bias_similarity(_numpy(bias))


def polynomial_similarity(coeff, grid_size, num_heads=6, device=None):
    coeff = np.asarray(coeff)
    shared = coeff.ndim == 1
    heads = num_heads if shared else coeff.shape[0]
    cfg = _cfg(grid_size, heads, poly_degree=coeff.shape[-1] - 1,
               poly_shared=shared, pe="polynomial")
    bias = polynomial.attn_bias({"pos_embed.coefficients": _on(coeff, device)},
                                cfg)
    return _bias_similarity(_numpy(bias))


def _rotated_ones(cos, sin):
    """Rotate the all-ones probe to every position: [S, D] given [S, D/2]."""
    ones = np.ones_like(cos)
    return np.concatenate([ones * cos - ones * sin, ones * sin + ones * cos],
                          axis=-1)


def rope_axial_similarity(inv_freq, grid_size, rope_theta=100.0, device=None):
    head_dim = 4 * int(np.asarray(inv_freq).shape[0])
    cfg = _cfg(grid_size, 1, head_dim=head_dim, rope_theta=rope_theta,
               pe="rope-axial")
    cos, sin = rope_axial.freqs_cis({}, cfg, device=resolve_device(device))
    return _cosine_sim(_rotated_ones(_numpy(cos), _numpy(sin))), grid_size


def rope_mixed_similarity(freqs, grid_size, head_idx=0, compat_scramble=False,
                          device=None):
    """compat_scramble reproduces the reference's (head, position) memory
    reinterpretation: needed for reference-trained or compat-trained
    checkpoints."""
    freqs = np.asarray(freqs)
    num_heads, head_dim = freqs.shape[1], 2 * freqs.shape[2]
    cfg = _cfg(grid_size, num_heads, head_dim=head_dim, pe="rope-mixed",
               compat=compat_scramble)
    cos, sin = rope_mixed.freqs_cis({"pos_embed.freqs": _on(freqs, device)},
                                    cfg)
    rot = _rotated_ones(_numpy(cos[head_idx]), _numpy(sin[head_idx]))
    return _cosine_sim(rot), grid_size


def similarity_for(pe_model, grid_size=None, head_idx=0, num_heads=6,
                   rope_theta=100.0, compat_scramble=False, device=None):
    """Dispatch on an introspect.PEModel. The rope modes are drawn on at
    most an 8 x 8 grid, as the reference draws them."""
    g = grid_size or pe_model.grid_size
    m, p = pe_model.method, pe_model.params
    if m == "absolute":
        return absolute_similarity(p["pos_embed.pos_embed"], g)
    if m == "relative":
        return relative_similarity(
            p["pos_embed.relative_position_bias_table"], g, device=device)
    if m == "polynomial":
        return polynomial_similarity(
            p["pos_embed.coefficients"], g,
            num_heads=pe_model.num_heads or num_heads, device=device)
    if m == "rope-axial":
        return rope_axial_similarity(p["pos_embed.inv_freq"], min(g, 8),
                                     rope_theta=rope_theta, device=device)
    if m == "rope-mixed":
        return rope_mixed_similarity(
            p["pos_embed.freqs"], min(g, 8), head_idx=head_idx,
            compat_scramble=compat_scramble, device=device)
    raise ValueError(f"No similarity defined for method {m}")


def block_matrix(sim, grid_size):
    """Compact full-matrix view: canvas [g², g²] where block (i, j) holds the
    similarity map of position (i, j) against all positions, reshaped
    [g, g]."""
    g = grid_size
    canvas = np.zeros((g * g, g * g), np.float32)
    for i in range(g):
        for j in range(g):
            p = i * g + j
            canvas[i * g:(i + 1) * g, j * g:(j + 1) * g] = sim[p].reshape(g, g)
    return canvas
