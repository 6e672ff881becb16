"""RoPE frequency / FFT analytics: the reference rope visualizer's analysis
core.

create_input_positions builds a binary pattern grid; apply_rope_and_fft masks
the per-position RoPE phases with the pattern, averages the complex phasor
over the frequency dim, and returns (log1p |fftshift(FFT2)|, |IFFT2|
reconstruction). The cos/sin tables come from the port's PE functions on
`device` (default: the CUDA device; raises when there is none unless
device="cpu"); the FFT runs in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.pe import rope_axial, rope_mixed
from vit_rpe_rope_tpu_torch.utils.device import resolve_device


def create_input_positions(pattern: str, grid_size: int, custom_coords=None):
    pos = np.zeros((grid_size, grid_size), np.float32)
    if pattern == "single":
        pos[grid_size // 2, grid_size // 4] = 1.0
    elif pattern == "double":
        pos[grid_size // 4, grid_size // 4] = 1.0
        pos[grid_size // 4, 3 * grid_size // 4] = 1.0
    elif pattern == "corner":
        pos[0, 0] = 1.0
    elif pattern == "diagonal":
        for i in range(grid_size):
            pos[i, i] = 1.0
    elif pattern == "custom" and custom_coords:
        coords = list(map(int, custom_coords))
        for i in range(0, len(coords) - 1, 2):
            r, c = coords[i], coords[i + 1]
            if 0 <= r < grid_size and 0 <= c < grid_size:
                pos[r, c] = 1.0
    return pos


def _numpy(cos, sin):
    return cos.cpu().numpy(), sin.cpu().numpy()


def axial_freqs(head_dim: int, theta: float, grid_size: int, device=None):
    """(cos, sin) [S, D/2] numpy arrays."""
    cfg = ViTConfig(img_size=grid_size * 4, patch_size=4, embed_dim=head_dim,
                    num_heads=1, depth=1, pos_encoding="rope-axial",
                    rope_theta=theta)
    return _numpy(*rope_axial.freqs_cis({}, cfg,
                                        device=resolve_device(device)))


def mixed_freqs(head_dim: int, num_heads: int, theta: float, grid_size: int,
                freqs_param=None, seed: int = 0, compat_scramble=False,
                device=None):
    """(cos, sin) [H, S, D/2] numpy arrays; random init at `theta` when no
    trained parameter is supplied. compat_scramble reproduces the
    reference's (head, position) memory reinterpretation.

    The random init draws from a torch.Generator seeded with `seed`
    (pe/rope_mixed.init_freqs), where the JAX package draws from
    jax.random.PRNGKey(seed): the two packages' untrained frequencies
    differ by design; a trained parameter gives the same tables."""
    device = resolve_device(device)
    cfg = ViTConfig(img_size=grid_size * 4, patch_size=4,
                    embed_dim=head_dim * num_heads, num_heads=num_heads,
                    depth=1, pos_encoding="rope-mixed", rope_theta=theta,
                    rope_mixed_compat_scramble=compat_scramble)
    if freqs_param is None:
        freqs_param = rope_mixed.init_freqs(
            torch.Generator().manual_seed(seed), head_dim, num_heads, theta)
    freqs = torch.as_tensor(np.asarray(freqs_param, np.float32),
                            device=device)
    return _numpy(*rope_mixed.freqs_cis({"pos_embed.freqs": freqs}, cfg))


def apply_rope_and_fft(pos_grid, cos, sin, head_idx: int = 0):
    """pos_grid [g, g]; cos/sin [S, D/2] (axial) or [H, S, D/2] (mixed).
    Returns (log-magnitude spectrum [g, g], |IFFT| reconstruction [g, g])."""
    g = pos_grid.shape[0]
    seq = np.asarray(pos_grid, np.float32).reshape(-1)  # [S]
    if cos.ndim == 3:
        cos, sin = cos[head_idx], sin[head_idx]
    cos_masked = seq[:, None] * cos
    sin_masked = seq[:, None] * sin
    complex_vals = cos_masked + 1j * sin_masked
    complex_grid = complex_vals.mean(axis=-1).reshape(g, g)
    fft = np.fft.fft2(complex_grid)
    magnitude_log = np.log1p(np.abs(np.fft.fftshift(fft)))
    reconstructed = np.abs(np.fft.ifft2(fft))
    return magnitude_log, reconstructed
