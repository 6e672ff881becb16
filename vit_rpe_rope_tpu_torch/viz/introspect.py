"""Checkpoint introspection: rebuild a ViTConfig, or the PE state the
visualizers read, from a saved state dict by shape-sniffing the reference
key contract.

* embed_dim from patch_embed.weight [E, C, P, P] or *.qkv.weight [3E, E];
* per-method grid/head inference: relative table [H, 2L-1] -> L; polynomial
  per-head coefficients [H, deg+1]; rope-axial inv_freq (head_dim = 4·len);
  rope-mixed freqs [2, H, head_dim/2];
* the reference hard-codes grid_size 8 whenever the checkpoint filename
  contains 'cifar10' — preserved.

Reads .npz checkpoints and reference torch .pth ones
(utils.checkpoint.load_state handles each).
"""

from __future__ import annotations

import math
import os

import numpy as np

from vit_rpe_rope_tpu_torch.utils import checkpoint


class PEModel:
    """Introspected PE state: method, PE params (pos_embed.* keys, numpy
    arrays) and the architecture facts inferred from shapes."""

    def __init__(self, method, params, embed_dim, num_heads, head_dim,
                 grid_size):
        self.method = method
        self.params = params
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = head_dim
        self.grid_size = grid_size


def infer_embed_dim(state: dict) -> int | None:
    if "patch_embed.weight" in state:
        return int(state["patch_embed.weight"].shape[0])
    for k, v in state.items():
        if k.endswith(".qkv.weight"):
            return int(v.shape[1])
        if k.endswith(".qkv.bias"):
            return int(v.shape[0]) // 3
    return None


def grid_from_filename(path: str, default: int) -> int:
    """Reference quirk: 'cifar10' in the checkpoint name (case-insensitive)
    forces grid 8."""
    if "cifar10" in os.path.basename(path).lower():
        return 8
    return default


def _method_from_filename(path: str):
    """PE method named in a '{dataset}_{method}_best' checkpoint filename,
    or None; used only when the checkpoint carries no pos_embed.* key."""
    name = os.path.basename(path)
    # Longest-match first so 'rope-axial' never matches bare 'rope'.
    for m in ("rope-axial", "rope-mixed", "polynomial", "relative",
              "absolute", "none"):
        if f"_{m}_" in name or name.startswith(f"{m}_"):
            return m
    return None


def load_pe_model(path: str, method: str, grid_size: int = 14,
                  num_heads: int = 6) -> PEModel:
    """The PE state of checkpoint `path` read as a `method` model. Raises a
    ValueError naming the pos_embed keys present when the checkpoint lacks
    the method's key."""
    state = checkpoint.load_state(path)
    pe_params = {k: np.asarray(v) for k, v in state.items()
                 if k.startswith("pos_embed.")}
    sniffed_dim = infer_embed_dim(state)
    embed_dim = sniffed_dim or 192
    grid = grid_from_filename(path, grid_size)
    head_dim = embed_dim // num_heads

    required = {
        "absolute": "pos_embed.pos_embed",
        "relative": "pos_embed.relative_position_bias_table",
        "polynomial": "pos_embed.coefficients",
        "rope-axial": "pos_embed.inv_freq",
        "rope-mixed": "pos_embed.freqs",
    }
    need = required.get(method)
    if need is not None and need not in pe_params:
        guesses = [m for m, k in required.items() if k in pe_params]
        raise ValueError(
            f"checkpoint {path} has no '{need}' — it does not look like a "
            f"'{method}' model (pos_embed keys present: "
            f"{sorted(pe_params) or 'none'}"
            + (f"; looks like {guesses}" if guesses else "") + ")")

    if method == "relative":
        table = pe_params["pos_embed.relative_position_bias_table"]
        num_heads = int(table.shape[0])
        seq_len = (int(table.shape[1]) + 1) // 2  # 2L-1 -> L
        g = int(math.isqrt(seq_len - 1))
        if g * g == seq_len - 1:
            grid = g
        head_dim = embed_dim // num_heads
    elif method == "polynomial":
        coeff = pe_params["pos_embed.coefficients"]
        if coeff.ndim == 2:
            num_heads = int(coeff.shape[0])
        head_dim = embed_dim // num_heads
    elif method == "rope-axial":
        inv_freq = pe_params["pos_embed.inv_freq"]
        head_dim = 4 * int(inv_freq.shape[0])
        if sniffed_dim is None:
            # A PE-only checkpoint (no patch_embed / qkv keys): the width
            # is head_dim * num_heads (inv_freq has head_dim // 4 entries).
            embed_dim = head_dim * num_heads
    elif method == "rope-mixed":
        freqs = pe_params["pos_embed.freqs"]
        num_heads = int(freqs.shape[1])
        head_dim = 2 * int(freqs.shape[2])
        if sniffed_dim is None:
            # As for rope-axial; freqs is [2, H, head_dim / 2].
            embed_dim = head_dim * num_heads
    elif method == "absolute":
        pass  # the max_len table carries no grid information
    else:
        raise ValueError(f"Unsupported model_config: {method}")
    return PEModel(method, pe_params, embed_dim, num_heads, head_dim, grid)


def infer_vit_config(state: dict, path: str = "", num_heads: int = 6,
                     grid_size: int | None = None,
                     num_classes: int | None = None):
    """Reconstruct a full ViTConfig from a checkpoint's shapes alone:
    patch_embed.weight [E, C, P, P] fixes embed_dim/in_chans/patch_size,
    blocks.{i}.* fixes depth, head.weight fixes num_classes, and the
    pos_embed.* key present identifies the PE method plus (where its shapes
    encode them) num_heads and the patch grid. `num_heads`/`grid_size` are
    the fallbacks for methods whose checkpoints don't pin them
    (none/absolute/rope/shared-poly). Grid precedence: checkpoint shapes >
    explicit grid_size > the cifar10-filename quirk (grid 8) > default 8.
    """
    from vit_rpe_rope_tpu_torch.configs import ViTConfig

    pw = state.get("patch_embed.weight")
    if pw is None:
        raise ValueError("checkpoint has no patch_embed.weight — cannot "
                         "infer the architecture")
    embed_dim, in_chans, patch_size = (int(pw.shape[0]), int(pw.shape[1]),
                                       int(pw.shape[2]))
    depth = 1 + max((int(k.split(".")[1]) for k in state
                     if k.startswith("blocks.")), default=-1)
    if depth == 0:
        raise ValueError("checkpoint has no blocks.* keys")
    if num_classes is None:
        hw = state.get("head.weight")
        num_classes = int(hw.shape[0]) if hw is not None else 10

    method_by_key = {
        "pos_embed.pos_embed": "absolute",
        "pos_embed.relative_position_bias_table": "relative",
        "pos_embed.coefficients": "polynomial",
        "pos_embed.inv_freq": "rope-axial",
        "pos_embed.freqs": "rope-mixed",
    }
    methods = [m for k, m in method_by_key.items() if k in state]
    if methods:
        method = methods[0]
    else:
        # PE buffers stripped: fall back to the method named in the
        # filename (dimensions come from patch_embed/blocks already).
        method = _method_from_filename(path) or "none"

    grid = grid_size if grid_size is not None else grid_from_filename(path, 8)
    kw = {}
    if method == "relative" and \
            "pos_embed.relative_position_bias_table" in state:
        table = state["pos_embed.relative_position_bias_table"]
        num_heads = int(table.shape[0])
        seq_len = (int(table.shape[1]) + 1) // 2
        g = int(math.isqrt(seq_len - 1))
        if g * g == seq_len - 1:
            grid = g
    elif method == "polynomial" and "pos_embed.coefficients" in state:
        coeff = state["pos_embed.coefficients"]
        if coeff.ndim == 2:
            num_heads = int(coeff.shape[0])
        kw = dict(poly_degree=int(coeff.shape[-1]) - 1,
                  poly_shared_heads=coeff.ndim == 1)
    elif method == "rope-axial" and "pos_embed.inv_freq" in state:
        inv_freq = np.asarray(state["pos_embed.inv_freq"], np.float64)
        half = int(inv_freq.shape[0])
        num_heads = embed_dim // (4 * half)
        if half > 1 and inv_freq[1] > 0:
            # inv_freq[i] = theta^(-i/half): recover theta (to float32
            # rounding of the saved buffer).
            kw = dict(rope_theta=float(inv_freq[1] ** -half))
    elif method == "rope-mixed" and "pos_embed.freqs" in state:
        num_heads = int(state["pos_embed.freqs"].shape[1])

    return ViTConfig(img_size=grid * patch_size, patch_size=patch_size,
                     in_chans=in_chans, num_classes=num_classes,
                     embed_dim=embed_dim, depth=depth, num_heads=num_heads,
                     pos_encoding=method, **kw)


def discover_checkpoints(ckpt_dir: str, methods) -> dict:
    """{method: path} for every {ckpt_dir}/cifar10_{method}_best.{npz,pth}
    that exists."""
    found = {}
    for m in methods:
        p = checkpoint.find_checkpoint(ckpt_dir, "cifar10", m)
        if p:
            found[m] = p
    return found
