"""Params and optimizer state of the JAX package -> the port's.

The JAX package keeps params in a flat dict under the reference's keys and
torch layouts already, so converting is keys, aliases, buffers and dtype.
Its AdamW moments are dicts of the same keys (optax, make_fused_adamw)."""

from __future__ import annotations

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.models import vit


def params_from_jax(np_params: dict, cfg) -> dict:
    """{key: numpy array} (the JAX params, moved to the host) -> the complete
    state_dict of models.vit.VisionTransformer (CPU tensors): float32
    params, the PE buffers and the per-block alias keys."""
    params = {}
    for k, v in np_params.items():
        if ".attn.pos_encoding." in k:
            continue  # aliases are rebuilt from the canonical keys
        v = np.array(v)
        if np.issubdtype(v.dtype, np.floating):
            v = v.astype(np.float32)
        params[k] = torch.from_numpy(v)
    return vit.full_state(params, cfg)


def adamw_state_from_jax(mu: dict, nu: dict, count) -> tuple:
    """JAX AdamW moments ({key: array} mu and nu, moved to the host) and step
    count -> the state of the port's ops.fused_adamw.make_fused_adamw:
    (mu, nu, count) with float32 CPU tensors and an int."""
    def to_torch(tree):
        return {k: torch.from_numpy(np.array(v, np.float32))
                for k, v in tree.items()}

    return to_torch(mu), to_torch(nu), int(np.asarray(count))


def qparams_from_jax(np_qparams: dict, cfg) -> dict:
    """The JAX package's quant.quantize_params output ({key: numpy array},
    moved to the host) -> the port's qparams (CPU tensors): the int8
    `{key}:q8`, float32 `{key}:scale` and scalar `{key}:act_scale` entries
    with their dtypes kept, every other key as params_from_jax converts
    it (no buffers or alias keys are added)."""
    quantized = {k: torch.from_numpy(np.array(v))
                 for k, v in np_qparams.items() if ":" in k}
    rest = params_from_jax({k: v for k, v in np_qparams.items()
                            if ":" not in k}, cfg)
    return {**{k: v for k, v in rest.items() if k in np_qparams},
            **quantized}
