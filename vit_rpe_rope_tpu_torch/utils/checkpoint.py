"""Checkpoints with the reference's flat key contract.

A checkpoint is one flat state dict under the reference's state_dict keys:
an .npz (the JAX package's format) or a torch .pth (the reference's). Both
load here; `save` writes .npz with the per-block alias keys, so the key set
equals the reference's.

The resumable train state (`save_train_state` / `load_train_state`) is the
JAX package's `_last.npz` format: the params, the optimizer state's leaves
as "__opt.{i}", then "__epoch" and "__best_acc". Files written by either
package resume in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def save(path: str, params: dict, buffers: dict | None = None,
         aliases: dict | None = None) -> str:
    """Write params (+ buffers, + {alias_key: canonical_key} duplicates) as
    one flat .npz. Returns the path written (suffix normalized to .npz)."""
    if path.endswith(".pth"):
        path = path[:-4] + ".npz"
    elif not path.endswith(".npz"):
        path = path + ".npz"
    state = {k: _to_numpy(v) for k, v in params.items()}
    for k, v in (buffers or {}).items():
        state[k] = _to_numpy(v)
    for alias, canonical in (aliases or {}).items():
        if canonical in state:
            state[alias] = state[canonical]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **state)
    return path


def _to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def load_state(path: str) -> dict:
    """Load a flat state dict (numpy arrays) from .npz or torch .pth."""
    if path.endswith(".pth") or path.endswith(".pt"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return {k: v.detach().cpu().numpy() for k, v in sd.items()}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def split_state(state: dict, buffer_keys) -> tuple[dict, dict]:
    """Flat state dict -> (trainable params, buffers) as CPU tensors, given
    the architecture's buffer keys (models.vit.buffers(cfg)). Drops the
    shared-PE alias duplicates and "__"-prefixed extras."""
    buffer_keys = set(buffer_keys)
    params = {k: torch.from_numpy(np.array(v)) for k, v in state.items()
              if k not in buffer_keys and not k.startswith("__")
              and ".attn.pos_encoding." not in k}
    bufs = {k: torch.from_numpy(np.array(v)) for k, v in state.items()
            if k in buffer_keys}
    return params, bufs


def save_train_state(path: str, params: dict, opt_leaves, epoch: int,
                     best_acc: float) -> str:
    """Full resumable train state: params + the optimizer state's leaves (in
    the JAX package's order, see train.loop) + loop progress."""
    state = {k: _to_numpy(v) for k, v in params.items()}
    for i, leaf in enumerate(opt_leaves):
        state[f"__opt.{i}"] = _to_numpy(leaf)
    state["__epoch"] = np.asarray(epoch, np.int64)
    state["__best_acc"] = np.asarray(best_acc, np.float64)
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **state)
    return path


def load_train_state(path: str, n_opt_leaves: int):
    """-> (params as CPU tensors, optimizer leaves as numpy arrays,
    next_epoch, best_acc). Raises when the file stores another number of
    optimizer leaves than the caller's optimizer has."""
    state = load_state(path)
    params = {k: torch.from_numpy(np.array(v)) for k, v in state.items()
              if not k.startswith("__")}
    n_stored = sum(1 for k in state if k.startswith("__opt."))
    if n_stored != n_opt_leaves:
        raise ValueError(
            f"{path} stores {n_stored} optimizer leaves but the current "
            f"optimizer expects {n_opt_leaves} (a file of another optimizer "
            f"or format); delete the stale _last.npz (or retrain) to proceed")
    leaves = [state[f"__opt.{i}"] for i in range(n_opt_leaves)]
    return (params, leaves, int(state["__epoch"]) + 1,
            float(state["__best_acc"]))
