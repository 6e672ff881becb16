"""Frozen configs, field for field the JAX package's ViTConfig and
TrainConfig, and the per-epoch cosine learning-rate schedule.

The reference configures everything through argparse flags; the configs
mirror those flags with the same names, defaults and validation, so a config
means the same thing in both packages. Which TrainConfig fields the port's
training loop runs is decided by train.loop.fit, which refuses the others.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# PE strategy names, matching the reference CLI choices verbatim.
PE_CHOICES = ("none", "absolute", "relative", "polynomial", "rope-axial", "rope-mixed")

# How a PE strategy interacts with the model.
PE_KIND_NONE = "none"                 # no positional information
PE_KIND_EMBED_ADDITIVE = "additive"   # added to patch embeddings before blocks
PE_KIND_LOGITS_BIAS = "bias"          # [H, L, L] bias added to attention logits
PE_KIND_QK_ROTATION = "rotary"        # (cos, sin) rotation applied to q/k


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Model architecture config (reference VisionTransformer kwargs)."""

    img_size: int = 32
    patch_size: int = 4
    in_chans: int = 3
    num_classes: int = 10
    embed_dim: int = 192
    depth: int = 6
    num_heads: int = 6
    mlp_ratio: float = 4.0
    pos_encoding: str = "absolute"
    rope_theta: float = 100.0
    poly_degree: int = 3
    poly_shared_heads: bool = True
    # Regularization rates, validated as in the JAX package; they act in a
    # forward given a generator (train mode, models.vit.apply).
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    # Reproduce the reference RoPE-Mixed (head, position) memory
    # reinterpretation (pe/rope_mixed.py); off = clean einsum semantics.
    rope_mixed_compat_scramble: bool = False
    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default
    # "reference" = unfused torch attention, "flash" = the hand-written
    # attention kernel, "auto" = the kernel (models.vit._attention_impl).
    attention_impl: str = "auto"
    # Compute dtype for activations inside blocks ("float32" or "bfloat16").
    # Params and softmax statistics stay float32 either way.
    compute_dtype: str = "float32"
    # Training-only knobs, kept so configs compare equal across packages
    # (remat is not ported: a training forward with remat=True raises).
    remat: bool = False
    remat_policy: str = "full"

    def __post_init__(self):
        if self.pos_encoding not in PE_CHOICES:
            raise ValueError(
                f"Unknown positional encoding type: {self.pos_encoding}"
            )
        if self.img_size % self.patch_size != 0:
            raise ValueError("img_size must be divisible by patch_size")
        if self.embed_dim % self.num_heads != 0:
            raise ValueError("embed_dim must be divisible by num_heads")
        if self.pos_encoding in ("rope-axial", "rope-mixed"):
            # Axial RoPE splits head_dim into 4 bands (x/y × re/im).
            if self.head_dim % 4 != 0:
                raise ValueError(
                    "RoPE variants require head_dim divisible by 4; got "
                    f"head_dim={self.head_dim}"
                )
        if self.remat_policy not in ("full", "dots", "softmax"):
            raise ValueError(
                f"remat_policy must be 'full', 'dots' or 'softmax'; got "
                f"{self.remat_policy!r}")
        for name in ("drop_rate", "attn_drop_rate", "drop_path_rate"):
            rate = getattr(self, name)
            if not 0.0 <= rate < 1.0:
                raise ValueError(f"{name} must be in [0, 1); got {rate}")

    @property
    def has_dropout(self) -> bool:
        return (self.drop_rate > 0.0 or self.attn_drop_rate > 0.0
                or self.drop_path_rate > 0.0)

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def seq_len(self) -> int:
        """Token count including the cls token."""
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training loop config (the reference's train.py flags and main())."""

    dataset: str = "mnist"
    batch_size: int = 128
    epochs: int = 25
    lr: float = 1e-3
    weight_decay: float = 0.01
    log_dir: str = "logs"
    ckpt_dir: str = "checkpoints"
    data_dir: str = "./data"
    seed: int = 0
    # Extensions beyond the reference surface:
    synthetic_data: bool = False   # procedural dataset when real data absent
    profile_dir: str | None = None  # profiler trace output
    debug_nans: bool = False        # NaN sanitizer
    resume: bool = False            # continue from the last-state checkpoint
    save_last: bool = True          # write {..}_last.npz each epoch (resume)
    augment: bool = False           # random flip + 4px pad-and-crop
    steps_per_dispatch: int = 0     # train steps fused into one dispatch
    model_parallel: int = 1         # tensor parallelism degree
    zero1: bool = False             # optimizer moments sharded over data
    sequence_parallel: int = 1      # context parallelism degree
    pipeline_parallel: int = 1      # pipeline parallelism degree
    pp_microbatches: int = 0        # microbatches per device batch (0 = auto)
    # Gradient accumulation: each optimizer step accumulates this many
    # consecutive batches (effective batch = batch_size × grad_accum); the
    # update equals one step on the concatenated batch.
    grad_accum: int = 1
    q_chunk: int = 0                # bounded-program stepping (0 = off)
    kv_chunk: int = 0               # with q_chunk: key-axis segmentation

    def __post_init__(self):
        if self.dataset not in ("mnist", "cifar10"):
            raise ValueError(f"Unknown dataset: {self.dataset}")
        if self.model_parallel < 1:
            raise ValueError(
                f"model_parallel must be >= 1; got {self.model_parallel}")
        if self.sequence_parallel < 1:
            raise ValueError(
                f"sequence_parallel must be >= 1; got {self.sequence_parallel}")
        if self.pipeline_parallel < 1:
            raise ValueError(
                f"pipeline_parallel must be >= 1; got {self.pipeline_parallel}")
        if self.grad_accum < 1:
            raise ValueError(
                f"grad_accum must be >= 1; got {self.grad_accum}")
        if self.pp_microbatches < 0:
            raise ValueError(
                f"pp_microbatches must be >= 0 (0 = auto); got "
                f"{self.pp_microbatches}")
        if self.zero1 and self.pipeline_parallel > 1:
            raise ValueError(
                "zero1 is incompatible with pipeline parallelism > 1")
        if self.zero1 and self.sequence_parallel > 1 \
                and self.model_parallel > 1:
            raise ValueError(
                "zero1 composes with sequence_parallel OR model_parallel, "
                "not the 3-axis product")
        if self.q_chunk < 0:
            raise ValueError(f"q_chunk must be >= 0; got {self.q_chunk}")
        if self.kv_chunk < 0:
            raise ValueError(f"kv_chunk must be >= 0; got {self.kv_chunk}")
        if self.kv_chunk > 0 and self.q_chunk == 0:
            raise ValueError("kv_chunk requires q_chunk > 0 "
                             "(bounded-program stepping)")
        if self.q_chunk > 0 and (self.model_parallel > 1
                                 or self.pipeline_parallel > 1
                                 or self.zero1 or self.augment):
            raise ValueError(
                "q_chunk (bounded-program stepping) composes with data and "
                "sequence parallelism and with grad_accum but not with "
                "model/pipeline parallelism, zero1, or augment")
        if self.q_chunk > 0 and self.kv_chunk > 0 \
                and self.sequence_parallel > 1:
            raise ValueError(
                "kv_chunk does not compose with sequence_parallel")

    @property
    def in_chans(self) -> int:
        return 1 if self.dataset == "mnist" else 3

    @property
    def num_classes(self) -> int:
        return 10


def cosine_lr_by_epoch(base_lr: float, epochs: int, steps_per_epoch: int):
    """torch CosineAnnealingLR(T_max=epochs) stepped once per epoch: the LR
    used throughout epoch e (0-indexed) is base_lr * (1 + cos(pi * e /
    T_max)) / 2, eta_min=0. Returns a function of the global step giving a
    float32 scalar, computed in float32 as the JAX package computes it."""
    half_lr = np.float32(base_lr * 0.5)
    pi = np.float32(math.pi)

    def schedule(step):
        epoch = np.float32(min(int(step) // steps_per_epoch, epochs))
        return half_lr * (np.float32(1.0)
                          + np.cos(pi * epoch / np.float32(epochs)))

    return schedule
