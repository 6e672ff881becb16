"""Vision Transformer: flat params dict + functional forward, and the
nn.Module that holds the params under the reference's state_dict keys.

The functional half mirrors the JAX package's models/vit.py name for name:

* params are a FLAT dict keyed by the reference's state_dict names, in torch
  layouts (Linear weights [out, in], conv weight [E, C, P, P]);
* patch embedding is a reshape + one matmul (a conv with kernel == stride is
  a linear map per patch) — no cuDNN conv;
* the PE bias / rope cos-sin are generated ONCE per forward and reused by
  every block.

VisionTransformer is the nn.Module view of the same params: its state_dict
holds the reference's key set, including the blocks.{i}.attn.pos_encoding.*
aliases (the one shared PE module is attached to every block's attention,
as in the reference), so reference .pth files and the JAX package's
checkpoints load into it strictly. Its forward is `apply`.

Inputs are NHWC, as in the JAX package. `apply` is differentiable end to end
(the attention kernels carry an autograd Function). Train mode is an
explicit torch.Generator (the JAX package's `rng`): with one, the config's
dropout, attention-prob dropout and drop-path rates apply, their masks drawn
from it in the forward's order; without one the forward is deterministic.
With cfg.remat each block is rematerialized under one of the JAX package's
three policies (`remat_block_fn`). With a
tensor-parallel mesh the same forward runs on one rank's shard of the heads
and MLP rows (parallel/tensor_parallel.py), with Megatron's f and g around
each block half.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as torch_checkpoint

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import (
    PE_KIND_EMBED_ADDITIVE,
    PE_KIND_LOGITS_BIAS,
    PE_KIND_QK_ROTATION,
    ViTConfig,
)
from vit_rpe_rope_tpu_torch.ops import block_vjp
from vit_rpe_rope_tpu_torch.ops import flash_attention, layers
from vit_rpe_rope_tpu_torch.ops import reference_attention
from vit_rpe_rope_tpu_torch.ops.layers import layer_norm, linear
from vit_rpe_rope_tpu_torch.parallel import distributed
from vit_rpe_rope_tpu_torch.utils.device import resolve_device
from vit_rpe_rope_tpu_torch.utils.initializers import kaiming_normal_fan_out, trunc_normal

BLOCK_PARAM_NAMES = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.proj.weight",
    "attn.proj.bias", "norm2.weight", "norm2.bias", "mlp.fc1.weight",
    "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias",
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# ---------------------------------------------------------------------------
# Parameter initialization
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ViTConfig,
                device=None) -> dict:
    """Flat params dict, reference state_dict key names, torch layouts.

    trunc_normal(std=0.02) for Linear weights and PE tables; zeros for all
    biases and the cls token; kaiming fan_out for the patch-embed conv.
    Drawn on the CPU from `generator` (the same numbers on every device),
    then moved to `device` (default: the CUDA device)."""
    device = resolve_device(device)
    e, c, p = cfg.embed_dim, cfg.in_chans, cfg.patch_size
    hid = cfg.mlp_hidden_dim
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32)  # noqa: E731
    params = {
        "cls_token": zeros(1, 1, e),
        "patch_embed.weight": kaiming_normal_fan_out(generator, (e, c, p, p)),
        "patch_embed.bias": zeros(e),
    }
    params.update(pe_registry.get(cfg.pos_encoding).init_params(generator, cfg))
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        params[f"{b}.norm1.weight"] = ones(e)
        params[f"{b}.norm1.bias"] = zeros(e)
        # qkv has NO bias (the reference's qkv_bias=False)
        params[f"{b}.attn.qkv.weight"] = trunc_normal(generator, (3 * e, e))
        params[f"{b}.attn.proj.weight"] = trunc_normal(generator, (e, e))
        params[f"{b}.attn.proj.bias"] = zeros(e)
        params[f"{b}.norm2.weight"] = ones(e)
        params[f"{b}.norm2.bias"] = zeros(e)
        params[f"{b}.mlp.fc1.weight"] = trunc_normal(generator, (hid, e))
        params[f"{b}.mlp.fc1.bias"] = zeros(hid)
        params[f"{b}.mlp.fc2.weight"] = trunc_normal(generator, (e, hid))
        params[f"{b}.mlp.fc2.bias"] = zeros(e)
    params["norm.weight"] = ones(e)
    params["norm.bias"] = zeros(e)
    params["head.weight"] = trunc_normal(generator, (cfg.num_classes, e))
    params["head.bias"] = zeros(cfg.num_classes)
    return {k: v.to(device) for k, v in params.items()}


def buffers(cfg: ViTConfig) -> dict:
    """Non-trainable state_dict entries (torch buffers): the relative
    position index, the rope-axial inv_freq."""
    return dict(pe_registry.get(cfg.pos_encoding).buffers(cfg))


def reference_alias_keys(cfg: ViTConfig) -> dict:
    """{alias_key: canonical_pos_embed_key}: the reference attaches the ONE
    shared PE module to every block's attention, so each pos_embed.* tensor
    appears again as blocks.{i}.attn.pos_encoding.* (absolute PE is applied
    at embed time and never attached)."""
    pe_mod = pe_registry.get(cfg.pos_encoding)
    if pe_mod.KIND == PE_KIND_EMBED_ADDITIVE:
        return {}
    names = list(pe_mod.init_params(torch.Generator(), cfg)) + list(
        pe_mod.buffers(cfg))
    aliases = {}
    for i in range(cfg.depth):
        for key in names:
            suffix = key.removeprefix("pos_embed.")
            aliases[f"blocks.{i}.attn.pos_encoding.{suffix}"] = key
    return aliases


def num_params(params: dict) -> int:
    return sum(int(v.numel()) for v in params.values())


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------

def patchify(images, cfg: ViTConfig):
    """[B, H, W, C] images -> [B, S, C·P·P] per-patch pixel rows, row-major
    over the patch grid (t_x = t % w, t_y = t // w: the reference's token
    order)."""
    b = images.shape[0]
    g, p, c = cfg.grid_size, cfg.patch_size, cfg.in_chans
    x = images.reshape(b, g, p, g, p, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # [B, gi, gj, C, P, P]
    return x.reshape(b, g * g, c * p * p)


def patch_embed(params, images, cfg: ViTConfig):
    """Non-overlapping patch embedding as reshape + matmul:
    out[b, t, e] = Σ_{c,p,q} w[e,c,p,q] · img[b, i·P+p, j·P+q, c]."""
    e, c, p = cfg.embed_dim, cfg.in_chans, cfg.patch_size
    w = params["patch_embed.weight"].reshape(e, c * p * p)
    return linear(patchify(images, cfg), w, params["patch_embed.bias"])


def _attention_impl(cfg: ViTConfig) -> str:
    """"auto" is the hand-written kernel. (The JAX package's "auto" sends
    N <= 2048 to its unfused oracle, a choice measured on a TPU that does
    not carry over to this card; the port keeps its kernel on the path.)
    "flash_block" makes each bias-free block one differentiation boundary
    (ops/block_vjp.py)."""
    impl = cfg.attention_impl
    if impl == "auto":
        return "flash"
    if impl not in ("flash", "flash_block", "reference"):
        raise ValueError(
            f"attention_impl={impl!r}; use 'auto', 'flash', 'flash_block' or "
            f"'reference'")
    return impl


def _dropout(x, rate, generator):
    """Inverted dropout, torch nn.Dropout's train mode (keep-scaled)."""
    keep = 1.0 - rate
    return layers.drop(x, layers.keep_mask(x.shape, keep, generator), keep)


def _drop_path(x, rate, generator):
    """Stochastic depth per sample (timm DropPath): zero a residual branch
    for a random subset of examples, survivors scaled by 1/keep."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    return layers.drop(x, layers.keep_mask(shape, keep, generator), keep)


def _logits_bias(pe_mod, params, cfg: ViTConfig, generator=None):
    """Materialized [H, L, L] attention bias — or, when the streaming
    attention kernel will run above its threshold with a polynomial or
    relative PE, a 1-tuple marker (coeff_hk,) / (table,) telling _block_body
    to let the kernel GENERATE the bias from the coefficients / table, so
    that no [H, L, L] tensor exists in the forward. Attention-prob dropout
    in train mode (a generator and a rate) needs the materialized bias: it
    runs on the unfused attention."""
    attn_drop_possible = cfg.attn_drop_rate > 0.0 and generator is not None
    if (cfg.pos_encoding in ("polynomial", "relative")
            and _attention_impl(cfg) == "flash"
            and cfg.seq_len > flash_attention.STREAMING_THRESHOLD
            and not attn_drop_possible):
        if cfg.pos_encoding == "polynomial":
            return (pe_mod.coeff_per_head(params, cfg),)
        return (pe_mod.table_per_head(params, cfg),)
    return pe_mod.attn_bias(params, cfg)


def _row_parallel(x, weight, bias, group):
    """A linear whose input columns a tensor-parallel rank holds a share
    of: the partial products summed over `group` (Megatron's g), then the
    bias once. Without a group, one linear with the bias in the product."""
    if group is None:
        return linear(x, weight, bias)
    out = distributed.psum_identity_bwd(linear(x, weight), group)
    return out + bias.to(out.dtype)


def _block_body(block_params: dict, x, cfg, bias, freqs_cis, impl,
                group=None, generator=None):
    """One pre-LN block on un-prefixed block params.

    With a generator and nonzero rates, dropout lands where the reference
    modules place it, its masks drawn in this order: the attention
    probabilities, after the attention projection (then drop-path on that
    branch), after each MLP linear (then drop-path on that branch). Without
    a generator the block is deterministic.

    group: a tensor-parallel rank's model group (None: one device). The
    block params are then the rank's shard (qkv [3, H/T, Dh, E], proj and
    fc2 input columns, fc1 rows; parallel/tensor_parallel.py) and bias /
    freqs_cis its heads' (_local_pe); Megatron's f stands where each half
    takes the replicated activation, g where its partial sums leave it.
    generator may then be a pair (shared, local): the masks on the rank's
    own heads and fc1 rows come from `local`, those on replicated tensors
    from `shared`, which every model rank of a data rank draws alike. One
    generator is both."""
    drop = generator is not None and cfg.has_dropout
    shared, local = (generator if isinstance(generator, tuple)
                     else (generator, generator))
    if impl == "flash_block":
        if bias is None and not drop:  # none, absolute, rope-axial/-mixed
            return block_vjp.block_apply(cfg, block_params, x, freqs_cis)
        impl = "flash"  # bias modes, dropout: the per-call boundary, as in JAX
    eps = cfg.layer_norm_eps
    h = layer_norm(x, block_params["norm1.weight"],
                    block_params["norm1.bias"], eps)
    h = distributed.identity_fwd_psum_bwd(h, group)
    bsz, n, e = h.shape
    dh = cfg.head_dim
    qkv_w = block_params["attn.qkv.weight"]
    nh = qkv_w.numel() // (3 * dh * e)  # H, or a tensor-parallel rank's H/T
    # Weight rows are torch-ordered f = part·E + head·Dh + d, so the
    # [B, N, 3E] product viewed as [3, B, H, N, Dh] needs no copy: q, k, v
    # are strided views the attention kernel reads in place.
    qkv = linear(h, qkv_w.reshape(-1, e))
    q, k, v = qkv.view(bsz, n, 3, nh, dh).permute(2, 0, 3, 1, 4).unbind(0)
    scale = dh ** -0.5
    attn_dropping = drop and cfg.attn_drop_rate > 0
    if impl == "flash" and not attn_dropping:
        if isinstance(bias, tuple):  # generated-bias marker (_logits_bias)
            gen = ({"poly": (bias[0], cfg.grid_size)}
                   if cfg.pos_encoding == "polynomial" else {"rel": bias[0]})
            attn_out = flash_attention.flash_attention(
                q, k, v, scale, freqs_cis=freqs_cis, **gen)
        else:
            attn_out = flash_attention.flash_attention(
                q, k, v, scale, bias=bias, freqs_cis=freqs_cis)
    else:
        # Attention-prob dropout needs the materialized probabilities, so it
        # runs on the unfused attention, as in the JAX package.
        attn_out = reference_attention.attention(
            q, k, v, scale, bias=bias, freqs_cis=freqs_cis,
            dropout_rate=cfg.attn_drop_rate if attn_dropping else 0.0,
            generator=local if attn_dropping else None)
    attn_out = attn_out.transpose(1, 2).reshape(bsz, n, nh * dh)
    attn_out = _row_parallel(attn_out, block_params["attn.proj.weight"],
                             block_params["attn.proj.bias"], group)
    if drop and cfg.drop_rate > 0:
        attn_out = _dropout(attn_out, cfg.drop_rate, shared)
    if drop and cfg.drop_path_rate > 0:
        attn_out = _drop_path(attn_out, cfg.drop_path_rate, shared)
    x = x + attn_out
    h = layer_norm(x, block_params["norm2.weight"],
                    block_params["norm2.bias"], eps)
    h = distributed.identity_fwd_psum_bwd(h, group)
    h = linear(h, block_params["mlp.fc1.weight"], block_params["mlp.fc1.bias"])
    h = F.gelu(h, approximate="none")  # torch nn.GELU default = exact erf
    if drop and cfg.drop_rate > 0:
        h = _dropout(h, cfg.drop_rate, local)
    h = _row_parallel(h, block_params["mlp.fc2.weight"],
                      block_params["mlp.fc2.bias"], group)
    if drop and cfg.drop_rate > 0:
        h = _dropout(h, cfg.drop_rate, shared)
    if drop and cfg.drop_path_rate > 0:
        h = _drop_path(h, cfg.drop_path_rate, shared)
    return x + h


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """JAX's dots_with_no_batch_dims_saveable: the outputs of products
    without batch dimensions (the block's linears) are saved; everything
    else, the attention's batched products and collectives included, is
    recomputed."""
    del ctx, args, kwargs
    save = op in _DOTS
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if save
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


class GraphDraws:
    """Where the recompute of a remat block that draws gets its generator
    inside a CUDA graph capture (train_step.make_train_multi_step).

    Philox draws depend on the seed and the offset alone. Under capture a
    generator's offset is a device value that each replay fills in plus
    an offset within the graph that only grows, so the recompute cannot
    rewind the forward's generator to where the block began. It draws from
    a generator of its own instead: registered with the capture and set,
    before every replay (prepare), to the forward generator's seed and to
    the offset at which the block's forward began drawing. Every row's
    dropout generator starts at offset 0, so those offsets are the same in
    every row; they are read (get_offset) in the eager warm-up step.

    Usage: the warm-up runs under measuring(), then allocate(rows) gives
    the generators to register, the capture runs under capturing(), and
    prepare() runs after the rows' generators are re-seeded and before
    each replay."""

    def __init__(self):
        self.offsets = []    # of the first row's generator, a block each
        self._first = None
        self._mode = None
        self._pool = []
        self._bound = []     # (replay generator, forward generator, offset)
        self._calls = {}

    @contextlib.contextmanager
    def _active(self, mode):
        global _GRAPH_DRAWS
        outer, _GRAPH_DRAWS, self._mode = _GRAPH_DRAWS, self, mode
        try:
            yield
        finally:
            _GRAPH_DRAWS, self._mode = outer, None

    def measuring(self):
        return self._active("measure")

    def capturing(self):
        return self._active("capture")

    def allocate(self, rows: int, device) -> list:
        """A replay generator per block of each of `rows` rows."""
        self._pool = [torch.Generator(device=device)
                      for _ in range(rows * len(self.offsets))]
        return list(self._pool)

    def prepare(self):
        for replay, gen, offset in self._bound:
            replay.manual_seed(gen.initial_seed())
            replay.set_offset(offset)

    def _replays(self, gen):
        """The recompute's generator for a block about to draw from
        `gen`."""
        if self._mode == "measure":
            if self._first is None:
                self._first = gen
            if gen is self._first:
                self.offsets.append(gen.get_offset())
            return _clone_replays(gen)
        j = self._calls.get(id(gen), 0)
        self._calls[id(gen)] = j + 1
        if j >= len(self.offsets) or not self._pool:
            raise RuntimeError("more remat blocks drew in the capture than "
                               "in the warm-up step")
        replay = self._pool.pop()
        self._bound.append((replay, gen, self.offsets[j]))
        return lambda: replay


_GRAPH_DRAWS = None  # the GraphDraws of the capture under way, if any


def _clone_replays(gen):
    """A source of generators that draw what `gen` draws from here on: a
    fresh copy of its state at this call for each recompute."""
    state = gen.clone_state()
    return state.clone_state


def _replay_source(generator):
    """Called where a remat block's forward begins: a function that gives
    the generator (or tuple: the tensor-parallel block's shared and local
    streams) its recompute draws from, so that it draws the forward's
    masks again, bit for bit. (checkpoint's preserve_rng_state covers the
    global generators only, never an explicit one.) Eager: a copy of the
    generator's state. Inside a CUDA graph capture: the registered
    generator of GraphDraws, which no other state can stand for."""
    gens = generator if isinstance(generator, tuple) else (generator,)
    if _GRAPH_DRAWS is not None:
        if len(gens) > 1:
            raise ValueError("a captured remat block draws from one "
                             "generator")
        return _GRAPH_DRAWS._replays(generator)
    sources = [_clone_replays(g) for g in gens]
    if len(sources) == 1:
        return sources[0]
    return lambda: tuple(source() for source in sources)


def remat_block_fn(cfg: ViTConfig, fn):
    """`fn` (a block: _block_body's signature, the generator last)
    recomputed in the backward per cfg.remat / cfg.remat_policy, identity
    when remat is off: the single home of the policy mapping, as in the JAX
    package. A call without grad runs fn as it is.

    "full" and "dots" run each call through torch.utils.checkpoint
    (non-reentrant): "full" recomputes everything, "dots" saves the
    block's linears (_dots_policy). The attention kernels launch through
    ctypes, which a policy cannot see, so both launch the attention
    forward again in the recompute, as jax.checkpoint recomputes
    pallas_call under both. The recompute draws the forward's masks again
    from a generator of its own (_replay_source).

    "softmax" is JAX's policy that saves every value but the probabilities
    named "attn_softmax". jax.checkpoint applies a policy to the residuals,
    the values the backward needs, and those are what autograd holds for
    the plain block. So the block runs as it is, and only the unfused
    attention changes: inside reference_attention.not_saving it holds the
    shifted logits, the probabilities' input, in their place and
    recomputes the probabilities in the backward. The kernel routes
    (flash, flash_block) name nothing: there the block is remat off's,
    its kernels' outputs saved, the attention forward launched once."""
    if not cfg.remat:
        return fn
    if cfg.remat_policy == "softmax":
        def saving_all_but_probs(*args, generator=None):
            with reference_attention.not_saving(
                    reference_attention.ATTN_SOFTMAX):
                return fn(*args, generator)

        return saving_all_but_probs
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy)

    def checkpointed(*args, generator=None):
        if not torch.is_grad_enabled():
            return fn(*args, generator)
        replays = None if generator is None else _replay_source(generator)
        calls = [0]

        def run(*args):
            calls[0] += 1
            if calls[0] == 1 or replays is None:
                return fn(*args, generator)
            return fn(*args, replays())

        # The port draws nothing from the global generators.
        return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                           preserve_rng_state=False, **kw)

    return checkpointed


def _local_pe(bias, freqs_cis, model_rank: int, local_h: int):
    """The blocks' PE arguments for model rank `model_rank`'s heads
    [model_rank·local_h, (model_rank+1)·local_h): a materialized bias
    [H, L, L] or a generated-bias marker's per-head coefficients / table
    sliced on dim 0 (contiguous slices of contiguous tensors); rope-mixed's
    per-head tables ([H, S, D/2]) likewise, rope-axial's shared ones as
    they are."""
    heads = slice(model_rank * local_h, (model_rank + 1) * local_h)
    if isinstance(bias, tuple):
        bias = (bias[0][heads],)
    elif bias is not None:
        bias = bias[heads]
    if freqs_cis is not None and freqs_cis[0].dim() == 3:
        freqs_cis = tuple(t[heads] for t in freqs_cis)
    return bias, freqs_cis


def embed(params, images, cfg: ViTConfig):
    """[B, H, W, C] images -> [B, L, E] tokens entering the first block:
    the patch embedding behind the cls token, the absolute PE added."""
    dtype = _DTYPES[cfg.compute_dtype]
    x = patch_embed(params, images.to(dtype), cfg)  # [B, S, E]
    bsz = x.shape[0]
    cls = params["cls_token"].to(dtype).expand(bsz, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)  # [B, L, E]
    pe_mod = pe_registry.get(cfg.pos_encoding)
    if pe_mod.KIND == PE_KIND_EMBED_ADDITIVE:
        x = pe_mod.add_embedding(params, x)
    return x


def block_pe(params, cfg: ViTConfig, device, generator=None):
    """(bias, freqs_cis), the PE arguments every block takes, generated
    once per forward: the bias (or the generated-bias marker) of
    _logits_bias, or the rope tables on `device`; None where the mode has
    none."""
    pe_mod = pe_registry.get(cfg.pos_encoding)
    if pe_mod.KIND == PE_KIND_LOGITS_BIAS:
        return _logits_bias(pe_mod, params, cfg, generator), None
    if pe_mod.KIND == PE_KIND_QK_ROTATION:
        return None, pe_mod.freqs_cis(params, cfg, device=device)
    return None, None


def head(params, x, cfg: ViTConfig):
    """[B, L, E] features -> [B, num_classes] float32 logits: the final
    norm, then the classifier on the cls token."""
    x = layer_norm(x, params["norm.weight"], params["norm.bias"],
                   cfg.layer_norm_eps)
    logits = linear(x[:, 0], params["head.weight"], params["head.bias"])
    return logits.float()


def forward_features(params, images, cfg: ViTConfig, generator=None,
                     mesh=None):
    """[B, H, W, C] images -> [B, L, E] token features after all blocks.

    generator: a torch.Generator on the images' device for train-mode
    dropout / drop-path (one stream for all blocks, drawn in order); None is
    the deterministic (eval) forward.

    mesh: a tensor-parallel mesh (parallel.mesh.Mesh, model axis T > 1):
    params are this rank's shard (parallel.tensor_parallel.shard_params),
    the PE arguments are cut to its heads (_local_pe), each block runs with
    f and g over the mesh's model group (_block_body), on the per-call
    kernel route under "flash_block" (the one-block boundary cannot hold
    collectives), and generator is a pair (shared, local) (_block_body).
    Every rank of a data row gets the same features. None, or a mesh
    without a model axis: the one-device forward."""
    x = embed(params, images, cfg)
    bias, freqs_cis = block_pe(params, cfg, x.device, generator)  # once
    impl = _attention_impl(cfg)
    group = None
    if mesh is not None and mesh.model_parallel > 1:
        bias, freqs_cis = _local_pe(bias, freqs_cis, mesh.model_rank,
                                    cfg.num_heads // mesh.model_parallel)
        group = mesh.model_group
        if impl == "flash_block":
            impl = "flash"
    block_fn = remat_block_fn(cfg, _block_body)
    for i in range(cfg.depth):
        block_params = {name: params[f"blocks.{i}.{name}"]
                        for name in BLOCK_PARAM_NAMES}
        x = block_fn(block_params, x, cfg, bias, freqs_cis, impl, group,
                     generator=generator)
    return x


def apply(params, images, cfg: ViTConfig, generator=None, mesh=None):
    """Full forward: [B, H, W, C] images -> [B, num_classes] float32 logits
    (classification from the cls token). generator enables train-mode
    dropout, mesh the tensor-parallel forward (see forward_features)."""
    return head(params, forward_features(params, images, cfg, generator,
                                         mesh), cfg)


# ---------------------------------------------------------------------------
# Depth-stacked layout: blocks.{i}.X (i = 0..depth-1) as one "blocks.X"
# [depth, ...] tensor. It fixes the key order of the optimizer moments'
# canonical flat vectors on disk (utils.flatten.Flattener).
# ---------------------------------------------------------------------------

def stack_block_params(params: dict, cfg: ViTConfig) -> dict:
    """Reference-keyed dict -> stacked dict (non-block keys first, in the
    input's order, then blocks.X in BLOCK_PARAM_NAMES order)."""
    out = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    for name in BLOCK_PARAM_NAMES:
        out[f"blocks.{name}"] = torch.stack(
            [params[f"blocks.{i}.{name}"] for i in range(cfg.depth)])
    return out


def unstack_block_params(stacked: dict, cfg: ViTConfig) -> dict:
    out = {k: v for k, v in stacked.items() if not k.startswith("blocks.")}
    for name in BLOCK_PARAM_NAMES:
        arr = stacked[f"blocks.{name}"]
        for i in range(cfg.depth):
            out[f"blocks.{i}.{name}"] = arr[i]
    return out


# ---------------------------------------------------------------------------
# nn.Module view
# ---------------------------------------------------------------------------

def full_state(params: dict, cfg: ViTConfig) -> dict:
    """Canonical params -> the reference's complete state_dict: params, the
    PE buffers, and the per-block alias keys."""
    state = dict(params)
    device = next(iter(params.values())).device if params else None
    for key, value in buffers(cfg).items():
        state.setdefault(key, value.to(device))
    for alias, canonical in reference_alias_keys(cfg).items():
        state[alias] = state[canonical]
    return state


class _Attention(nn.Module):
    def __init__(self, e: int, pos_encoding: nn.Module | None):
        super().__init__()
        self.qkv = nn.Linear(e, 3 * e, bias=False)
        self.proj = nn.Linear(e, e)
        if pos_encoding is not None:
            self.pos_encoding = pos_encoding  # shared: reference alias keys


class _Mlp(nn.Module):
    def __init__(self, e: int, hid: int):
        super().__init__()
        self.fc1 = nn.Linear(e, hid)
        self.fc2 = nn.Linear(hid, e)


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig, pos_encoding: nn.Module | None):
        super().__init__()
        e = cfg.embed_dim
        self.norm1 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.attn = _Attention(e, pos_encoding)
        self.norm2 = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
        self.mlp = _Mlp(e, cfg.mlp_hidden_dim)


class VisionTransformer(nn.Module):
    """The model as an nn.Module. Build it from a params dict (init_params,
    or a checkpoint through utils.checkpoint.split_state); forward(images)
    is apply(params, images, cfg)."""

    def __init__(self, params: dict, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        pe_mod = pe_registry.get(cfg.pos_encoding)
        pe_params = {k: v for k, v in params.items()
                     if k.startswith("pos_embed.")}
        # Registered before the blocks, so named_parameters() (which drops
        # the shared duplicates) reports the canonical pos_embed.* names.
        self.pos_embed = pe_registry.PositionalEncoding(
            pe_params, {k: v.to(next(iter(params.values())).device)
                        for k, v in pe_mod.buffers(cfg).items()})
        shared = None if pe_mod.KIND == PE_KIND_EMBED_ADDITIVE else self.pos_embed
        # Skeleton without initialization; the params are assigned below.
        with torch.device("meta"):
            e, c, p = cfg.embed_dim, cfg.in_chans, cfg.patch_size
            self.cls_token = nn.Parameter(torch.empty(1, 1, e))
            # The reference's Conv2d; here only a holder of weight/bias —
            # the forward is reshape + matmul (patch_embed).
            self.patch_embed = nn.Conv2d(c, e, p, stride=p)
            self.blocks = nn.ModuleList(
                _Block(cfg, shared) for _ in range(cfg.depth))
            self.norm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)
            self.head = nn.Linear(e, cfg.num_classes)
        self.load_state_dict(full_state(params, cfg), strict=True,
                             assign=True)

    def params(self) -> dict:
        """Canonical flat params dict (no alias keys, no buffers)."""
        return dict(self.named_parameters())

    def forward(self, images):
        return apply(self.params(), images, self.cfg)
