"""Pipeline x tensor parallelism on a ('data', 'pipe', 'model') mesh — the
counterpart of the JAX package's parallel/pp_tp.py.

The blocks stage over the pipe axis with the GPipe schedule of
parallel/pipeline_parallel.py while each block's heads and MLP rows shard
over the model axis (models.vit._block_body with Megatron's f and g over
the rank's model row, as parallel/tensor_parallel.py runs it). A rank
holds depth/P blocks x H/T heads. Params are the depth-stacked dict of
the TP-prepared layout (stack_block_params of prepare_tp_params): the
"blocks.X" tensors cut on dim 0 over the stages and on their TP dim
(shifted by the stacking dim) over the model axis (pp_tp_shard_dims).
Activations stay replicated over the model row within a stage; each
tick's output crosses one hop of the stage chain.

Gradient layout (train_step._reduce_over_mesh): block params' gradients
are local to their (stage, model) shard and summed over the data axis;
the replicated params' are partial per stage and summed over the stages
and the data axis (the ranks of one model position); the per-head PE
params' (tensor_parallel.model_sync_keys) are also partial over the model
axis, so they are summed over every rank. Dropout is refused (a pipe-axis
constraint, as in JAX).
"""

from __future__ import annotations

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import (
    PE_KIND_LOGITS_BIAS,
    PE_KIND_QK_ROTATION,
    ViTConfig,
)
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel
from vit_rpe_rope_tpu_torch.parallel import tensor_parallel


def pp_tp_shard_dims(stacked: dict) -> dict:
    """{key: (pipe dim, model dim)} of depth-stacked TP-prepared params (the
    JAX pp_tp_param_specs): "blocks.X" on dim 0 over the stages, and over
    the model axis on tensor_parallel.tp_shard_dims's dim shifted by the
    stacking dim; None where a key is not sharded."""
    dims = {}
    for key, mdim in tensor_parallel.tp_shard_dims(stacked).items():
        if key.startswith(pipeline_parallel.BLOCKS):
            dims[key] = (0, None if mdim is None else mdim + 1)
        else:
            dims[key] = (None, None)
    return dims


def apply_pp_tp(params: dict, images, cfg: ViTConfig, mesh, n_micro: int):
    """The pipe x model forward (the JAX apply_pp_tp) on this rank's local
    params (pipeline_parallel.shard_reference under a model axis): every
    rank of a data position is called on the same images and gets the
    same logits. The PE bias is materialized [H, N, N] (as the JAX
    apply_pp_tp does; PP targets depth at reference-class N) and cut to
    the rank's heads, as are rope-mixed's per-head tables; "flash_block"
    runs the per-call kernel route (the one-block boundary cannot hold
    collectives)."""
    pe_mod = pe_registry.get(cfg.pos_encoding)
    bias = freqs_cis = None
    if pe_mod.KIND == PE_KIND_LOGITS_BIAS:
        bias = pe_mod.attn_bias(params, cfg)
    elif pe_mod.KIND == PE_KIND_QK_ROTATION:
        freqs_cis = pe_mod.freqs_cis(params, cfg, device=images.device)
    bias, freqs_cis = vit._local_pe(bias, freqs_cis, mesh.model_rank,
                                    cfg.num_heads // mesh.model_parallel)
    impl = vit._attention_impl(cfg)
    if impl == "flash_block":
        impl = "flash"
    return pipeline_parallel.apply_staged(
        params, images, cfg, mesh, n_micro, bias, freqs_cis, impl,
        group=mesh.model_group)
