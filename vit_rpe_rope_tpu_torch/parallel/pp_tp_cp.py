"""Pipeline x tensor x context parallelism on a ('data', 'pipe', 'seq',
'model') mesh — the counterpart of the JAX package's parallel/pp_tp_cp.py.

The blocks stage over the pipe axis with the GPipe schedule of
parallel/pipeline_parallel.py (run_stages); inside each stage every block
is the TP x CP block (context_parallel._cp_block: the KV ring over the
rank's sequence ring, Megatron's f and g over its model row). A rank holds
depth/P blocks x N/R tokens x H/T heads. With T = 1 the model row is a
single rank, f and g are the identity, and this is the lone PP x CP, as in
JAX.

Params are the depth-stacked layout of pipeline_parallel.shard_reference:
TP-prepared and cut over the model axis as well under T > 1
(pp_tp.pp_tp_shard_dims), the reference layout stacked at T = 1; the
"blocks.X" tensors cut over the stages; nothing cut over the sequence or
data axes. Activations inside a stage are [B/M, N/R, E] token shards,
replicated over the model row; each active tick's output crosses one hop
of the stage chain (the P ranks of one data, sequence and model position).

The JAX module runs its tick scan with gate_bubbles=False: a stage that
lax.cond skipped on a bubble tick would skip a collective-permute of the
ring that its sequence peers wait for. The port's bubble ticks make no
call at all (pipeline_parallel's schedule launches nothing there), and
that is correct only because the R ranks of a ring share one stage:
they are active on the same ticks, run the same microbatch on each, and
so meet at every hop of the ring, in the forward and in the schedule's
reversed backward alike (whose per-tick autograd.grad runs the ring's
backward while the stage chain waits). Were a ring's ranks scheduled
apart, they would exchange keys of other microbatches, or wait on a hop
that never comes.

The logits: the head reads the cls row on sequence rank 0 of the last
stage; they are masked to it and re-replicated by g over the ring
(context_parallel.ring_logits), then over the stage chain
(pipeline_parallel.last_stage_logits).

Gradients (train_step._reduce_over_pipe): every one is partial over the
data and sequence axes; the block params' are local to their (stage,
model) shard and summed over Mesh.data_group; the replicated params' are
also partial per stage and summed over Mesh.replica_group; the per-head
PE params' (tensor_parallel.model_sync_keys) also over the model axis,
over every rank. Dropout is refused, with the JAX words.
"""

from __future__ import annotations

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel import context_parallel
from vit_rpe_rope_tpu_torch.parallel import pipeline_parallel


def apply_pp_tp_cp(params: dict, images, cfg: ViTConfig, mesh,
                   n_micro: int):
    """The pipe x seq (x model) forward (the JAX apply_pp_tp_cp) on this
    rank's local params (pipeline_parallel.shard_reference): every rank of
    a data position is called on the same images and gets the same logits
    [B, num_classes] float32. n_micro: the microbatches of the rank's
    batch."""
    if cfg.has_dropout:
        raise ValueError("pp×tp×cp does not support dropout")
    ring = mesh.seq_ring
    group, heads = context_parallel.model_row(mesh, cfg)
    x, (bias_arg, local_freqs, bias_kind, bias_grid), n = \
        context_parallel.shard_inputs(params, images, cfg, ring, heads)
    block_fn = vit.remat_block_fn(cfg, context_parallel._cp_block)

    def block(block_params, x, b, f):
        return block_fn(block_params, x, cfg, b, f, ring, n, bias_kind,
                        bias_grid, group)

    x = pipeline_parallel.run_stages(params, x, mesh, n_micro, bias_arg,
                                     local_freqs, block)
    logits = context_parallel.ring_logits(params, x, cfg, ring)
    return pipeline_parallel.last_stage_logits(logits, mesh)
