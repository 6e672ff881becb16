"""Tensor x context parallelism on a ('data', 'seq', 'model') mesh — the
counterpart of the JAX package's parallel/tp_cp.py.

Tokens shard over the sequence axis (the KV ring of
parallel/context_parallel.py) while heads and the MLP hidden width shard
over the model axis (Megatron, parallel/tensor_parallel.py), under the
data axis' batch split. A rank holds N/R tokens x H/T heads: the attention
working set drops by R·T, the activations by R, the params by T.

A block on a rank (context_parallel._cp_block with the rank's model row,
the JAX _tp_cp_block): the token shard x [B, Nl, E], replicated over the
model row, goes through LN and Megatron's f into qkv on the rank's heads
([3, H/T, Dh, E]); rope's cos / sin are cut to the shard's rows and the
rank's heads; a generated bias (relative, polynomial) ships its raw
per-head parameters cut to the rank's heads, from which
context_parallel.ring_dispatch generates each hop's [H/T, Nl, Nl] tile at
the global offsets (no [H, N, N] anywhere); the ring runs over the rank's
sequence ring (the R ranks of its data and model position, T apart); proj
and fc2 take the rank's input columns and their partial sums leave through
g, fc1 its rows. The logits are masked to sequence rank 0 and re-replicated
by g over the ring (context_parallel.ring_logits).

Gradients (train_step._reduce_over_mesh): every one is partial over the
data and sequence axes (the batch and token splits) and summed over
Mesh.data_group; the per-head PE params' (tensor_parallel.model_sync_keys)
are also partial over the model axis (each rank saw only its heads) and
summed over the model row too. Dropout is refused.
"""

from __future__ import annotations

from vit_rpe_rope_tpu_torch.parallel import context_parallel

# The TP x CP forward (the JAX apply_tp_cp) is apply_cp on a mesh with a
# model axis: params are the rank's tensor-parallel shard
# (tensor_parallel.shard_reference), every rank of a data position is
# called on the same images and returns the same logits [B, num_classes]
# float32.
apply_tp_cp = context_parallel.apply_cp
