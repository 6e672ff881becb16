"""Bounded-program train step on one device — the single-device body of the
JAX package's train/bounded.py: one optimizer step as many short pieces.

  embed -> [per block: pre -> attention per Q-CHUNK -> post] -> head/loss
        <- backward in reverse, attention gradients again per q-chunk <-
  -> optimizer update

* The attention, the only O(N^2) term, is split along query rows: each
  q-chunk runs against ALL keys through the streaming kernels at a global
  row offset (ops/flash_attention.streaming_chunk_fwd, the chunk entry of
  attn_stream_fwd.cu; streaming_chunk_bwd, the one-pass backward). One
  launch's work scales with q_chunk * N instead of N^2.
* Every per-token piece (embed, LN/qkv/rotation, proj/MLP, head) is O(N)
  and runs on its own. The backward is hand-scheduled: each piece's
  gradient is torch.autograd.grad of the piece recomputed from its saved
  inputs (the role of the JAX driver's per-piece jax.vjp). The residuals are
  explicit and bounded: the block inputs, the attention outputs and their
  logsumexp; q/k/v are recomputed, not saved; no autograd graph spans more
  than one piece. The dk/dv accumulators are float32. This schedule is
  gradient checkpointing already, so cfg.remat and cfg.remat_policy change
  nothing here, as in the JAX driver.
* kv_chunk > 0 also segments the key axis of the backward (outer loop over
  key segments, inner over q-chunks): dk/dv are complete per segment and
  written once in the compute dtype, so no full-width float32 accumulator
  exists; dq accumulates across segments in float32.
* Rounding points as the JAX driver: chunk partials of dq/dk/dv are cast to
  the compute dtype, the dk/dv accumulators stay float32, kv-segment dk/dv
  are written once in the compute dtype.

Over a process group's mesh (mesh=, seq_parallel=: the JAX driver's
parallel composition) the same host schedule runs on every rank:

* data parallelism: each data rank takes its columns of the batch;
* sequence parallelism (seq_parallel R > 1): tokens are sharded
  shard-major over the mesh's sequence axis (n_pad = N rounded up to
  512·R, Nl = n_pad / R tokens a rank; the embedding runs redundantly and
  each rank slices its tokens), and each q-chunk's attention runs the KV
  ring of parallel.context_parallel (ring_flash_fwd / ring_flash_bwd: one
  streaming chunk kernel a hop at global offsets, the hops merged with
  logaddexp; dk / dv riding the ring home), the time loop over q-chunks
  staying on the host. Data parallelism is the ring of one rank, so the
  mesh path is one code path; force_ring takes it on a mesh of one rank;
* the head runs on each ring's first rank (it holds the cls row), its
  loss the sum over the rank's columns divided by the whole batch's
  count; every gradient (the generated bias' parameter partials
  included) and the two metrics are summed over every rank by one
  all_reduce, outside any autograd graph, before the update.
kv_chunk does not compose with a mesh (the ring bounds the key residency
by the shard). Dropout is refused, as the JAX driver refuses it.

BOUNDED_SYNC_DEBUG=1: synchronize after every piece and print its tag (the
tag stream names the piece that runs out of memory in a new N regime).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.configs import (
    PE_KIND_EMBED_ADDITIVE,
    PE_KIND_LOGITS_BIAS,
    PE_KIND_QK_ROTATION,
    TrainConfig,
    ViTConfig,
)
from vit_rpe_rope_tpu_torch.models.vit import BLOCK_PARAM_NAMES, patch_embed
from vit_rpe_rope_tpu_torch.ops.flash_attention import (
    HEAD_DIMS, HeadPad, _pad_seq, _prep_freqs, _round_up, streaming_chunk_bwd,
    streaming_chunk_fwd)
from vit_rpe_rope_tpu_torch.ops.layers import layer_norm, linear
from vit_rpe_rope_tpu_torch.ops.rotary import rotate_half_split
from vit_rpe_rope_tpu_torch.parallel.context_parallel import (
    ring_flash_bwd, ring_flash_fwd)
from vit_rpe_rope_tpu_torch.train.train_step import (
    _reduce_over_mesh, _ring_metrics)

_ALIGN = 512  # every chunk / pad boundary a multiple of the key tiles
_SYNC_DEBUG = os.environ.get("BOUNDED_SYNC_DEBUG", "") == "1"

HEAD_NAMES = ("norm.weight", "norm.bias", "head.weight", "head.bias")
# The block params each half of a block reads: _pre the first three.
PRE_NAMES = ("norm1.weight", "norm1.bias", "attn.qkv.weight")
POST_NAMES = tuple(nm for nm in BLOCK_PARAM_NAMES if nm not in PRE_NAMES)


def _dbg(tag, value):
    if _SYNC_DEBUG:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        print(f"[bounded] {tag}", flush=True)
    return value


def _vjp(fn, inputs, cotangents):
    """(outputs, gradients) of one piece: fn(*inputs) recomputed under
    autograd from detached copies of the tensors `inputs`, then the
    gradients of its outputs (a tuple) against `cotangents` (one per output;
    outputs that do not depend on any input are skipped). Inputs that reach
    no output get zeros."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        outs = fn(*leaves)
        pairs = [(o, c) for o, c in zip(outs, cotangents) if o.requires_grad]
        grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                    [c for _, c in pairs], allow_unused=True)
    return (tuple(o.detach() for o in outs),
            [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves, grads)])


def make_bounded_step(cfg: ViTConfig, tcfg: TrainConfig, update, preprocess,
                      q_chunk: int = 131072, kv_chunk: int = 0,
                      mm_dtype=torch.bfloat16, debug_grads: bool = False,
                      mesh=None, seq_parallel: int = 1,
                      force_ring: bool = False, grad_accum: int = 1):
    """Build the bounded-program step.

    Returns step(params, opt_state, step_vec, images_u8, labels, mask=None)
    -> (params, opt_state, metrics [loss, correct, count]): the contract of
    the JAX driver. `update` is the optimizer of train_step.make_optimizer
    (the fused AdamW kernel on CUDA tensors); it updates params in place.
    The step runs on the device of params and images.

    q_chunk: query rows per attention launch (rounded up to 512). kv_chunk:
    0 = each backward launch sees all keys; > 0 = the backward also
    segments the keys (rounded up to 512). grad_accum > 1: the step takes
    inputs with a leading accumulation axis (images [A, B, h, w, C], labels
    and mask [A, B]), runs the fwd+bwd once per micro-batch, accumulates the
    count-weighted gradients and applies one update normalized by the total
    real-example count: the update of one step on the concatenated batch.
    mm_dtype: the products' dtype; bfloat16 is the kernels' and the only one
    CUDA tensors take, float32 is for the plain twins' parity tests on the
    CPU. debug_grads: also return the gradient dict as a 4th element.
    mesh: a process group's mesh (parallel.mesh.make_mesh; the module
    docstring): the step takes the whole batch, each data rank its
    columns, and every rank returns the whole batch's metrics and updated
    params. A mesh of one rank without force_ring is the one-device path.
    seq_parallel: the width of the mesh's sequence axis (the KV ring).
    force_ring: the ring's code path on a mesh of one rank (a ring of one
    rank, numerically the one-device step).

    The returned step has attributes n_chunks, n_pad and evaluate(params,
    step_vec, images_u8, labels, mask=None) -> metrics, the forward-only
    bounded evaluation."""
    del tcfg  # the JAX driver's signature; its schedule lives in `update`
    if cfg.has_dropout:
        raise ValueError("bounded-program stepping does not support dropout "
                         "(the reference's effective regime is all rates 0)")
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1; got {grad_accum}")
    n_seq = max(1, seq_parallel)
    if mesh is not None and not mesh.distributed:
        raise ValueError("the bounded driver's mesh is a process group's "
                         "(parallel.mesh.make_mesh under distributed."
                         "initialize)")
    if mesh is not None and len(mesh.ranks) == 1 and n_seq == 1 \
            and not force_ring:
        mesh = None  # one rank: keep the one-device path
    if mesh is not None:
        if mesh.seq_parallel != n_seq or mesh.model_parallel != 1:
            raise ValueError(
                f"seq_parallel={n_seq} needs a mesh whose 'seq' axis has "
                f"that size; got {mesh.shape}")
    elif n_seq > 1 or force_ring:
        raise ValueError("seq_parallel > 1 / force_ring require a mesh")
    if mesh is not None and kv_chunk:
        raise ValueError("kv_chunk does not compose with a mesh: under "
                         "seq_parallel the ring already bounds backward kv "
                         "residency by the shard size N/R")
    ring = mesh.seq_ring if mesh is not None else None
    my = mesh.seq_rank if mesh is not None else 0
    pe_mod = pe_registry.get(cfg.pos_encoding)
    kind = pe_mod.KIND
    rope = kind == PE_KIND_QK_ROTATION
    poly = cfg.pos_encoding == "polynomial"
    rel = cfg.pos_encoding == "relative"
    if kind == PE_KIND_LOGITS_BIAS and not (poly or rel):
        raise ValueError(f"no streaming generator for PE "
                         f"{cfg.pos_encoding!r}; use the monolithic step")
    dtype = getattr(torch, cfg.compute_dtype)
    n = cfg.seq_len
    e, nh, dh = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    eps = cfg.layer_norm_eps
    scale = dh ** -0.5
    # A head dim the kernels are not built for is zero-padded once per
    # block, not per chunk launch (q and k are rotated before the kernels,
    # so the whole row is padded).
    head_pad = HeadPad(dh, halves=False) if dh not in HEAD_DIMS else None
    dhp = head_pad.d_pad if head_pad is not None else dh
    q_chunk = _round_up(q_chunk, _ALIGN)
    n_pad = _round_up(n, _ALIGN * n_seq)
    nl = n_pad // n_seq  # this rank's tokens (all of them without a ring)
    mine = slice(my * nl, (my + 1) * nl)
    starts = list(range(0, nl, q_chunk))
    sizes = [min(q_chunk, nl - s) for s in starts]
    kv_chunk = _round_up(kv_chunk, _ALIGN) if kv_chunk else 0
    kv_starts = list(range(0, n_pad, kv_chunk)) if kv_chunk else [0]
    kv_sizes = ([min(kv_chunk, n_pad - c) for c in kv_starts] if kv_chunk
                else [n_pad])

    def _chunk_kw(aux):
        if poly:
            return {"poly": (aux[0], cfg.grid_size)}
        if rel:
            return {"rel": aux[0]}
        return {}

    # ---- pieces -----------------------------------------------------------

    def _embed(params, images_u8):
        """uint8 images -> this rank's padded tokens [B, Nl, E] + PE aux
        tensors: (cos, sin) f32 [1|H, Nl, D/2] (its rows) for rotation PEs,
        ([H, deg+1] coeffs,) / ([H, 2L-1] table,) for the generated
        biases, () otherwise."""
        x = preprocess(images_u8)
        x = patch_embed(params, x.to(dtype), cfg)
        cls = params["cls_token"].to(dtype).expand(x.shape[0], 1, e)
        x = torch.cat([cls, x], dim=1)
        if kind == PE_KIND_EMBED_ADDITIVE:
            x = pe_mod.add_embedding(params, x)
        x = _pad_seq(x, n_pad, 1)[:, mine]
        if rope:
            cos, sin = _prep_freqs(pe_mod.freqs_cis(params, cfg,
                                                    device=x.device),
                                   nh, n_pad, torch.float32, broadcast=False)
            return x, (cos[:, mine], sin[:, mine])
        if poly:
            return x, (pe_mod.coeff_per_head(params, cfg),)
        if rel:
            return x, (pe_mod.table_per_head(params, cfg),)
        return x, ()

    def _pre(bp, x, aux):
        """x [B, Nl, E] -> (rotated) q, k, v [B, H, Nl, Dh]."""
        h = layer_norm(x, bp["norm1.weight"], bp["norm1.bias"], eps)
        qkv = linear(h, bp["attn.qkv.weight"])
        q, k, v = qkv.view(x.shape[0], nl, 3, nh, dh).permute(
            2, 0, 3, 1, 4).unbind(0)
        if rope:
            cos, sin = aux
            q = rotate_half_split(q, cos[None], sin[None])
            k = rotate_half_split(k, cos[None], sin[None])
        return q, k, v

    def _post(bp, x, o):
        """Residual + proj + MLP: (block input x, attention out o
        [B, H, Nl, Dh]) -> block output."""
        a = o.transpose(1, 2).reshape(x.shape[0], nl, e)
        x = x + linear(a, bp["attn.proj.weight"], bp["attn.proj.bias"])
        h = layer_norm(x, bp["norm2.weight"], bp["norm2.bias"], eps)
        h = linear(h, bp["mlp.fc1.weight"], bp["mlp.fc1.bias"])
        h = F.gelu(h, approximate="none")
        h = linear(h, bp["mlp.fc2.weight"], bp["mlp.fc2.bias"])
        return x + h

    def _head(hp, xcls, labels, mask, count):
        """Final LN on the cls row only -> (the loss summed over the real
        examples divided by `count`, the whole batch's real examples: the
        batch-mean loss on one device; correct, count); mask [B] zeroes
        the padding of a final partial batch."""
        xf = layer_norm(xcls, hp["norm.weight"], hp["norm.bias"], eps)
        logits = linear(xf[:, 0], hp["head.weight"], hp["head.bias"]).float()
        losses = F.cross_entropy(logits, labels.long(), reduction="none")
        loss = (losses * mask).sum() / count.clamp(min=1.0)
        correct = ((logits.argmax(dim=-1) == labels).float() * mask).sum()
        return loss, correct, count

    def _block(params, i):
        return {nm: params[f"blocks.{i}.{nm}"] for nm in BLOCK_PARAM_NAMES}

    def _ones_mask(labels):
        return torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)

    # ---- backward pieces: each the gradient of a recomputed piece ---------

    def head_vg(hp, xcls, labels, mask, count):
        (loss, correct, count), grads = _vjp(
            lambda *t: _head(dict(zip(HEAD_NAMES, t[:-1])), t[-1], labels,
                             mask, count),
            [hp[nm] for nm in HEAD_NAMES] + [xcls],
            (torch.ones((), device=xcls.device), None, None))
        return loss, correct, count, dict(zip(HEAD_NAMES, grads[:-1])), \
            grads[-1]

    def post_b(bp, x, o, dy):
        _, grads = _vjp(
            lambda *t: (_post(dict(zip(POST_NAMES, t[:-2])), t[-2], t[-1]),),
            [bp[nm] for nm in POST_NAMES] + [x, o], (dy,))
        return dict(zip(POST_NAMES, grads[:-2])), grads[-2], grads[-1]

    def pre_b(bp, x, aux, dqkv):
        """(dbp, dx, daux) of _pre; daux only for rope (the generated
        biases' aux does not enter _pre)."""
        n_aux = len(aux) if rope else 0
        _, grads = _vjp(
            lambda *t: _pre(dict(zip(PRE_NAMES, t[:3])), t[3], t[4:]),
            [bp[nm] for nm in PRE_NAMES] + [x] + list(aux[:n_aux]), dqkv)
        return dict(zip(PRE_NAMES, grads[:3])), grads[3], grads[4:]

    def embed_b(params, images_u8, dx, daux):
        keys = [k for k in params
                if not k.startswith("blocks.") and k not in HEAD_NAMES]

        def fn(*t):
            x, aux = _embed(dict(zip(keys, t)), images_u8)
            return (x, *aux)

        _, grads = _vjp(fn, [params[k] for k in keys], (dx, *daux))
        return dict(zip(keys, grads))

    def attention_bwd(q, k, v, g, o, lse, aux):
        """dq, dk, dv (compute dtype) and the generated bias' parameter
        gradient (or None), per q-chunk (and per key segment)."""
        bsz = q.shape[0]
        kw = _chunk_kw(aux)
        if head_pad is not None:
            q, k, v, g, o = map(head_pad.pad, (q, k, v, g, o))
        shape = (bsz, nh, nl, dhp)
        unpad = head_pad.unpad if head_pad is not None else (lambda t: t)
        f32 = dict(dtype=torch.float32, device=q.device)
        dparam = None

        def chunk(rows, r0, cols, c0):
            delta = (g[:, :, rows].float() * o[:, :, rows].float()).sum(-1)
            return streaming_chunk_bwd(
                q[:, :, rows], k[:, :, cols], v[:, :, cols], g[:, :, rows],
                lse[:, :, rows], delta, scale, r0, c0, n, mm_dtype=mm_dtype,
                **kw)

        if kv_chunk:
            # dk/dv complete per key segment, written once in the compute
            # dtype; dq accumulates over the segments in float32.
            dq = torch.zeros(shape, **f32)
            dk = torch.empty(shape, dtype=dtype, device=q.device)
            dv = torch.empty(shape, dtype=dtype, device=q.device)
            for c0, szk in zip(kv_starts, kv_sizes):
                cols = slice(c0, c0 + szk)
                dk_j = dv_j = None
                for r0, szq in zip(starts, sizes):
                    rows = slice(r0, r0 + szq)
                    dq_c, dk_c, dv_c, dp_c = chunk(rows, r0, cols, c0)
                    dq[:, :, rows] += dq_c
                    dk_j = dk_c if dk_j is None else dk_j.add_(dk_c)
                    dv_j = dv_c if dv_j is None else dv_j.add_(dv_c)
                    if dp_c is not None:
                        dparam = dp_c if dparam is None else dparam.add_(dp_c)
                    _dbg(f"att_b2@{r0},{c0}", dv_j)
                dk[:, :, cols] = dk_j
                dv[:, :, cols] = dv_j
            return unpad(dq.to(dtype)), unpad(dk), unpad(dv), dparam
        # dq rows are disjoint across chunks (written once, compute dtype);
        # dk/dv accumulate the chunks' compute-dtype partials in float32.
        dq = torch.empty(shape, dtype=dtype, device=q.device)
        dk = torch.zeros(shape, **f32)
        dv = torch.zeros(shape, **f32)
        everything = slice(0, nl)
        for r0, sz in zip(starts, sizes):
            rows = slice(r0, r0 + sz)
            if mesh is None:
                dq_c, dk_c, dv_c, dp_c = chunk(rows, r0, everything, 0)
            else:  # the KV ring of this q-chunk, dk/dv home after R hops
                delta = (g[:, :, rows].float()
                         * o[:, :, rows].float()).sum(-1)
                dq_c, dk_c, dv_c, dp_c = ring_flash_bwd(
                    q[:, :, rows], k, v, g[:, :, rows], lse[:, :, rows],
                    delta, scale, ring, n, kw, mm_dtype, row0=my * nl + r0)
            dq[:, :, rows] = dq_c
            dk += dk_c.to(dtype)
            dv += dv_c.to(dtype)
            if dp_c is not None:
                dparam = dp_c if dparam is None else dparam.add_(dp_c)
            _dbg(f"att_b@{r0}", dv)
        return unpad(dq), unpad(dk.to(dtype)), unpad(dv.to(dtype)), dparam

    # ---- the host schedule ------------------------------------------------

    def forward(params, images_u8, keep_residuals=True):
        """Host-scheduled forward; returns (xs, os_, lses, aux), the
        residuals the backward consumes (xs holds only the last block
        output when keep_residuals=False, as for eval)."""
        with torch.no_grad():
            x, aux = _dbg("embed_f", _embed(params, images_u8))
            bsz = x.shape[0]
            xs, os_, lses = [x], [], []
            for i in range(cfg.depth):
                bp = _block(params, i)
                q, k, v = _dbg(f"pre_f[{i}]", _pre(bp, x, aux))
                if head_pad is not None:
                    q, k, v = map(head_pad.pad, (q, k, v))
                # o is [B, H, Nl, Dh] laid out as [B, Nl, H, Dh], so
                # _post's transpose back to [B, Nl, E] is a view.
                o = torch.empty((bsz, nl, nh, dhp), dtype=q.dtype,
                                device=q.device).transpose(1, 2)
                lse = torch.empty((bsz, nh, nl), dtype=torch.float32,
                                  device=q.device)
                for r0, sz in zip(starts, sizes):
                    rows = slice(r0, r0 + sz)
                    if mesh is None:
                        streaming_chunk_fwd(q[:, :, rows], k, v, scale, r0,
                                            0, n, out=o[:, :, rows],
                                            lse=lse[:, :, rows],
                                            mm_dtype=mm_dtype,
                                            **_chunk_kw(aux))
                    else:  # the KV ring of this q-chunk
                        o[:, :, rows], lse[:, :, rows] = ring_flash_fwd(
                            q[:, :, rows], k, v, scale, ring, n,
                            _chunk_kw(aux), mm_dtype, row0=my * nl + r0)
                    _dbg(f"att_f[{i}]@{r0}", lse)
                del q, k, v
                if head_pad is not None:
                    o = torch.empty((bsz, nl, nh, dh), dtype=o.dtype,
                                    device=o.device).transpose(1, 2).copy_(
                                        head_pad.unpad(o))
                x = _dbg(f"post_f[{i}]", _post(bp, x, o))
                if keep_residuals:
                    xs.append(x)
                    os_.append(o)
                    lses.append(lse)
                else:
                    xs[-1] = x
        return xs, os_, lses, aux

    def _columns(images_u8, labels, mask):
        """This data rank's columns of the batch axis (after the
        accumulation axis of grad_accum > 1); as they are without a
        mesh."""
        if mesh is None:
            return images_u8, labels, mask
        b = labels.shape[-1] // mesh.size
        cols = slice(mesh.rank * b, (mesh.rank + 1) * b)
        return tuple(t[:, cols] if labels.dim() > 1 else t[cols]
                     for t in (images_u8, labels, mask))

    def _sum_over_mesh(params, grads, loss, correct):
        """The gradient dict and the two metrics summed over every rank of
        the mesh by the train step's one all_reduce
        (train_step._reduce_over_mesh: the metrics counted on each ring's
        first rank), outside any autograd graph (the JAX psum of the
        in-kernel parameter partials over both axes, and GSPMD's batch
        sums); as they are without a mesh."""
        if mesh is None:
            return grads, loss, correct
        summed, loss, correct = _reduce_over_mesh(
            params, cfg, mesh, [grads[key] for key in params], loss, correct,
            None)
        return dict(zip(params, summed)), loss, correct

    def evaluate(params, step_vec, images_u8, labels, mask=None):
        """Forward-only bounded evaluation: metrics [loss, correct, count]
        (the eval counterpart fit() uses when q_chunk is set); over a mesh,
        the whole batch's, on every rank."""
        del step_vec
        if mask is None:
            mask = _ones_mask(labels)
        count = mask.sum()
        images_u8, labels, mask = _columns(images_u8, labels, mask)
        xs, _, _, _ = forward(params, images_u8, keep_residuals=False)
        with torch.no_grad():
            hp = {nm: params[nm] for nm in HEAD_NAMES}
            loss, correct, _ = _head(hp, xs[-1][:, :1], labels, mask, count)
            metrics = torch.stack([loss, correct])
            if mesh is not None:  # the cls row is each ring's first rank's
                metrics = mesh.sum_over_data(_ring_metrics(mesh, metrics))
            return torch.cat([metrics, count[None]])

    def _grads_of(params, images_u8, labels, mask, count):
        """One micro-batch's fwd+bwd on this rank's columns and tokens:
        (grads, loss, correct, count); loss is the sum over the columns
        divided by `count`, the micro-batch's real examples, and grads
        differentiate it. A ring's other ranks hold no cls row: their loss
        and head gradients are zero, and their tokens' gradients come
        through the attention's dk / dv (their metrics are dropped in
        _sum_over_mesh)."""
        xs, os_, lses, aux = forward(params, images_u8)
        hp = {nm: params[nm] for nm in HEAD_NAMES}
        loss, correct, count, grads, dxcls = head_vg(hp, xs[-1][:, :1],
                                                     labels, mask, count)
        dx = torch.zeros_like(xs[-1])
        if my > 0:
            grads = {key: torch.zeros_like(g) for key, g in grads.items()}
        else:
            dx[:, :1] = dxcls
        daux = [torch.zeros_like(a) for a in aux]
        for i in reversed(range(cfg.depth)):
            bp = _block(params, i)
            x_in, o, lse = xs[i], os_[i], lses[i]
            # Release the lists' references as the walk consumes them.
            xs[i + 1] = os_[i] = lses[i] = None
            dbp_post, dx_a, do = _dbg(f"post_b[{i}]", post_b(bp, x_in, o, dx))
            del dx
            with torch.no_grad():
                q, k, v = _pre(bp, x_in, aux)  # cheap O(N) recompute
                dq, dk, dv, dparam = attention_bwd(q, k, v, do, o, lse, aux)
            del do, o, lse, q, k, v
            dbp_pre, dx_b, da = _dbg(f"pre_b[{i}]",
                                     pre_b(bp, x_in, aux, (dq, dk, dv)))
            del dq, dk, dv, x_in
            dx = dx_a + dx_b
            for j, d in enumerate(da):
                daux[j] = daux[j] + d
            if dparam is not None:  # in-kernel dcoeff / dtable partials
                daux[0] = daux[0] + dparam.to(daux[0].dtype)
            for nm, g in {**dbp_post, **dbp_pre}.items():
                grads[f"blocks.{i}.{nm}"] = g
        for key, g in _dbg("embed_b",
                           embed_b(params, images_u8, dx, daux)).items():
            grads[key] = g
        return grads, loss, correct, count

    def step(params, opt_state, step_vec, images_u8, labels, mask=None):
        del step_vec  # the LR schedule lives in the optimizer state
        if mask is None:
            mask = _ones_mask(labels)
        counts = mask.sum(dim=-1)  # the whole batch's, per micro-batch
        images_u8, labels, mask = _columns(images_u8, labels, mask)
        if grad_accum == 1:
            grads, loss, correct, count = _grads_of(params, images_u8,
                                                    labels, mask, counts)
            grads, loss, correct = _sum_over_mesh(params, grads, loss, correct)
        else:
            # Sum over micro-batches of count_a * grads_a (each the gradient
            # of its micro-batch MEAN) is the raw gradient sum over every
            # real example; one division by the total count at the end is
            # the concatenated batch's gradient.
            if images_u8.shape[0] != grad_accum:
                raise ValueError(
                    f"grad_accum={grad_accum} expects a leading accumulation "
                    f"axis; got images {tuple(images_u8.shape)}")
            grads = None
            loss = correct = count = 0.0
            for a in range(grad_accum):
                g, loss_a, cor_a, cnt_a = _grads_of(
                    params, images_u8[a], labels[a], mask[a], counts[a])
                if grads is None:
                    grads = {key: cnt_a * t for key, t in g.items()}
                else:
                    for key, t in g.items():
                        grads[key] += cnt_a * t
                loss = loss + loss_a * cnt_a
                correct = correct + cor_a
                count = count + cnt_a
                _dbg(f"accum[{a}]", count)
            grads, loss, correct = _sum_over_mesh(params, grads, loss, correct)
            safe = count.clamp(min=1.0)
            grads = {key: t / safe for key, t in grads.items()}
            loss = loss / safe
        new_params, opt_state = _dbg("opt_upd",
                                     update(grads, opt_state, params))
        metrics = torch.stack([loss, correct, count])
        if debug_grads:
            return new_params, opt_state, metrics, grads
        return new_params, opt_state, metrics

    step.n_chunks = len(starts)
    step.n_pad = n_pad
    step.evaluate = evaluate
    return step
