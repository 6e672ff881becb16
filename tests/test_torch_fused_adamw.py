"""PyTorch port, fused AdamW: the plain twin of the CUDA AdamW kernel against
the JAX package's `make_fused_adamw` (the Pallas `_adamw_kernel` in
interpret mode on the CPU) and against optax.adamw, on injected gradients.
The kernel itself is tested on the card by tests/test_torch_kernels_gpu.py.

Optimizer steps are compared on injected gradients, not on trajectories of
a model: AdamW turns near-zero gradient differences into ±lr updates, so a
trajectory comparison would measure gradient noise, not the optimizer.
Tolerance 1e-6: the same float32 operations, with the scalars (lr, bias
corrections) computed in float32 on both sides; powf and cos may differ in
the last ulp between XLA and numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.configs import cosine_lr_by_epoch as jax_cosine
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import fused_adamw as jadamw
from vit_rpe_rope_tpu_torch.configs import cosine_lr_by_epoch
from vit_rpe_rope_tpu_torch.ops import fused_adamw
from vit_rpe_rope_tpu_torch.utils import convert

# 2 steps per epoch over 3 epochs: step 2 crosses an epoch boundary.
EPOCHS, STEPS_PER_EPOCH, LR, WD = 3, 2, 1e-3, 0.05


def jax_params():
    cfg = JaxViTConfig(img_size=16, patch_size=4, embed_dim=32, depth=2,
                       num_heads=2, pos_encoding="polynomial")
    return {k: np.asarray(v) for k, v in
            jvit.init_params(jax.random.PRNGKey(0), cfg).items()}


def injected_grads(params, step):
    rng = np.random.default_rng(100 + step)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    grads["norm.weight"] = np.zeros_like(grads["norm.weight"])  # pure decay
    return grads


def assert_dicts_close(got, want, tol=1e-6):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=tol, atol=tol, err_msg=key)


def port_optimizer(params):
    return fused_adamw.make_fused_adamw(
        params, cosine_lr_by_epoch(LR, EPOCHS, STEPS_PER_EPOCH),
        weight_decay=WD)


def test_twin_matches_jax_fused_adamw_kernel():
    params = jax_params()
    jinit, jupdate = jadamw.make_fused_adamw(
        params, jax_cosine(LR, EPOCHS, STEPS_PER_EPOCH), weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jinit(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    init, update = port_optimizer(tp)
    state = init(tp)
    before = fused_adamw.LAUNCHES_ADAMW
    for step in range(3):
        grads = injected_grads(params, step)
        jp, jstate = jupdate({k: jnp.asarray(v) for k, v in grads.items()},
                             jstate, jp)
        tp, state = update({k: torch.from_numpy(v) for k, v in grads.items()},
                           state, tp)
        assert_dicts_close(tp, jp)
        assert_dicts_close(state[0], jstate[0])
        assert_dicts_close(state[1], jstate[1])
        assert state[2] == int(jstate[2]) == step + 1
    assert fused_adamw.LAUNCHES_ADAMW == before  # CPU: the twin only


def test_twin_matches_optax_adamw():
    params = jax_params()
    tx = optax.adamw(jax_cosine(LR, EPOCHS, STEPS_PER_EPOCH), b1=0.9,
                     b2=0.999, eps=1e-8, weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ostate = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    init, update = port_optimizer(tp)
    state = init(tp)
    for step in range(3):
        grads = injected_grads(params, step)
        updates, ostate = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, ostate, jp)
        jp = optax.apply_updates(jp, updates)
        tp, state = update({k: torch.from_numpy(v) for k, v in grads.items()},
                           state, tp)
        assert_dicts_close(tp, jp)
        assert_dicts_close(state[0], ostate[0].mu)
        assert_dicts_close(state[1], ostate[0].nu)


def test_state_carried_over_from_optax_continues_alike():
    """optax moments and count moved into the port's state (the way a
    resumed run carries them) give the same next step."""
    params = jax_params()
    tx = optax.adamw(jax_cosine(LR, EPOCHS, STEPS_PER_EPOCH), weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ostate = tx.init(jp)
    for step in range(2):
        updates, ostate = tx.update(
            {k: jnp.asarray(v) for k, v in injected_grads(params, step).items()},
            ostate, jp)
        jp = optax.apply_updates(jp, updates)
    state = convert.adamw_state_from_jax(ostate[0].mu, ostate[0].nu,
                                         ostate[0].count)
    assert state[2] == 2
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    _, update = port_optimizer(tp)
    grads = injected_grads(params, 2)
    updates, ostate = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                                ostate, jp)
    jp = optax.apply_updates(jp, updates)
    tp, state = update({k: torch.from_numpy(v) for k, v in grads.items()},
                       state, tp)
    assert_dicts_close(tp, jp)


def test_zero_grad_is_pure_weight_decay():
    """Decoupled decay on every leaf, LayerNorm weights included (torch
    AdamW with one param group)."""
    p = {"norm.weight": torch.ones(4)}
    init, update = fused_adamw.make_fused_adamw(p, lambda s: 1e-3,
                                                weight_decay=0.01)
    p, _ = update({"norm.weight": torch.zeros(4)}, init(p), p)
    torch.testing.assert_close(p["norm.weight"],
                               torch.full((4,), 1.0 - 1e-3 * 0.01))


def test_bias_corrections_match_jax():
    for count in (1, 2, 3, 10, 1000):
        t = jnp.float32(count)
        want = (float(1.0 - 0.9 ** t), float(1.0 - 0.999 ** t))
        got = fused_adamw.bias_corrections(count, 0.9, 0.999)
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_wrapper_on_cpu_is_the_twin():
    rng = np.random.default_rng(3)
    leaves = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((3, 5), (7,))] for _ in range(4)]
    copies = [[t.clone() for t in group] for group in leaves]
    hyper = (1e-3, 0.1, 0.001, 0.9, 0.999, 1e-8, 0.01)
    before = fused_adamw.LAUNCHES_ADAMW
    leaves[3] = [t.abs() for t in leaves[3]]
    copies[3] = [t.abs() for t in copies[3]]
    fused_adamw.adamw_update(*leaves, *hyper)
    fused_adamw.adamw_plain(*copies, *hyper)
    assert fused_adamw.LAUNCHES_ADAMW == before
    for group, twin in zip(leaves, copies):
        for x, y in zip(group, twin):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("epochs,steps_per_epoch", [(25, 100), (3, 7)])
def test_schedule_matches_jax(epochs, steps_per_epoch):
    jsched = jax_cosine(1e-3, epochs, steps_per_epoch)
    sched = cosine_lr_by_epoch(1e-3, epochs, steps_per_epoch)
    for step in range(0, epochs * steps_per_epoch + 10, 3):
        np.testing.assert_allclose(float(sched(step)),
                                   float(jsched(jnp.int32(step))), rtol=1e-6)


def old_table(rows, chunk):
    """The table as the wrapper built it on every call before it kept one
    per parameter set: rows (p, g, mu, nu, numel), then (leaf, first
    element) per chunk."""
    numels = np.array([r[4] for r in rows], np.int64)
    per_leaf = -(-numels // chunk)
    first = np.repeat(np.cumsum(per_leaf) - per_leaf, per_leaf)
    chunks = np.stack([np.repeat(np.arange(len(rows)), per_leaf),
                       (np.arange(per_leaf.sum()) - first) * chunk], axis=1)
    return np.array(rows, np.int64), chunks


@pytest.mark.parametrize("numels", [
    [1], [4097, 3, 0, 8192, 12289, 4095],
    [int(n) for n in np.random.default_rng(4).integers(1, 20000, 150)],
    [5] * (fused_adamw.MAX_GRADS + 1)])
def test_table_matches_the_old_layout(numels):
    """build_table is a pure function of pointers and sizes: its leaf
    records are the old rows without the gradient, its chunks the old
    chunks, and its launches cover every leaf and chunk in order, at most
    MAX_GRADS leaves each."""
    rng = np.random.default_rng(len(numels))
    ptrs = [list(256 * rng.integers(1, 2 ** 40, len(numels)))
            for _ in range(4)]
    table, launches = fused_adamw.build_table(ptrs[0], ptrs[2], ptrs[3],
                                              numels)
    rows, chunks = old_table([list(r) for r in zip(*ptrs, numels)],
                             fused_adamw.CHUNK)
    n = len(numels)
    np.testing.assert_array_equal(table[:4 * n].reshape(n, 4),
                                  rows[:, [0, 2, 3, 4]])
    np.testing.assert_array_equal(table[4 * n:].reshape(-1, 2), chunks)
    assert len(launches) == -(-n // fused_adamw.MAX_GRADS)
    leaf, chunk = 0, 0
    for leaf0, n_leaves, c0, n_chunks in launches:
        assert (leaf0, c0) == (leaf, chunk)
        assert 1 <= n_leaves <= fused_adamw.MAX_GRADS
        assert set(chunks[c0:c0 + n_chunks, 0]) <= set(
            range(leaf0, leaf0 + n_leaves))
        leaf, chunk = leaf0 + n_leaves, c0 + n_chunks
    assert (leaf, chunk) == (n, len(chunks))


def test_table_is_built_once_per_parameter_set():
    """The table's key is the pointers and sizes of p, mu and nu: steps
    with fresh gradients reuse it, a swapped parameter or moment builds a
    new one, and the old set's table is found again."""
    rng = np.random.default_rng(5)
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in ((3, 5), (4097,), (7,))]
    mus = [torch.zeros_like(p) for p in params]
    nus = [torch.zeros_like(p) for p in params]
    key = fused_adamw.table_key(params, mus, nus)
    assert key == fused_adamw.table_key(list(params), mus, nus)
    assert key[0] == -1  # the device: the CPU
    before = fused_adamw.TABLE_BUILDS
    table, launches, numels = fused_adamw._device_table(params, mus, nus)
    assert fused_adamw.TABLE_BUILDS == before + 1
    assert numels == [15, 4097, 7] and launches == [(0, 3, 0, 4)]
    assert fused_adamw._device_table(params, mus, nus)[0] is table
    assert fused_adamw.TABLE_BUILDS == before + 1
    swapped = [params[0].clone(), *params[1:]]
    assert fused_adamw.table_key(swapped, mus, nus) != key
    assert fused_adamw._device_table(swapped, mus, nus)[0] is not table
    assert fused_adamw._device_table(params, mus, [n.clone() for n in nus]
                                     )[0] is not table
    assert fused_adamw.TABLE_BUILDS == before + 3
    assert fused_adamw._device_table(params, mus, nus)[0] is table
    assert fused_adamw.TABLE_BUILDS == before + 3
    with pytest.raises(ValueError, match="contiguous"):
        fused_adamw._device_table([p.t() for p in params[:1]], mus[:1],
                                  nus[:1])


def test_exact_reference_is_float32_op_by_op():
    """adamw_exact, the reference the kernel is held to bit for bit on the
    card, equals numpy's float32 arithmetic op by op (each operation
    correctly rounded), bit for bit; the twin agrees with it to 1e-6 (the
    CPU's float32 sqrt is not always correctly rounded)."""
    rng = np.random.default_rng(8)
    n = 200_000
    p, g, mu = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    nu = (0.01 * rng.standard_normal(n) ** 2).astype(np.float32)
    mu *= np.float32(0.1)
    lr, c1, c2, b1, b2, eps, wd = 1e-3, 0.271, 0.0039, 0.9, 0.999, 1e-8, 0.05
    f = np.float32
    m = f(b1) * mu + f(1 - b1) * g
    v = f(b2) * nu + (f(1 - b2) * g) * g
    upd = (m / f(c1)) / (np.sqrt(v / f(c2)) + f(eps)) + f(wd) * p
    want = (p - f(lr) * upd, m, v)
    leaves = [[torch.from_numpy(x.copy())] for x in (p, g, mu, nu)]
    got = fused_adamw.adamw_exact(*leaves, lr, c1, c2, b1, b2, eps, wd)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x[0].numpy(), y)
    fused_adamw.adamw_plain(*leaves, lr, c1, c2, b1, b2, eps, wd)
    for x, y in zip((leaves[0], leaves[2], leaves[3]), want):
        np.testing.assert_allclose(x[0].numpy(), y, rtol=1e-6, atol=1e-6)
