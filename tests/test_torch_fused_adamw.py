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
