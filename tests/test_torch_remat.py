"""PyTorch port, remat (models.vit.remat_block_fn) on the CPU, for each of
the JAX package's three policies (full, dots, softmax) on every attention
route: "reference" (the unfused attention), "flash" on the dense route and
on the streaming route (STREAMING_THRESHOLD lowered to 128 in both
packages: N = 145), and "flash_block" (ops/block_vjp.BlockFunction).

* Remat changes no number: the port's outputs and gradients with remat
  equal the port's without it bit for bit, dropout, drop-path and
  attention-prob dropout included (the generator's state is replayed in
  the recompute).
* They agree with JAX vit.apply under the same remat config (the mirror of
  the JAX package's test_remat_same_values_and_grads): outputs within
  rtol 1e-5 / atol 1e-6 and gradients within rtol 1e-4 / atol 5e-5 (that
  test's own bounds, float32 sums in another order) on the unfused
  attention; 2e-3 of each tensor's largest entry on the kernels' twins
  against the Pallas kernels in interpret mode (bf16 operands that can
  round the other way at a boundary).
* Activation bytes held between the forward and the backward, measured as
  the net CPU memory the forward allocates and does not free, by the
  profiler's memory accounting (torch.profiler, profile_memory=True; the
  sum of every op's self_cpu_memory_usage over the forward): "full" and
  "dots" hold fewer than no remat (at the rope-axial shape of
  test_remat_activation_bytes, batch 4, on the reference route: 57,792 and
  214,464 bytes against 447,296). "softmax" holds what no remat holds, as
  jax.checkpoint with the JAX policy holds every residual but the
  probabilities: on the reference route the shifted logits stand in for
  the probabilities (447,296 bytes, as without remat; with selective
  checkpoint contexts, which cache the output of every op the policy
  saves, it held 961,344), on the kernel routes the block is remat off's.
* The attention forward runs once per block under "softmax", twice under
  "full" and "dots" (the recompute), as JAX recomputes pallas_call.
* The bounded-program driver ignores remat, as the JAX driver does.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.ops import reference_attention
from vit_rpe_rope_tpu_torch.train import bounded
from vit_rpe_rope_tpu_torch.train import train_step as ts


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and the
    workers of a parallel test run do not compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


POLICIES = ("full", "dots", "softmax")
# route -> (attention_impl, PE mode, image size; patch 4)
ROUTES = {"reference": ("reference", "rope-axial", 16),
          "flash": ("flash", "relative", 16),
          "flash-stream": ("flash", "rope-axial", 48),
          "flash_block": ("flash_block", "rope-mixed", 16)}


def kw_of(route, **kw):
    impl, pe, img = ROUTES[route]
    d = dict(img_size=img, patch_size=4, in_chans=1, embed_dim=32, depth=2,
             num_heads=2, pos_encoding=pe, attention_impl=impl)
    d.update(kw)
    return d


@pytest.fixture
def stream(monkeypatch):
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 128)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 128)


def params_of(kw, seed=0):
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    return jparams, {k: torch.from_numpy(np.array(v)).requires_grad_()
                     for k, v in jparams.items()}


def images(kw, seed=1):
    return np.random.default_rng(seed).normal(
        size=(2, kw["img_size"], kw["img_size"], 1)).astype(np.float32)


def port_run(params, x, cfg, generator=None):
    out = vit.apply(params, torch.from_numpy(x), cfg, generator)
    grads = torch.autograd.grad((out ** 2).sum(), list(params.values()))
    return out.detach(), dict(zip(params, grads))


def assert_equal_runs(a, b):
    assert torch.equal(a[0], b[0])
    for key in a[1]:
        assert torch.equal(a[1][key], b[1][key]), key


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_matches_no_remat_and_jax(policy, route, request):
    if route == "flash-stream":
        request.getfixturevalue("stream")
    kw = kw_of(route)
    remat_kw = dict(kw, remat=True, remat_policy=policy)
    jparams, params = params_of(kw)
    x = images(kw)
    cfg, remat_cfg = ViTConfig(**kw), ViTConfig(**remat_kw)
    if route == "flash-stream":
        assert cfg.seq_len > tfa.STREAMING_THRESHOLD
    want = port_run(params, x, cfg)
    got = port_run(params, x, remat_cfg)
    assert_equal_runs(got, want)

    jcfg = JaxViTConfig(**remat_kw)

    def loss(p):
        return jnp.sum(jvit.apply(p, jnp.asarray(x), jcfg) ** 2)

    jout = np.asarray(jvit.apply(jparams, jnp.asarray(x), jcfg))
    jgrads = jax.grad(loss)(jparams)
    if route == "reference":
        np.testing.assert_allclose(got[0].numpy(), jout, rtol=1e-5,
                                   atol=1e-6)
        for key in params:
            np.testing.assert_allclose(got[1][key].numpy(),
                                       np.asarray(jgrads[key]), rtol=1e-4,
                                       atol=5e-5, err_msg=key)
    else:
        for g, w, name in [(got[0].numpy(), jout, "out")] + [
                (got[1][key].numpy(), np.asarray(jgrads[key]), key)
                for key in params]:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=2e-3 * float(np.abs(w).max()) + 1e-8,
                err_msg=name)


@pytest.mark.parametrize("route", ["reference", "flash", "flash_block"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_with_dropout_is_bit_for_bit(policy, route):
    """The recompute draws the forward's masks again: dropout, drop-path
    (and attention-prob dropout on the reference route) with remat equal
    them without remat on generators of one seed, bit for bit; the
    generator ends where the forward left it."""
    rates = dict(drop_rate=0.1, drop_path_rate=0.2,
                 attn_drop_rate=0.1 if route == "reference" else 0.0)
    kw = kw_of(route, **rates)
    _, params = params_of(kw, seed=2)
    x = images(kw, seed=3)
    runs, ends = [], []
    for cfg in (ViTConfig(**kw),
                ViTConfig(**dict(kw, remat=True, remat_policy=policy))):
        gen = torch.Generator().manual_seed(11)
        out = vit.apply(params, torch.from_numpy(x), cfg, gen)
        after_forward = gen.get_state()
        grads = torch.autograd.grad((out ** 2).sum(), list(params.values()))
        runs.append((out.detach(), dict(zip(params, grads))))
        assert torch.equal(gen.get_state(), after_forward)
        ends.append(after_forward)
    assert_equal_runs(runs[1], runs[0])
    assert torch.equal(ends[0], ends[1])
    # the masks do act: another seed gives another output
    other = vit.apply(params, torch.from_numpy(x), ViTConfig(**kw),
                      torch.Generator().manual_seed(12))
    assert not torch.equal(other.detach(), runs[0][0])


def held_bytes(fn):
    """Net CPU bytes allocated by fn and not freed when it returns (the
    profiler's memory accounting), and fn's result."""
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        out = fn()
    return sum(e.self_cpu_memory_usage for e in prof.key_averages()), out


@pytest.mark.parametrize("route,policy", [
    ("reference", "full"), ("reference", "dots"), ("flash", "full"),
    ("flash", "dots"), ("flash_block", "full"), ("reference", "softmax"),
    ("flash", "softmax"), ("flash_block", "softmax")])
def test_remat_activation_bytes(route, policy):
    kw = kw_of(route, pos_encoding="rope-axial")
    _, params = params_of(kw, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, kw["img_size"], kw["img_size"], 1)).astype(np.float32))
    none, out = held_bytes(lambda: vit.apply(params, x, ViTConfig(**kw)))
    del out
    remat, out = held_bytes(lambda: vit.apply(
        params, x, ViTConfig(**kw, remat=True, remat_policy=policy)))
    del out
    if policy == "softmax":
        # the shifted logits stand in for the probabilities on the
        # reference route; the kernel routes name nothing
        limit = 1.05 * none if route == "reference" else none
        assert 0 < remat <= limit, (remat, none)
    else:
        assert 0 < remat < none, (remat, none)
        if policy == "full":
            assert remat < none / 3, (remat, none)


@pytest.mark.parametrize("policy,calls", [(None, 1), ("full", 2),
                                          ("dots", 2), ("softmax", 1)])
def test_attention_forward_calls_per_policy(policy, calls, monkeypatch):
    """On the flash route the attention forward (on the CPU, the kernel
    wrapper's twin) runs once per block under "softmax", as without remat,
    and twice under "full" and "dots", whose recompute runs it again."""
    count = [0]
    twin = tfa.attention_plain

    def counted(*args, **kwargs):
        count[0] += 1
        return twin(*args, **kwargs)

    monkeypatch.setattr(tfa, "attention_plain", counted)
    kw = kw_of("flash", pos_encoding="rope-axial")
    if policy is not None:
        kw.update(remat=True, remat_policy=policy)
    _, params = params_of(kw, seed=7)
    out, _ = port_run(params, images(kw, seed=7), ViTConfig(**kw))
    assert torch.isfinite(out).all()
    assert count[0] == calls * kw["depth"]


def test_softmax_policy_recomputes_only_the_tagged_probabilities():
    """The policies' decisions: dots saves mm/addmm only; softmax holds
    every tensor the backward needs but the probabilities named
    "attn_softmax", whose input (the shifted logits) it holds instead; the
    gradients equal the plain attention's bit for bit, with attention-prob
    dropout too."""
    ctx = None
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    recompute = torch.utils.checkpoint.CheckpointPolicy.PREFER_RECOMPUTE
    mm, exp, bmm = (torch.ops.aten.mm.default, torch.ops.aten.exp.default,
                    torch.ops.aten.bmm.default)
    assert vit._dots_policy(ctx, mm) is save
    assert vit._dots_policy(ctx, torch.ops.aten.addmm.default) is save
    assert vit._dots_policy(ctx, bmm) is recompute
    assert vit._dots_policy(ctx, exp) is recompute

    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, 9, 8)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    logits = torch.matmul(q, k.transpose(-1, -2)).detach() * 0.5
    shifted = logits - torch.logsumexp(logits, dim=-1, keepdim=True)
    probs = torch.exp(shifted)
    runs = []
    for not_saving in (False, True):
        gen = torch.Generator().manual_seed(8)
        saved = []

        def pack(t):
            saved.append(t.detach().clone())
            return t

        tag = (reference_attention.not_saving(reference_attention.ATTN_SOFTMAX)
               if not_saving else contextlib.nullcontext())
        with tag, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            assert reference_attention.saves("attn_softmax") is not not_saving
            out = reference_attention.attention(q, k, v, 0.5,
                                                dropout_rate=0.25,
                                                generator=gen)
        square = [t for t in saved if t.shape == probs.shape
                  and t.dtype == probs.dtype]
        held = [torch.allclose(t, probs) for t in square]
        stands_in = [torch.allclose(t, shifted) for t in square]
        assert any(held) is not not_saving
        assert any(stands_in) is not_saving
        runs.append((out, torch.autograd.grad((out ** 2).sum(), (q, k, v))))
    assert reference_attention.saves("attn_softmax")
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


def test_remat_off_and_without_grad_is_the_plain_block():
    cfg = ViTConfig(**kw_of("reference"))
    assert vit.remat_block_fn(cfg, vit._block_body) is vit._block_body
    remat = vit.remat_block_fn(dataclasses.replace(cfg, remat=True),
                               vit._block_body)
    assert remat is not vit._block_body
    _, params = params_of(kw_of("reference"), seed=5)
    x = torch.from_numpy(images(kw_of("reference"), seed=5))
    with torch.no_grad():
        assert torch.equal(
            vit.apply(params, x, dataclasses.replace(cfg, remat=True)),
            vit.apply(params, x, cfg))


def test_bounded_driver_ignores_remat():
    """The bounded step recomputes its pieces by design; remat=True gives
    the same loss and gradients, bit for bit, as in the JAX driver, where
    remat has no effect."""
    kw = dict(img_size=16, patch_size=4, in_chans=3, embed_dim=32, depth=2,
              num_heads=2, pos_encoding="rope-axial",
              attention_impl="reference")
    _, params = params_of(kw, seed=6)
    rng = np.random.default_rng(6)
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3),
                                         dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, 10, (2,), dtype=np.int32))
    results = []
    for cfg in (ViTConfig(**kw), ViTConfig(**kw, remat=True,
                                           remat_policy="dots")):
        pre = ts.make_preprocess(cfg, (0.5, 0.5, 0.5), (0.2, 0.2, 0.2), 16)

        def no_update(grads, state, p):
            return p, state

        step = bounded.make_bounded_step(
            cfg, TrainConfig(dataset="cifar10", batch_size=2), no_update,
            pre, q_chunk=512, mm_dtype=torch.float32, debug_grads=True)
        copy = {k: v.detach().clone() for k, v in params.items()}
        _, _, metrics, grads = step(copy, None, 0, imgs, labels)
        results.append((metrics, grads))
    assert torch.equal(results[0][0], results[1][0])
    for key in results[0][1]:
        assert torch.equal(results[0][1][key], results[1][1][key]), key
