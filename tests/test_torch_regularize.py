"""PyTorch port, regularised training: dropout, drop-path, attention-prob
dropout and augmentation against the JAX package.

The packages draw their masks from different generators by design
(torch.Generator against jax.random), so the parity tests record the port's
masks in the order it draws them and replay them in the JAX forward by
monkeypatching `vit._dropout`, `vit._drop_path` and, for attention-prob
dropout, `jax.random.bernoulli` as the JAX oracle calls it. The JAX side is
`vit.apply` (the unrolled forward), the same params moved over with numpy.

Tolerances, as in tests/test_torch_model.py and test_torch_train.py: 1e-5
on the unfused attention (float32 sums in another order), 2e-3 on the
attention kernels (the port's plain twins against the JAX package's Pallas
kernels in interpret mode: bf16 operands that can round the other way);
gradients relative to each tensor's largest entry. The augmentation is
data movement and is held bit for bit.
"""

import dataclasses
import glob
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu import pe as jpe_registry
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu.ops import reference_attention as jref
from vit_rpe_rope_tpu.train import train_step as jts
from vit_rpe_rope_tpu_torch import pe as pe_registry
from vit_rpe_rope_tpu_torch.cli import train as train_cli
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import block_vjp, layers
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.ops import reference_attention
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.train import train_step as ts

PE_NAMES = ["none", "absolute", "relative", "polynomial", "rope-axial",
            "rope-mixed"]
TOL = {"reference": 1e-5, "flash": 2e-3}
RATES = dict(drop_rate=0.2, drop_path_rate=0.3)


def small_kw(pe_name, **kw):
    base = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                num_heads=4, pos_encoding=pe_name, attention_impl="reference")
    base.update(kw)
    return base


def both_params(kw, seed=0):
    jparams = jvit.init_params(jax.random.PRNGKey(seed), JaxViTConfig(**kw))
    tparams = {k: torch.from_numpy(np.array(v)).requires_grad_()
               for k, v in jparams.items()}
    return jparams, tparams


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close_to_largest(got, want, tol, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0,
        atol=tol * float(np.abs(want).max()) + 1e-8, err_msg=err_msg)


def record_masks(monkeypatch):
    """Every mask the port draws from now on, in order, as numpy arrays."""
    tape = []
    draw = layers.keep_mask

    def recording(shape, keep, generator):
        mask = draw(shape, keep, generator)
        tape.append(mask.cpu().numpy())
        return mask

    monkeypatch.setattr(layers, "keep_mask", recording)
    return tape


def replay_in_jax(monkeypatch, tape):
    """Make the JAX forward use the recorded masks, in order; returns a
    function that rewinds the tape (one call per JAX forward)."""
    state = {"next": 0}

    def take(shape):
        mask = tape[state["next"]]
        state["next"] += 1
        assert mask.shape == tuple(shape), (mask.shape, shape)
        return jnp.asarray(mask)

    def dropout(x, rate, key):
        keep = 1.0 - rate
        return jnp.where(take(x.shape), x / keep, jnp.zeros_like(x))

    def drop_path(x, rate, key):
        keep = 1.0 - rate
        mask = take((x.shape[0],) + (1,) * (x.ndim - 1))
        return jnp.where(mask, x / keep, jnp.zeros_like(x))

    monkeypatch.setattr(jvit, "_dropout", dropout)
    monkeypatch.setattr(jvit, "_drop_path", drop_path)
    # The JAX oracle draws the attention-prob mask itself.
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, p, shape: take(shape))

    def rewind():
        state["next"] = 0

    return rewind, state


def logits_and_grads_match(kw, monkeypatch, seed):
    """The port's regularised logits and gradients (generator set) against
    JAX vit.apply on the port's masks."""
    impl = kw["attention_impl"]
    jparams, tparams = both_params(kw, seed=seed)
    cfg, jcfg = ViTConfig(**kw), JaxViTConfig(**kw)
    x = images((4, 32, 32, 3), seed=seed)
    weights = images((4, 10), seed=seed + 1)
    tape = record_masks(monkeypatch)
    logits = vit.apply(tparams, torch.from_numpy(x), cfg,
                       torch.Generator().manual_seed(seed))
    loss = (logits * torch.from_numpy(weights)).sum()
    grads = torch.autograd.grad(loss, list(tparams.values()))
    n_masks = len(tape)
    rewind, state = replay_in_jax(monkeypatch, tape)

    def jloss(p):
        rewind()
        out = jvit.apply(p, jnp.asarray(x), jcfg, rng=jax.random.PRNGKey(0))
        return (out * jnp.asarray(weights)).sum(), out

    (want_loss, want_logits), want = jax.value_and_grad(
        jloss, has_aux=True)(jparams)
    assert state["next"] == n_masks  # JAX consumed every mask, in order
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=TOL[impl],
                               atol=TOL[impl])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=TOL[impl], atol=TOL[impl])
    for key, g in zip(tparams, grads):
        close_to_largest(g.numpy(), want[key], TOL[impl], err_msg=key)
    return tape


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("pe_name", PE_NAMES)
def test_dropout_and_drop_path_match_jax_on_replayed_masks(pe_name, impl,
                                                           monkeypatch):
    tape = logits_and_grads_match(
        small_kw(pe_name, attention_impl=impl, **RATES), monkeypatch, seed=1)
    # Per block: proj dropout, proj drop-path, fc1 and fc2 dropout, MLP
    # drop-path (no attention-prob dropout at rate 0).
    assert [m.shape for m in tape[:5]] == [(4, 17, 64), (4, 1, 1),
                                          (4, 17, 256), (4, 17, 64),
                                          (4, 1, 1)]
    assert len(tape) == 2 * 5


@pytest.mark.parametrize("impl", ["reference", "flash"])
@pytest.mark.parametrize("pe_name", ["rope-mixed", "relative"])
def test_attention_dropout_matches_jax_on_replayed_masks(pe_name, impl,
                                                         monkeypatch):
    tape = logits_and_grads_match(
        small_kw(pe_name, attention_impl=impl, attn_drop_rate=0.25, **RATES),
        monkeypatch, seed=2)
    assert tape[0].shape == (4, 4, 17, 17)  # the probabilities' mask first
    assert len(tape) == 2 * 6


@pytest.mark.parametrize("impl", ["reference", "flash", "flash_block"])
def test_zero_rates_with_a_generator_are_bit_identical(impl):
    kw = small_kw("rope-axial", patch_size=4, attention_impl=impl)
    _, params = both_params(kw)
    x = torch.from_numpy(images((2, 32, 32, 3)))
    cfg = ViTConfig(**kw)
    with torch.no_grad():
        plain = vit.apply(params, x, cfg)
        assert torch.equal(
            vit.apply(params, x, cfg, torch.Generator().manual_seed(3)),
            plain)
        # Rates without a generator (evaluation): the deterministic forward.
        regularised = ViTConfig(**dict(kw, attn_drop_rate=0.2, **RATES))
        assert torch.equal(vit.apply(params, x, regularised), plain)
        a = vit.apply(params, x, regularised, torch.Generator().manual_seed(3))
        b = vit.apply(params, x, regularised, torch.Generator().manual_seed(3))
        c = vit.apply(params, x, regularised, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert not torch.equal(a, c)


def test_mask_statistics():
    gen = torch.Generator().manual_seed(0)
    for keep in (0.5, 0.7, 0.9):
        mask = layers.keep_mask((200, 320), keep, gen)
        n = mask.numel()
        bound = 6 * math.sqrt(keep * (1 - keep) / n)  # six binomial sigmas
        assert abs(float(mask.float().mean()) - keep) < bound
    x = torch.ones(1000, 16)
    y = vit._dropout(x, 0.3, gen)
    assert set(torch.unique(y).tolist()) == {0.0, float(torch.tensor(1.0)
                                                         / 0.7)}
    x = torch.ones(64, 5, 8)
    y = vit._drop_path(x, 0.5, gen).reshape(64, -1)
    whole = [bool((row == 0).all() or (row == 2.0).all()) for row in y]
    assert all(whole)  # every sample zeroed or kept whole
    assert 0 < int((y[:, 0] == 0).sum()) < 64


def test_augment_apply_equals_jax_augment_on_jax_draws():
    x = images((6, 32, 32, 3), seed=5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jts._augment(jnp.asarray(x), key))
    kf, ky, kx = jax.random.split(key, 3)  # as jts._augment draws
    flip = np.array(jax.random.bernoulli(kf, 0.5, (6,)))
    oy = np.array(jax.random.randint(ky, (6,), 0, 9))
    ox = np.array(jax.random.randint(kx, (6,), 0, 9))
    got = ts.augment_apply(torch.from_numpy(x), torch.from_numpy(flip),
                           torch.from_numpy(oy).long(),
                           torch.from_numpy(ox).long())
    np.testing.assert_array_equal(got.numpy(), want)
    assert flip.any() and not flip.all()  # both branches taken


def test_preprocess_augments_only_with_a_generator():
    """make_preprocess(augment=True): the draws of the generator it is
    given, after the resize (MNIST 28 px -> 32) and before the
    normalisation; evaluation (no generator) is the plain preprocess."""
    bundle = datasets.synthetic("mnist", n_train=8, n_test=2, seed=0)
    cfg = ViTConfig(**small_kw("none", in_chans=1))
    args = (cfg, bundle.mean, bundle.std, 28)
    plain, augmenting = ts.make_preprocess(*args), ts.make_preprocess(
        *args, augment=True)
    imgs = torch.from_numpy(bundle.train_x)
    assert torch.equal(augmenting(imgs), plain(imgs))
    got = augmenting(imgs, torch.Generator().manual_seed(9))
    draws = ts.augment_draws(torch.Generator().manual_seed(9), 8)
    resized = plain(imgs) * float(bundle.std[0]) + float(bundle.mean[0])
    want = (ts.augment_apply(resized, *draws) - float(bundle.mean[0])) \
        / float(bundle.std[0])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert got.shape == (8, 32, 32, 1) and not torch.equal(got, plain(imgs))
    assert int(draws[1].max()) <= 8 and int(draws[2].min()) >= 0


@pytest.mark.parametrize("pe_name", ["polynomial", "relative"])
def test_attention_dropout_routes_as_jax(pe_name, monkeypatch):
    """Above a streaming threshold lowered to 128 in both packages (N=145):
    without a generator the bias is generated in the kernel (the marker)
    and the attention runs on the kernels; with one and attn_drop_rate > 0
    the bias is materialized and every block runs the unfused oracle, in
    both packages; flash_block falls back to the per-call boundary."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 128)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 128)
    kw = small_kw(pe_name, img_size=48, patch_size=4, attention_impl="flash",
                  attn_drop_rate=0.1)
    cfg, jcfg = ViTConfig(**kw), JaxViTConfig(**kw)
    jparams, tparams = both_params(kw)
    gen = torch.Generator().manual_seed(0)
    mod, jmod = pe_registry.get(pe_name), jpe_registry.get(pe_name)
    assert isinstance(vit._logits_bias(mod, tparams, cfg), tuple)
    assert isinstance(jvit._logits_bias(jmod, jparams, jcfg), tuple)
    assert torch.is_tensor(vit._logits_bias(mod, tparams, cfg, gen))
    assert not isinstance(jvit._logits_bias(jmod, jparams, jcfg,
                                            jax.random.PRNGKey(0)), tuple)

    calls = {"port": [], "jax": []}

    def counting(side, module, name, label):
        original = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: (
            calls[side].append(label), original(*a, **k))[1])

    counting("port", tfa, "flash_attention", "flash")
    counting("port", reference_attention, "attention", "oracle")
    counting("jax", jfa, "flash_attention", "flash")
    counting("jax", jref, "attention", "oracle")
    x = images((2, 48, 48, 3))
    with torch.no_grad():
        vit.apply(tparams, torch.from_numpy(x), cfg)
        vit.apply(tparams, torch.from_numpy(x), cfg, gen)
    jvit.apply(jparams, jnp.asarray(x), jcfg)
    jvit.apply(jparams, jnp.asarray(x), jcfg, rng=jax.random.PRNGKey(0))
    assert calls["port"] == calls["jax"] == ["flash"] * 2 + ["oracle"] * 2

    blocks = []
    apply_block = block_vjp.block_apply
    monkeypatch.setattr(block_vjp, "block_apply",
                        lambda *a: blocks.append(1) or apply_block(*a))
    rope = ViTConfig(**small_kw("rope-axial", attention_impl="flash_block",
                                **RATES))
    _, rparams = both_params(small_kw("rope-axial"))
    x = torch.from_numpy(images((2, 32, 32, 3)))
    with torch.no_grad():
        vit.apply(rparams, x, rope, torch.Generator().manual_seed(0))
        assert not blocks  # dropout: the per-call boundary
        vit.apply(rparams, x, rope)
    assert len(blocks) == rope.depth


def test_train_rows_draw_from_their_own_generators(monkeypatch):
    """Each accumulation row gets step_generators(seed, epoch, row); the
    same (seed, epoch, row) draws the same, another epoch or row not."""
    seen = []
    make = ts.step_generators
    monkeypatch.setattr(ts, "step_generators",
                        lambda *a: seen.append(a[:3]) or make(*a))
    kw = small_kw("none", in_chans=1, **RATES)
    cfg = ViTConfig(**kw)
    _, params = both_params(kw)
    bundle = datasets.synthetic("mnist", n_train=16, n_test=2, seed=0)
    step = ts.make_train_step(
        cfg, lambda g, s, p: (p, s),
        ts.make_preprocess(cfg, bundle.mean, bundle.std, 28, augment=True),
        accum=2, seed=5)
    step(params, None, 2, torch.from_numpy(bundle.train_x),
         torch.from_numpy(bundle.train_y), torch.arange(16).reshape(4, 4),
         epoch=3)
    assert seen == [(5, 3, 2), (5, 3, 3)]

    def first_draw(*args):
        return torch.rand(8, generator=make(*args, "cpu")[1])

    assert torch.equal(first_draw(5, 3, 2), first_draw(5, 3, 2))
    assert not torch.equal(first_draw(5, 3, 2), first_draw(5, 4, 2))
    assert not torch.equal(first_draw(5, 3, 2), first_draw(5, 3, 3))
    assert not torch.equal(first_draw(5, 3, 2), first_draw(6, 3, 2))
    aug, drop = make(5, 3, 2, "cpu")
    assert not torch.equal(torch.rand(8, generator=aug),
                           torch.rand(8, generator=drop))


def small_data(monkeypatch):
    def get_dataset(dataset, data_dir="./data", use_synthetic=False, seed=0):
        assert use_synthetic
        return datasets.synthetic(dataset, n_train=64, n_test=32, seed=seed)

    monkeypatch.setattr(datasets, "get_dataset", get_dataset)


def test_fit_trains_with_every_regularisation(tmp_path, monkeypatch):
    """fit() on the CPU with dropout, attention-prob dropout, drop-path and
    augmentation: finite losses; the masks of epoch 2 differ from epoch
    1's; evaluation draws none (6 masks per block and train row, exactly);
    the attention-dropout warning only above 2048 tokens."""
    small_data(monkeypatch)
    tape = record_masks(monkeypatch)
    cfg = ViTConfig(**small_kw("rope-mixed", in_chans=1, patch_size=4,
                               attn_drop_rate=0.1, **RATES))
    tcfg = TrainConfig(dataset="mnist", batch_size=32, epochs=2,
                       synthetic_data=True, augment=True,
                       log_dir=str(tmp_path / "logs"),
                       ckpt_dir=str(tmp_path / "ckpts"))
    summary = loop.fit(cfg, tcfg, verbose=False, device="cpu")
    for h in summary["history"]:
        assert all(math.isfinite(h[k]) for k in ("train_loss", "test_loss"))
    per_epoch = 2 * cfg.depth * 6  # 2 train rows, no eval draws
    assert len(tape) == 2 * per_epoch
    assert not np.array_equal(tape[0], tape[per_epoch])
    assert (tmp_path / "ckpts" / "mnist_rope-mixed_best.npz").exists()
    with pytest.warns(UserWarning, match="attn_drop_rate"):
        with pytest.raises(ValueError, match="does not support dropout"):
            loop.fit(ViTConfig(**dict(vars(cfg), img_size=184)),
                     dataclasses.replace(tcfg, augment=False, q_chunk=512),
                     verbose=False, device="cpu")


def test_train_cli_takes_the_regularisation_flags(tmp_path, monkeypatch,
                                                  capsys):
    small_data(monkeypatch)
    summary = train_cli.main([
        "--dataset", "cifar10", "--synthetic", "--epochs", "1",
        "--batch_size", "32", "--depth", "1", "--embed_dim", "32",
        "--num_heads", "2", "--pos_encoding", "relative", "--drop_rate",
        "0.1", "--attn_drop_rate", "0.1", "--drop_path_rate", "0.1",
        "--augment", "--log_dir", str(tmp_path / "logs"), "--ckpt_dir",
        str(tmp_path / "ckpts"), "--device", "cpu"])
    assert "Done. Best Test Acc" in capsys.readouterr().out
    row = summary["history"][0]
    assert math.isfinite(row["train_loss"]) and math.isfinite(
        row["test_loss"])
    assert glob.glob(str(tmp_path / "logs" / "cifar10_relative_*.csv"))
