"""PyTorch port, resumable train state across packages: a `_last.npz`
written by the JAX package's fit resumes in the port's fit, and the reverse.
The file holds the params, the optimizer leaves [count, mu, nu, schedule
count] with each moment flattened to one f32 vector in the depth-stacked
key order, then the epoch and the best accuracy."""

import jax
import numpy as np
import torch

from vit_rpe_rope_tpu.configs import TrainConfig as JaxTrainConfig
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.data import datasets as jdatasets
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.train import loop as jloop
from vit_rpe_rope_tpu.utils.flatten import Flattener as JaxFlattener
from vit_rpe_rope_tpu_torch.configs import TrainConfig, ViTConfig
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.train import loop
from vit_rpe_rope_tpu_torch.utils import checkpoint

KW = dict(img_size=32, patch_size=8, in_chans=1, embed_dim=32, depth=2,
          num_heads=2, pos_encoding="relative", attention_impl="reference")


def small_data(monkeypatch):
    """Both packages' fit train on 96 synthetic images (3 steps of 32)."""
    def make(module):
        def get_dataset(dataset, data_dir="./data", use_synthetic=False,
                        seed=0):
            assert use_synthetic
            return module.synthetic(dataset, n_train=96, n_test=32, seed=seed)
        return get_dataset

    monkeypatch.setattr(datasets, "get_dataset", make(datasets))
    monkeypatch.setattr(jdatasets, "get_dataset", make(jdatasets))


def common(tmp_path, **kw):
    return dict(dataset="mnist", batch_size=32, synthetic_data=True,
                log_dir=str(tmp_path / "logs"),
                ckpt_dir=str(tmp_path / "ckpts"), seed=0, **kw)


def test_jax_last_state_resumes_in_the_port(tmp_path, monkeypatch):
    small_data(monkeypatch)
    jloop.fit(JaxViTConfig(**KW), JaxTrainConfig(**common(tmp_path, epochs=1)),
              verbose=False)
    last = str(tmp_path / "ckpts" / "mnist_relative_last.npz")
    cfg = ViTConfig(**KW)
    params, leaves, next_epoch, _ = checkpoint.load_train_state(last, 4)
    assert next_epoch == 1

    # The port's canonical moment order is the JAX loop's: its params come
    # back from jax.device_put with sorted keys before they are stacked.
    jparams = jax.device_put(jvit.init_params(jax.random.PRNGKey(0),
                                              JaxViTConfig(**KW)))
    jflat = JaxFlattener(jvit.stack_block_params(jparams,
                                                 JaxViTConfig(**KW)))
    flat = loop.moment_flattener(params, cfg)
    assert flat.keys == jflat.keys and flat.total == jflat.total

    mu, nu, count = loop.opt_from_disk(leaves, flat, cfg, "cpu")
    assert count == 3 and set(mu) == set(params)
    assert all(bool((v >= 0).all()) for v in nu.values())
    for got, want in zip(loop.opt_to_disk((mu, nu, count), flat, cfg),
                         leaves):
        np.testing.assert_array_equal(np.asarray(got), want)

    resumed = loop.fit(cfg, TrainConfig(**common(tmp_path, epochs=2,
                                                 resume=True)),
                       verbose=False, device="cpu")
    assert [h["epoch"] for h in resumed["history"]] == [2]
    with np.load(last) as z:
        assert int(z["__epoch"]) == 1 and int(z["__opt.0"]) == 6


def test_port_last_state_resumes_in_jax(tmp_path, monkeypatch):
    small_data(monkeypatch)
    first = loop.fit(ViTConfig(**KW), TrainConfig(**common(tmp_path,
                                                           epochs=1)),
                     verbose=False, device="cpu")
    last = tmp_path / "ckpts" / "mnist_relative_last.npz"
    with np.load(last) as z:
        assert z["__opt.0"].dtype == np.int32 and z["__opt.1"].ndim == 1
        saved = {k: z[k] for k in z.files if not k.startswith("__")}
    resumed = jloop.fit(JaxViTConfig(**KW),
                        JaxTrainConfig(**common(tmp_path, epochs=2,
                                                resume=True)),
                        verbose=False)
    assert [h["epoch"] for h in resumed["history"]] == [2]
    assert resumed["best_acc"] >= first["best_acc"]
    with np.load(last) as z:
        assert int(z["__epoch"]) == 1 and int(z["__opt.0"]) == 6
        moved = max(float(np.abs(z[k] - saved[k]).max()) for k in saved)
    assert moved > 0  # the JAX run trained on from the port's state
    assert torch.is_tensor(checkpoint.load_train_state(str(last), 4)[0][
        "head.weight"])
