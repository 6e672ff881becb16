"""PyTorch port, CLIs: the predict CLI against the JAX package's on one
checkpoint, the HTTP server against the Predictor it wraps, the flag
surfaces of the three CLIs against the JAX package's, a train CLI run on
the CPU, the JAX CLIs' conflict errors, and the flags of features not
ported yet, which must be refused. (int8, --export and --artifact through
the CLIs: tests/test_torch_export.py.)"""

import io
import json
import pathlib
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu.cli import predict as jpredict
from vit_rpe_rope_tpu.cli import train as jtrain
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu.models import vit as jvit
from vit_rpe_rope_tpu.ops import flash_attention as jfa
from vit_rpe_rope_tpu.utils import checkpoint as jckpt
from vit_rpe_rope_tpu_torch import serving
from vit_rpe_rope_tpu_torch.cli import predict, serve
from vit_rpe_rope_tpu_torch.cli import train
from vit_rpe_rope_tpu_torch.data import datasets
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.data.datasets import NORMALIZATION
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import block_vjp
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.utils import checkpoint

import torch_cp_worker
import torch_pp_worker
from torch_tp_worker import launch

KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
          pos_encoding="relative")


def write_inputs(tmp_path, n=12):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, (n,))
    path = str(tmp_path / "batch.npz")
    np.savez(path, images=images, labels=labels)
    return path, images, labels


def test_predict_cli_matches_jax_cli(tmp_path, capsys):
    cfg = JaxViTConfig(**KW)
    params = jvit.init_params(jax.random.PRNGKey(0), cfg)
    ckpt = jckpt.save(str(tmp_path / "cifar10_relative_best.npz"), params,
                      jvit.buffers(cfg), aliases=jvit.reference_alias_keys(cfg))
    inputs, _, labels = write_inputs(tmp_path)
    want = jpredict.main([ckpt, "--input", inputs, "--batch_size", "5"])
    capsys.readouterr()
    got = predict.main([ckpt, "--input", inputs, "--batch_size", "5",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert "relative ViT d64 depth 2 heads 4" in out
    acc = 100.0 * float((got == labels).mean())
    assert f"accuracy: {acc:.2f}% (12 examples)" in out


def test_predict_cli_matches_jax_cli_on_the_streaming_route(tmp_path, capsys,
                                                            monkeypatch):
    """A relative checkpoint at N=145 (img 48, patch 4; the grid comes from
    the table's shape) above a threshold lowered to 128 in both packages:
    both CLIs classify through their streaming kernels ("auto" is the
    kernel above the threshold in the JAX package too) with the bias
    generated from the table."""
    monkeypatch.setattr(jfa, "STREAMING_THRESHOLD", 128)
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 128)
    cfg = JaxViTConfig(**dict(KW, img_size=48, patch_size=4))
    params = jvit.init_params(jax.random.PRNGKey(1), cfg)
    ckpt = jckpt.save(str(tmp_path / "cifar10_relative_best.npz"), params,
                      jvit.buffers(cfg), aliases=jvit.reference_alias_keys(cfg))
    inputs, _, _ = write_inputs(tmp_path)
    want = jpredict.main([ckpt, "--input", inputs, "--batch_size", "5"])
    capsys.readouterr()
    before = tfa.LAUNCHES_STREAM_FWD
    got = predict.main([ckpt, "--input", inputs, "--batch_size", "5",
                        "--device", "cpu"])
    assert tfa.LAUNCHES_STREAM_FWD == before  # the CPU runs the twin
    out = capsys.readouterr().out
    np.testing.assert_array_equal(got, want)
    assert "relative ViT d64 depth 2 heads 4 patch 4 @ 48px" in out


@pytest.mark.parametrize("flag", [
    ["--artifact", "a.pt2", "--export", "m.pt2"],
    ["ckpt.npz", "--artifact", "a.pt2"],
    ["--artifact", "a.pt2", "--int8"],
    ["ckpt.npz", "--export_data_parallel", "2"]])
def test_predict_cli_refuses_unported_flags(flag, capsys, tmp_path):
    """The JAX CLI's conflict errors: an artifact with --export, with a
    checkpoint, with --int8, each before any file is read. A data-parallel
    export (--export_data_parallel 2) is no longer refused: on the CPU it
    runs over two "cpu" entries, and its artifact, served through
    --artifact, splits each batch in two and predicts as the checkpoint
    does."""
    if "--export_data_parallel" in flag:
        cfg = JaxViTConfig(**KW)
        params = jvit.init_params(jax.random.PRNGKey(2), cfg)
        ckpt = jckpt.save(str(tmp_path / "cifar10_relative_best.npz"),
                          params, jvit.buffers(cfg),
                          aliases=jvit.reference_alias_keys(cfg))
        inputs, _, _ = write_inputs(tmp_path, n=7)
        artifact = str(tmp_path / "dp2.pt2")
        want = predict.main([ckpt, "--input", inputs, "--export", artifact,
                             *flag[1:], "--device", "cpu"])
        assert "sharded over 2 devices" in capsys.readouterr().out
        _, meta = serving.load_artifact(artifact)
        assert meta["data_parallel"] == 2
        got = predict.main(["--artifact", artifact, "--input", inputs,
                            "--batch_size", "5", "--device", "cpu"])
        np.testing.assert_array_equal(got, want)
        return
    with pytest.raises(SystemExit) as exc:
        predict.main(flag)
    assert exc.value.code == 2
    assert "cannot be combined with a checkpoint, --export, or --int8" \
        in capsys.readouterr().err


@pytest.mark.parametrize("flag", [
    ["ckpt.npz", "--artifact", "a.pt2"],
    ["ckpt.npz", "--int8", "--int8_mode", "w8a8-static"]])
def test_serve_cli_refuses_unported_flags(flag, capsys):
    """The JAX server's conflict errors: an artifact with a checkpoint;
    w8a8-static without --calib images."""
    with pytest.raises(SystemExit) as exc:
        serve.main(flag, serve_forever=False)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert ("needs --calib" if "--int8" in flag
            else "cannot be combined with a checkpoint or --int8") in err


@pytest.fixture(scope="module")
def server_and_predictor(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    cfg = ViTConfig(**KW)
    params = vit.init_params(torch.Generator().manual_seed(1), cfg,
                             device="cpu")
    ckpt = checkpoint.save(str(tmp / "m.npz"), params, vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    server = serve.main([ckpt, "--port", "0", "--device", "cpu",
                         "--grid_size", "4", "--max_batch", "8"],
                        serve_forever=False)
    mean, std = NORMALIZATION["cifar10"]
    predictor = serving.Predictor.from_params(params, cfg, mean, std, 32,
                                              device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", predictor
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def post(url, images, query=""):
    buf = io.BytesIO()
    np.savez(buf, images=images)
    req = urllib.request.Request(url + "/predict" + query, data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_health_and_predict_match_predictor(server_and_predictor):
    url, predictor = server_and_predictor
    with urllib.request.urlopen(url + "/health", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok",
                                        "input_shape": [32, 32, 3]}
    images = np.random.default_rng(2).integers(0, 256, (6, 32, 32, 3),
                                               dtype=np.uint8)
    reply = post(url, images, "?logits=1")
    assert reply["predictions"] == predictor.predict(images).tolist()
    np.testing.assert_allclose(np.array(reply["logits"]),
                               predictor.logits(images), atol=1e-6)
    assert post(url, images[0])["predictions"] == \
        predictor.predict(images[:1]).tolist()


def test_http_error_paths(server_and_predictor):
    url, _ = server_and_predictor
    for images, code in ((np.zeros((1, 16, 16, 3), np.uint8), 400),
                         (np.zeros((9, 32, 32, 3), np.uint8), 413),
                         (np.zeros((1, 32, 32, 3), np.float32), 400)):
        with pytest.raises(urllib.error.HTTPError) as exc:
            post(url, images)
        assert exc.value.code == code
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert exc.value.code == 404


def flag_surface(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type,
                     a.nargs, a.const)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["predict", "serve"])
def test_serving_parsers_match_jax_parsers(name):
    """The predict and serve CLIs take the JAX package's flags (int8,
    --int8_mode, --calib, --export, --artifact, ...) with the same
    defaults and choices, plus --device."""
    from vit_rpe_rope_tpu.cli import serve as jserve

    ours = {"predict": predict, "serve": serve}[name]
    jax_cli = {"predict": jpredict, "serve": jserve}[name]
    got = flag_surface(ours.build_parser())
    want = flag_surface(jax_cli.build_parser())
    assert got.pop("device") == (("--device",), None, None, str, None, None)
    assert got == want


def test_train_parser_matches_jax_parser():
    got = flag_surface(train.build_parser())
    want = flag_surface(jtrain.build_parser())
    assert got.pop("device") == (("--device",), None, None, str, None, None)
    assert got.pop("dist_backend") == (("--dist_backend",), None,
                                       ["nccl", "gloo"], str, None, None)
    assert got == want
    args = train.build_parser().parse_args(["--no-poly_shared_heads"])
    assert args.poly_shared_heads is False and args.dataset == "mnist"


@pytest.mark.parametrize("flag", [
    ["--model_parallel", "2"], ["--sequence_parallel", "2"],
    ["--pipeline_parallel", "2"], ["--zero1"],
    # bounded stepping over the KV ring, and with dropout or augmentation
    ["--q_chunk", "64", "--sequence_parallel", "2"],
    ["--q_chunk", "64", "--drop_rate", "0.1"], ["--q_chunk", "64",
                                                 "--augment"],
    ["--q_chunk", "64", "--attn_drop_rate", "0.1"],
    ["--q_chunk", "64", "--drop_path_rate", "0.1"],
    ["--sequence_parallel", "2", "--model_parallel", "2"],
    ["--pipeline_parallel", "2", "--sequence_parallel", "2"]])
def test_train_cli_refuses_unported_flags(flag, capsys, tmp_path,
                                          monkeypatch):
    """No feature is left unported. --sequence_parallel with
    --model_parallel or with --pipeline_parallel (the compositions, ported:
    tests/test_torch_tp_cp.py and tests/test_torch_pp_tp_cp.py train
    through the CLI on gloo ranks) refuse --zero1, in the JAX
    TrainConfig's words. Dropout, drop-path and --augment
    are ported (tests/test_torch_regularize.py); the bounded driver
    (--q_chunk) refuses them, as the JAX package's does. --zero1 is ported
    (tests/test_torch_data_parallel.py): it trains through the CLI.
    --model_parallel is ported (tests/test_torch_tensor_parallel.py): it
    trains through the CLI on two gloo ranks (tests/torch_tp_worker.py),
    rank 0 alone writing the CSV and the checkpoints. --sequence_parallel
    is ported (tests/test_torch_context_parallel.py): alone and with
    --q_chunk (the bounded driver's ring) it trains through the CLI on two
    gloo ranks (tests/torch_cp_worker.py). --pipeline_parallel is ported
    (tests/test_torch_pipeline_parallel.py): it trains through the CLI on
    two gloo ranks (tests/torch_pp_worker.py), each holding one of the two
    blocks, rank 0 alone writing the CSV and the checkpoints in the
    reference layout."""
    if flag == ["--pipeline_parallel", "2"]:
        torch_pp_worker.launch(
            "cli", tmp_path, 2, "--synthetic", *flag, "--pp_microbatches",
            "4", "--epochs", "1", "--batch_size", "16", "--depth", "2",
            "--embed_dim", "32", "--num_heads", "2", "--device", "cpu")
        ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        assert ranks[1]["log_file"] is None
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert np.isfinite(ranks[0]["history"][0]["train_loss"])
        assert [p.name for p in (tmp_path / "logs").glob("*.csv")] == [
            pathlib.Path(ranks[0]["log_file"]).name]
        with np.load(tmp_path / "checkpoints" / "mnist_absolute_last.npz") \
                as z:
            assert z["blocks.1.attn.qkv.weight"].shape == (96, 32)
            assert int(z["__opt.0"]) == 2
        return
    if "--sequence_parallel" in flag and not {
            "--model_parallel", "--pipeline_parallel"} & set(flag):
        torch_cp_worker.launch(
            "cli", tmp_path, 2, "--synthetic", *flag, "--epochs", "1",
            "--batch_size", "16", "--depth", "1", "--embed_dim", "32",
            "--num_heads", "2", "--pos_encoding", "rope-mixed", "--device",
            "cpu")
        ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        assert ranks[1]["log_file"] is None
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert np.isfinite(ranks[0]["history"][0]["train_loss"])
        assert [p.name for p in (tmp_path / "logs").glob("*.csv")] == [
            pathlib.Path(ranks[0]["log_file"]).name]
        with np.load(tmp_path / "checkpoints" / "mnist_rope-mixed_last.npz") \
                as z:
            assert z["blocks.0.attn.qkv.weight"].shape == (96, 32)
            assert int(z["__opt.0"]) == 2
        return
    if flag == ["--model_parallel", "2"]:
        launch("cli", tmp_path, 2, "--synthetic", *flag, "--epochs", "1",
               "--batch_size", "16", "--depth", "1", "--embed_dim", "32",
               "--num_heads", "2", "--device", "cpu")
        ranks = [json.loads((tmp_path / f"cli_rank{r}.json").read_text())
                 for r in (0, 1)]
        assert [r["num_devices"] for r in ranks] == [2, 2]
        assert ranks[1]["log_file"] is None
        for r in ranks:  # the host clock's throughput differs
            del r["history"][0]["images_per_sec"]
        assert ranks[0]["history"] == ranks[1]["history"]
        assert [p.name for p in (tmp_path / "logs").glob("*.csv")] == [
            pathlib.Path(ranks[0]["log_file"]).name]
        with np.load(tmp_path / "checkpoints" / "mnist_absolute_last.npz") \
                as z:
            assert z["blocks.0.attn.qkv.weight"].shape == (96, 32)
            assert int(z["__opt.0"]) == 2
        return
    if flag == ["--zero1"]:
        monkeypatch.setattr(
            datasets, "get_dataset",
            lambda dataset, data_dir, use_synthetic, seed: datasets.synthetic(
                dataset, n_train=32, n_test=16, seed=seed))
        summary = train.main([
            "--synthetic", *flag, "--epochs", "1", "--batch_size", "16",
            "--depth", "1", "--embed_dim", "32", "--num_heads", "2",
            "--log_dir", str(tmp_path / "logs"), "--ckpt_dir",
            str(tmp_path / "ckpts"), "--device", "cpu"])
        assert "Done. Best Test Acc" in capsys.readouterr().out
        assert summary["num_devices"] == 1
        with np.load(tmp_path / "ckpts" / "mnist_absolute_last.npz") as z:
            assert int(z["__opt.0"]) == 2 and z["__opt.1"].ndim == 1
        return
    if "--sequence_parallel" in flag and {"--model_parallel",
                                          "--pipeline_parallel"} & set(flag):
        with pytest.raises(ValueError, match=(
                "zero1 is incompatible with pipeline parallelism > 1"
                if "--pipeline_parallel" in flag else
                "zero1 composes with sequence_parallel OR model_parallel, "
                "not the 3-axis product")):
            train.main(["--synthetic", *flag, "--zero1"])
        return
    with pytest.raises(SystemExit) as exc:
        train.main(["--synthetic", *flag])
    assert exc.value.code == 2
    assert "does not support" in capsys.readouterr().err


def test_train_cli_runs_flash_block_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    """--attention_impl flash_block (no longer refused) trains through
    fit(): one boundary per block, the attention on the kernels' twins."""
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: datasets.synthetic(
            dataset, n_train=32, n_test=16, seed=seed))
    calls = []
    apply = block_vjp.block_apply
    monkeypatch.setattr(block_vjp, "block_apply",
                        lambda *a: calls.append(1) or apply(*a))
    summary = train.main([
        "--dataset", "cifar10", "--synthetic", "--epochs", "1",
        "--batch_size", "16", "--depth", "1", "--embed_dim", "32",
        "--num_heads", "2", "--pos_encoding", "rope-mixed",
        "--attention_impl", "flash_block", "--log_dir",
        str(tmp_path / "logs"), "--ckpt_dir", str(tmp_path / "ckpts"),
        "--device", "cpu"])
    assert "Done. Best Test Acc" in capsys.readouterr().out
    assert summary["history"][0]["train_loss"] > 0
    assert calls  # the blocks went through block_apply
    assert (tmp_path / "ckpts" / "cifar10_rope-mixed_last.npz").exists()


def test_train_cli_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(
        datasets, "get_dataset",
        lambda dataset, data_dir, use_synthetic, seed: datasets.synthetic(
            dataset, n_train=64, n_test=32, seed=seed))
    summary = train.main([
        "--dataset", "cifar10", "--synthetic", "--epochs", "1",
        "--batch_size", "32", "--depth", "1", "--embed_dim", "32",
        "--num_heads", "2", "--pos_encoding", "rope-mixed",
        "--grad_accum", "2", "--steps_per_dispatch", "1",
        "--log_dir", str(tmp_path / "logs"), "--ckpt_dir",
        str(tmp_path / "ckpts"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Done. Best Test Acc" in out and "devices: 1" in out
    assert summary["log_file"].startswith(str(tmp_path / "logs" /
                                              "cifar10_rope-mixed_"))
    assert (tmp_path / "ckpts" / "cifar10_rope-mixed_last.npz").exists()
