"""PyTorch port, serving artifacts (serving.export_model / save_artifact /
load_artifact / Predictor.from_artifact, `torch.export` `.pt2`), the
serving forward's custom ops, and int8 / --export / --artifact through the
predict and serve CLIs, on the CPU.

Tolerances:

* An artifact replays bit-equal to Predictor.from_params on the same
  params, float32 and every int8 mode, at batches 1, 5 and 37 from one
  export (a symbolic batch): the same aten ops and custom ops, replayed.
* The float32 artifact within 2e-3 of the JAX package's Predictor (its
  Pallas kernels in interpret mode): the serving slice's tolerance
  (tests/test_torch_serving.py).
* The custom ops equal the wrappers' plain twins bit for bit (the same
  function), their outputs laid out as their fake tensors say.
* CLI predictions equal the Predictor's; --export then --artifact gives the
  same predictions; the HTTP server's predictions equal its Predictor's
  (logits to 1e-6: the server rounds them to 6 decimals).

The model is ViT-tiny/4-like (CIFAR contract, embed 192, 6 heads, N = 65)
at depth 2, rope-mixed (learnable frequencies in the artifact).
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from vit_rpe_rope_tpu import serving as jserving
from vit_rpe_rope_tpu.configs import ViTConfig as JaxViTConfig
from vit_rpe_rope_tpu_torch import serving
from vit_rpe_rope_tpu_torch.cli import predict, serve
from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.data.datasets import NORMALIZATION
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.ops import flash_attention as tfa
from vit_rpe_rope_tpu_torch.parallel.mesh import Mesh, make_mesh
from vit_rpe_rope_tpu_torch.utils import checkpoint

KW = dict(img_size=32, patch_size=4, embed_dim=192, depth=2, num_heads=6,
          pos_encoding="rope-mixed")
MEAN, STD = NORMALIZATION["cifar10"]
MODES = [None, "w8a8", "w8a8-static", "w8a16"]
BATCHES = (1, 5, 37)


@pytest.fixture(autouse=True)
def one_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and the
    workers of a parallel test run do not compete for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def uint8_images(n, size=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def int8_flags(mode, calib):
    if mode is None:
        return []
    flags = ["--int8", "--int8_mode", mode]
    return flags + (["--calib", calib] if mode == "w8a8-static" else [])


@pytest.fixture(scope="module")
def deployed(tmp_path_factory):
    """A seeded checkpoint, its inputs, and one artifact per mode exported
    by the predict CLI (which classifies the inputs on the way)."""
    tmp = tmp_path_factory.mktemp("export")
    torch.set_num_threads(1)
    cfg = ViTConfig(**KW)
    params = vit.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    ckpt = checkpoint.save(str(tmp / "cifar10_rope-mixed_best.npz"), params,
                           vit.buffers(cfg),
                           aliases=vit.reference_alias_keys(cfg))
    images = uint8_images(max(BATCHES), seed=1)
    inputs, calib = str(tmp / "in.npz"), str(tmp / "calib.npz")
    np.savez(inputs, images=images,
             labels=np.random.default_rng(2).integers(0, 10, len(images)))
    np.savez(calib, images=uint8_images(8, seed=3))
    out = {"ckpt": ckpt, "images": images, "inputs": inputs,
           "calib": calib, "params": params, "cfg": cfg, "preds": {},
           "artifacts": {}}
    out["served"], out["loaded"] = {}, {}
    for mode in MODES:
        path = str(tmp / f"model_{mode or 'f32'}.pt2")
        out["preds"][mode] = predict.main(
            [ckpt, "--input", inputs, "--export", path, "--batch_size", "16",
             "--device", "cpu", *int8_flags(mode, calib)])
        out["artifacts"][mode] = path
        exported, meta = out["loaded"][mode] = serving.load_artifact(path)
        out["served"][mode] = serving.Predictor(
            exported.module(), meta["in_shape"], device="cpu")
    return out


def live_predictor(deployed, mode):
    """Predictor.from_params on the state the CLI built for `mode`."""
    calib_u8 = None
    if mode == "w8a8-static":
        with np.load(deployed["calib"]) as z:
            calib_u8 = z["images"]
    params, cfg, mean, std, native, _ = serving.load_serving_state(
        deployed["ckpt"], int8=mode or False, calib_images_u8=calib_u8,
        device="cpu")
    return serving.Predictor.from_params(params, cfg, mean, std, native,
                                         device="cpu", int8=mode or False)


@pytest.mark.parametrize("mode", MODES)
def test_artifact_and_predict_cli_per_mode(deployed, mode, capsys):
    """The artifact replays bit-equal to the live Predictor at batches 1, 5
    and 37; --int8 --int8_mode (and --calib) classify as the Predictor
    does; --export then --artifact predicts the same classes."""
    live = live_predictor(deployed, mode)
    served = deployed["served"][mode]
    assert served.in_shape == (32, 32, 3) == live.in_shape
    for b in BATCHES:
        got = served.logits(deployed["images"][:b])
        want = live.logits(deployed["images"][:b])
        assert got.shape == (b, 10) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"batch {b}")
    np.testing.assert_array_equal(deployed["preds"][mode],
                                  live.predict(deployed["images"]))
    capsys.readouterr()
    again = predict.main(["--artifact", deployed["artifacts"][mode],
                          "--input", deployed["inputs"], "--batch_size", "16",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_array_equal(again, deployed["preds"][mode])
    assert "batch-polymorphic" in out and "accuracy:" in out


def test_f32_artifact_matches_jax_predictor(deployed):
    """The float32 artifact against the JAX package's Predictor (Pallas
    kernels in interpret mode) on the same params."""
    jcfg = JaxViTConfig(**KW, attention_impl="flash")
    jparams = {k: np.asarray(v) for k, v in deployed["params"].items()}
    images = deployed["images"][:5]
    want = jserving.Predictor.from_params(jparams, jcfg, MEAN, STD,
                                          32).logits(images)
    got = deployed["served"][None].logits(images)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_artifact_holds_the_custom_ops_and_no_model_code(deployed):
    """The w8a8 artifact's graph calls the attention through the custom
    op, once a block, and the int8 products through torch._int_mm; every
    node is a torch op (no Python model code); its description names the
    device type and input shape it serves, and its data-parallel width
    (one device). (chip_smoke.py phase 19 loads
    the card's artifacts in a fresh process that imports only
    vit_rpe_rope_tpu_torch.serving.)"""
    exported, meta = deployed["loaded"]["w8a8"]
    assert meta == {"device_type": "cpu", "in_shape": [32, 32, 3],
                    "data_parallel": 1}
    targets = [n.target for n in exported.graph.nodes
               if n.op == "call_function"]
    assert targets.count(torch.ops.vit_rpe_rope.attn_fwd.default) == 2
    assert torch.ops.aten._int_mm.default in targets
    assert all(isinstance(t, torch._ops.OpOverload)
               or getattr(t, "__module__", "") in ("_operator", "operator")
               for t in targets), set(map(str, targets))


def test_artifact_on_the_streaming_route(monkeypatch, int8="w8a16"):
    """Above a STREAMING_THRESHOLD lowered to 16 (N = 17, relative, the
    bias generated from the table, bfloat16 q, k, v): the streaming custom
    op in the graph, replayed bit-equal to the live Predictor; a static
    batch, which another batch size does not pass."""
    monkeypatch.setattr(tfa, "STREAMING_THRESHOLD", 16)
    cfg = ViTConfig(img_size=16, patch_size=4, embed_dim=32, depth=2,
                    num_heads=2, pos_encoding="relative")
    params = vit.init_params(torch.Generator().manual_seed(4), cfg,
                             device="cpu")
    exported = serving.export_model(params, cfg, MEAN, STD, 16, batch=3,
                                    int8=int8, device="cpu")
    targets = [n.target for n in exported.graph.nodes]
    assert targets.count(torch.ops.vit_rpe_rope.attn_stream_fwd.default) == 2
    assert torch.ops.vit_rpe_rope.attn_fwd.default not in targets
    images = uint8_images(3, size=16, seed=5)
    want = serving.Predictor.from_params(params, cfg, MEAN, STD, 16,
                                         device="cpu", int8=int8)
    with torch.inference_mode():
        got = exported.module()(torch.from_numpy(images))
    np.testing.assert_array_equal(got.numpy(), want.logits(images))
    with pytest.raises(Exception):
        exported.module()(torch.from_numpy(uint8_images(4, size=16)))


def test_predictor_pads_ragged_batches():
    seen = []

    def call(x):
        seen.append(tuple(x.shape))
        return x.float().mean(dim=(1, 2, 3))[:, None] * torch.ones(1, 3)

    pred = serving.Predictor(call, (4, 4, 3), pad_to=4)
    images = uint8_images(6, size=4, seed=6)
    got = pred.logits(images)
    assert seen == [(8, 4, 4, 3)] and got.shape == (6, 3)
    np.testing.assert_allclose(got[:, 0], images.reshape(6, -1).mean(-1),
                               rtol=1e-6)
    assert pred.logits(images[0]).shape == (1, 3)  # HWC -> a batch of 1
    assert seen[-1] == (4, 4, 4, 3)


def test_wrong_device_and_mesh_raise(deployed):
    """An artifact on another device type raises. export_model(mesh=) is
    ported: over a 2-entry CPU mesh it exports the one-device program for
    half a batch and records the width; a static batch must divide it, and
    a process group's mesh is not a serving mesh."""
    with pytest.raises(ValueError, match="exported for cpu.*on cuda"):
        serving.Predictor.from_artifact(deployed["artifacts"][None],
                                        device="cuda")
    cfg, params = deployed["cfg"], deployed["params"]
    mesh = make_mesh(num_devices=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="static batch 5 must divide"):
        serving.export_model(params, cfg, MEAN, STD, 32, batch=5, mesh=mesh)
    with pytest.raises(ValueError, match="not a process group"):
        serving.export_model(params, cfg, MEAN, STD, 32,
                             mesh=Mesh(devices=("cpu",), ranks=(0, 1)))
    exported = serving.export_model(params, cfg, MEAN, STD, 32, batch=4,
                                    mesh=mesh)
    assert exported.data_parallel == 2
    assert tuple(serving._artifact_input(exported).shape) == (2, 32, 32, 3)
    images = deployed["images"][:4]
    call = serving.data_parallel_call([exported.module()] * 2,
                                      [torch.device("cpu")] * 2)
    with torch.no_grad():
        got = call(torch.from_numpy(images)).numpy()
    np.testing.assert_array_equal(
        got, np.concatenate([deployed["served"][None].logits(images[:2]),
                             deployed["served"][None].logits(images[2:])]))


def test_static_mode_needs_calibration_images(deployed, capsys):
    with pytest.raises(ValueError, match="w8a8-static"):
        serving.load_serving_state(deployed["ckpt"], int8="w8a8-static",
                                   device="cpu")
    with pytest.raises(SystemExit) as exc:
        predict.main([deployed["ckpt"], "--int8", "--int8_mode",
                      "w8a8-static", "--device", "cpu"])
    assert exc.value.code == 2
    assert "needs calibration images" in capsys.readouterr().err


def post(url, images, query=""):
    buf = io.BytesIO()
    np.savez(buf, images=images)
    req = urllib.request.Request(url + "/predict" + query, data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("how", ["artifact", "int8"])
def test_serve_cli_artifact_and_int8_over_http(deployed, how):
    if how == "artifact":
        argv = ["--artifact", deployed["artifacts"]["w8a8"]]
        predictor = deployed["served"]["w8a8"]
    else:
        argv = [deployed["ckpt"], "--int8", "--int8_mode", "w8a16"]
        predictor = live_predictor(deployed, "w8a16")
    server = serve.main([*argv, "--port", "0", "--device", "cpu"],
                        serve_forever=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            assert json.loads(r.read())["input_shape"] == [32, 32, 3]
        images = deployed["images"][:4]
        reply = post(url, images, "?logits=1")
        assert reply["predictions"] == predictor.predict(images).tolist()
        np.testing.assert_allclose(np.array(reply["logits"]),
                                   predictor.logits(images), atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_custom_ops_are_the_wrappers_twins(dtype):
    """torch.ops.vit_rpe_rope.attn_fwd / attn_stream_fwd on CPU tensors:
    the plain twins bit for bit, out laid out as [B, N, H, D] (as the fake
    tensors say); torch.library.opcheck on the schema, fakes and
    dispatch."""
    gen = torch.Generator().manual_seed(7)
    b, h, n, d = 2, 3, 17, 16
    qkv = torch.randn((b, n, 3, h, d), generator=gen).to(dtype)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # strided, as in a block
    phase = torch.rand((h, n - 1, d // 2), generator=gen)
    bias, cos, sin = tfa.prepare_pe(h, n, q.device, None,
                                    (torch.cos(phase), torch.sin(phase)))
    table = torch.randn((h, 2 * n - 1), generator=gen)
    scale = d ** -0.5
    out = torch.ops.vit_rpe_rope.attn_fwd(q, k, v, scale, bias, cos, sin)
    assert out.stride() == (n * h * d, d, h * d, 1) and out.dtype == dtype
    assert torch.equal(out, tfa.attention_plain(q, k, v, scale, bias, cos,
                                                sin))
    out, lse = torch.ops.vit_rpe_rope.attn_stream_fwd(
        q, k, v, scale, None, None, None, None, 0, table)
    want, want_lse = tfa.attention_stream_plain(q, k, v, scale, rel=table)
    assert out.stride() == (n * h * d, d, h * d, 1)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    coeff = 0.05 * torch.randn((h, 4), generator=gen)
    out, _ = torch.ops.vit_rpe_rope.attn_stream_fwd(
        q, k, v, scale, None, cos, sin, coeff, 4, None)
    assert torch.equal(out, tfa.attention_stream_plain(
        q, k, v, scale, cos=cos, sin=sin, poly=(coeff, 4))[0])
    torch.library.opcheck(torch.ops.vit_rpe_rope.attn_fwd.default,
                          (q, k, v, scale, bias, cos, sin),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(torch.ops.vit_rpe_rope.attn_stream_fwd.default,
                          (q, k, v, scale, None, None, None, None, 0, table),
                          test_utils=("test_schema", "test_faketensor"))
