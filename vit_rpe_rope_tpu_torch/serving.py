"""Serving: checkpoint -> (int8) -> (exported artifact) -> Predictor ->
logits / class ids on uint8 images.

The serving input contract is raw dataset-format pixels (uint8 NHWC at the
dataset's native size); normalization and the resize to the model's size run
on the device in front of the forward.

An artifact (`export_model`, `save_artifact`, `.pt2`) is the whole
pipeline — uint8 decode, normalize, resize, forward — traced once by
`torch.export` with the params (float32, or int8 with their scales) held in
it as buffers and a symbolic batch dimension, so one export serves any
batch size. The attention kernels are in its graph as the custom ops of
`ops/flash_attention.py` (`torch.ops.vit_rpe_rope.*`), so replaying it
needs torch and that module, which `load_artifact` imports, but no
checkpoint and no model code. An artifact is for the device type it was
exported on (the kernels on CUDA, their plain twins on the CPU). Python
checks evaluated while tracing (the `--debug_nans` sanitizer) are not in
it: an artifact carries no sanitizer.

Data-parallel serving (the JAX package's mesh= paths): over a mesh of
local devices (parallel.mesh.make_mesh(num_devices=N)) a batch is padded
with zero images to a multiple of the mesh's width, split into equal
shards, one per device, each served by the forward on its device, and the
logits are concatenated on the first device. A data-parallel artifact is
the one-device program and the width it was exported for; loading it where
fewer devices of its type are visible raises. On the CPU a mesh of N "cpu"
entries runs the same padding and splitting.

CLIs: `python -m vit_rpe_rope_tpu_torch.cli.predict` (classify / export /
serve an artifact) and `python -m vit_rpe_rope_tpu_torch.cli.serve` (HTTP).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.models import vit
from vit_rpe_rope_tpu_torch.parallel import mesh as mesh_mod
from vit_rpe_rope_tpu_torch.train import train_step as ts
from vit_rpe_rope_tpu_torch.utils.device import resolve_device

ARTIFACT_SUFFIX = ".pt2"
# The artifact's own description, stored beside the program in the archive.
_META = "serving.json"


def _is_quantized_state(params: dict) -> bool:
    """True when `params` is already quant.quantize_params output, so that
    callers quantize once and share the result across Predictor and
    export_model."""
    return any(k.endswith(":q8") for k in params)


def _int8_mode(int8) -> str | None:
    """The int8 option normalized: False -> None, True -> "w8a8", or an
    explicit mode ("w8a8" / "w8a8-static" / "w8a16")."""
    if not int8:
        return None
    return "w8a8" if int8 is True else str(int8)


def make_infer_fn(cfg: ViTConfig, mean, std, native_size: int, int8=False):
    """(params, images uint8 [B, native, native, C]) -> logits [B, classes]
    with the eval preprocessing (normalize + resize to cfg.img_size) in
    front of the forward. int8: a truthy value expects quantize_params
    output and runs quant.apply_q8 in that mode (True is "w8a8")."""
    preprocess = ts.make_preprocess(cfg, mean, std, native_size)
    mode = _int8_mode(int8)

    def infer(params, images_u8):
        x = preprocess(images_u8)
        if mode is not None:
            from vit_rpe_rope_tpu_torch import quant

            return quant.apply_q8(params, x, cfg, mode=mode)
        return vit.apply(params, x, cfg)

    return infer


def _serving_params(params, cfg, int8, device) -> dict:
    """params (tensors or arrays; float32, or already quantized) -> the
    serving state on `device`: quantized first when int8 asks for it."""
    params = {k: v if isinstance(v, torch.Tensor)
              else torch.from_numpy(np.array(v)) for k, v in params.items()}
    if int8 and not _is_quantized_state(params):
        from vit_rpe_rope_tpu_torch import quant

        params = quant.quantize_params(params, cfg)
    return {k: v.detach().to(device) for k, v in params.items()}


def _serving_devices(mesh, device):
    """The devices a Predictor or an export serves on: the mesh's local
    devices, or the one `device` (default: the CUDA device)."""
    if mesh is None:
        return [resolve_device(device)]
    if mesh.distributed:
        raise ValueError("data-parallel serving takes a mesh of local "
                         "devices (make_mesh(num_devices=...)), not a "
                         "process group's")
    devices = [resolve_device(d) for d in mesh.devices]
    if device is not None and resolve_device(device) != devices[0]:
        raise ValueError(f"device {device} differs from the mesh's first "
                         f"device {devices[0]}")
    return devices


def data_parallel_call(calls, devices):
    """(uint8 batch on devices[0]) -> logits on devices[0]: the batch split
    into len(devices) equal shards, shard i served by calls[i] on
    devices[i], the logits concatenated in order (the JAX batch sharding
    over 'data'). The batch must be a multiple of the width (Predictor
    pads it)."""
    n = len(devices)

    def call(images_u8):
        if images_u8.shape[0] % n:
            raise ValueError(f"batch {images_u8.shape[0]} is not a multiple "
                             f"of the {n}-way data axis")
        shards = images_u8.chunk(n)
        logits = [fn(x.to(d, non_blocking=True))
                  for fn, x, d in zip(calls, shards, devices)]
        return torch.cat([out.to(devices[0]) for out in logits])

    return call


class _Served(torch.nn.Module):
    """The serving pipeline as a module for torch.export: the params as
    buffers (dict keys hold '.' and ':', so they are numbered), forward =
    infer(params, images_u8)."""

    def __init__(self, params: dict, infer):
        super().__init__()
        self._keys = list(params)
        for i, value in enumerate(params.values()):
            self.register_buffer(f"p{i}", value)
        self._infer = infer

    def forward(self, images_u8):
        params = {key: getattr(self, f"p{i}")
                  for i, key in enumerate(self._keys)}
        return self._infer(params, images_u8)


def export_model(params, cfg: ViTConfig, mean, std, native_size: int,
                 batch: int | None = None, int8=False, mesh=None,
                 device=None) -> torch.export.ExportedProgram:
    """torch.export of preprocess + forward on `device` (default: the CUDA
    device), the params held as buffers of the exported module. batch=None
    exports a symbolic batch dimension (any batch >= 1); an int pins a
    static batch. int8 quantizes first where params are float32 (the
    artifact then holds the int8 weights).

    mesh: a mesh of local devices (parallel.mesh.make_mesh) for
    data-parallel serving: the program is exported on its first device for
    one shard of the batch (a static batch must be a multiple of the
    width, and the program takes batch / width), and the width is recorded
    (`data_parallel` on the returned program, kept by save_artifact), so
    that Predictor.from_artifact splits every batch over as many devices."""
    devices = _serving_devices(mesh, device)
    width = len(devices)
    if batch is not None and batch % width:
        raise ValueError(f"static batch {batch} must divide the {width}-way "
                         f"data axis")
    device = devices[0]
    state = _serving_params(params, cfg, int8, device)
    module = _Served(state, make_infer_fn(cfg, mean, std, native_size,
                                          int8=int8))
    example = torch.zeros((2 if batch is None else int(batch) // width,
                           native_size, native_size, cfg.in_chans),
                          dtype=torch.uint8, device=device)
    dynamic = None
    if batch is None:
        dynamic = ({0: torch.export.Dim("batch", min=1)},)
    with torch.no_grad():
        exported = torch.export.export(module, (example,),
                                       dynamic_shapes=dynamic)
    exported.data_parallel = width
    return exported


def _artifact_input(exported):
    """The fake tensor of the artifact's one input: its shape (the batch
    symbolic or pinned) and device."""
    (name,) = exported.graph_signature.user_inputs
    node = next(n for n in exported.graph.nodes
                if n.op == "placeholder" and n.name == name)
    return node.meta["val"]


def artifact_device_type(exported) -> str:
    """The device type ("cuda" / "cpu") an exported program serves on."""
    return _artifact_input(exported).device.type


def save_artifact(path: str, exported) -> str:
    """Write `exported` (export_model's) to `path` (ARTIFACT_SUFFIX added
    where missing), with the device type and input shape it serves and its
    data-parallel width."""
    if not path.endswith(ARTIFACT_SUFFIX):
        path = path + ARTIFACT_SUFFIX
    meta = {"device_type": artifact_device_type(exported),
            "in_shape": [int(d) for d in _artifact_input(exported).shape[1:]],
            "data_parallel": getattr(exported, "data_parallel", 1)}
    torch.export.save(exported, path, extra_files={_META: json.dumps(meta)})
    return path


def load_artifact(path: str):
    """-> (ExportedProgram, meta {"device_type", "in_shape",
    "data_parallel"})."""
    from vit_rpe_rope_tpu_torch.ops import flash_attention  # noqa: F401
    # (importing it registers the kernels' custom ops the graph calls)

    extra = {_META: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    meta.setdefault("data_parallel", 1)  # artifacts written before it
    exported.data_parallel = meta["data_parallel"]
    return exported, meta


def load_serving_state(checkpoint_path: str, dataset: str = "auto",
                       num_heads: int = 6, grid_size: int | None = None,
                       rope_mixed_compat_scramble: bool = False,
                       int8=False, calib_images_u8=None, device=None):
    """Checkpoint (.npz / reference .pth) -> (params, cfg, mean, std,
    native_size, dataset). The architecture is reconstructed from the
    checkpoint's shapes (viz.introspect.infer_vit_config); dataset="auto"
    picks the normalization contract by channel count (1=mnist,
    3=cifar10). params are CPU tensors; Predictor.from_params places them.
    int8: quantized params (quant.quantize_params).

    calib_images_u8: uint8 [B, native, native, C] images for int8
    "w8a8-static", preprocessed with the serving path's normalize / resize
    and fed to quant.calibrate_act_scales as one batch, on `device`
    (default: the CUDA device)."""
    import dataclasses

    from vit_rpe_rope_tpu_torch.data.datasets import NATIVE_SIZE, NORMALIZATION
    from vit_rpe_rope_tpu_torch.utils import checkpoint
    from vit_rpe_rope_tpu_torch.viz import introspect

    state = checkpoint.load_state(checkpoint_path)
    cfg = introspect.infer_vit_config(state, path=checkpoint_path,
                                      num_heads=num_heads,
                                      grid_size=grid_size)
    if rope_mixed_compat_scramble:
        cfg = dataclasses.replace(cfg, rope_mixed_compat_scramble=True)
    if dataset == "auto":
        dataset = "mnist" if cfg.in_chans == 1 else "cifar10"
    mean, std = NORMALIZATION[dataset]
    native = NATIVE_SIZE[dataset]
    params, _ = checkpoint.split_state(state, vit.buffers(cfg))
    if int8:
        from vit_rpe_rope_tpu_torch import quant

        calib = None
        if _int8_mode(int8) == "w8a8-static":
            if calib_images_u8 is None:
                raise ValueError(
                    "int8 mode 'w8a8-static' needs calibration images "
                    "(calib_images_u8= / --calib): per-tensor activation "
                    "scales are measured offline")
            device = resolve_device(device)
            calib_u8 = np.asarray(calib_images_u8)
            if calib_u8.ndim == 3:
                calib_u8 = calib_u8[None]
            pre = ts.make_preprocess(cfg, mean, std, native)
            calib = pre(torch.from_numpy(np.ascontiguousarray(calib_u8))
                        .to(device))
            params = {k: v.to(device) for k, v in params.items()}
        params = quant.quantize_params(params, cfg, calib_images=calib)
        params = {k: v.cpu() for k, v in params.items()}
    return params, cfg, mean, std, native, dataset


class Predictor:
    """Serving wrapper: `logits` and `predict` on uint8 image batches (numpy
    in, numpy out) around `call_fn` (uint8 tensor on `device` -> logits
    tensor): a live forward (`from_params`) or a replayed artifact
    (`from_artifact`, which needs no model code or params), on one device
    or split over a mesh's devices (data_parallel_call). Ragged batches are
    padded with zero images up to a multiple of `pad_to` (the mesh's width)
    and the padding's logits sliced off."""

    def __init__(self, call_fn, in_shape, pad_to: int = 1, device=None):
        self._call = call_fn
        self.in_shape = tuple(in_shape)  # (native, native, chans)
        self._pad_to = pad_to
        self.device = torch.device(device if device is not None else "cpu")

    @classmethod
    def from_params(cls, params, cfg: ViTConfig, mean, std, native_size: int,
                    device=None, int8=False, mesh=None):
        """params: canonical flat dict (tensors or arrays), float32 or
        quantize_params output. device: where to serve (default: the CUDA
        device; raises when there is none). int8: the quant mode (True is
        "w8a8"); float32 params are quantized first. mesh: a mesh of local
        devices (parallel.mesh.make_mesh): the params on each of its
        devices, every batch split over them (data_parallel_call)."""
        devices = _serving_devices(mesh, device)
        state = _serving_params(params, cfg, int8, devices[0])
        states = [state] + [{k: v.to(d) for k, v in state.items()}
                            for d in devices[1:]]
        infer = make_infer_fn(cfg, mean, std, native_size, int8=int8)
        calls = [lambda images_u8, st=st: infer(st, images_u8)
                 for st in states]
        in_shape = (native_size, native_size, cfg.in_chans)
        if mesh is None:
            return cls(calls[0], in_shape, device=devices[0])
        return cls(data_parallel_call(calls, devices), in_shape,
                   pad_to=len(devices), device=devices[0])

    @classmethod
    def from_artifact(cls, path: str, device=None):
        """A saved artifact on `device` (default: the CUDA device), which
        must be of the device type it was exported on. A data-parallel
        artifact of width n serves on the first n devices of that type (n
        "cpu" entries on the CPU), each shard on its own copy of the
        program, and raises where fewer devices are visible."""
        device = resolve_device(device)
        exported, meta = load_artifact(path)
        if meta["device_type"] != device.type:
            raise ValueError(
                f"artifact {path} was exported for {meta['device_type']}; "
                f"it cannot serve on {device.type}")
        width = meta["data_parallel"]
        if width == 1:
            return cls(exported.module(), meta["in_shape"], device=device)
        devices = (mesh_mod.local_devices("cuda") if device.type == "cuda"
                   else [device] * width)
        if len(devices) < width:
            raise ValueError(f"artifact {path} was exported for {width} "
                             f"devices; this process has {len(devices)}")
        devices = devices[:width]
        home = _artifact_input(exported).device
        calls = [exported.module()]
        for d in devices[1:]:
            if d == home:
                calls.append(calls[0])
                continue
            from torch.export.passes import move_to_device_pass

            copy, _ = load_artifact(path)  # the pass moves it in place
            calls.append(move_to_device_pass(
                copy, {str(home): str(d)}).module())
        return cls(data_parallel_call(calls, devices), meta["in_shape"],
                   pad_to=width, device=devices[0])

    def forward(self, images_u8):
        """uint8 tensor [B, native, native, C] on the device -> logits
        tensor, without gradients."""
        with torch.inference_mode():
            return self._call(images_u8)

    def logits(self, images_u8) -> np.ndarray:
        images_u8 = np.asarray(images_u8)
        if images_u8.dtype != np.uint8:
            raise ValueError(f"expected uint8 images, got {images_u8.dtype}")
        if images_u8.ndim == 3:
            images_u8 = images_u8[None]
        n = images_u8.shape[0]
        pad = -n % self._pad_to
        if pad:
            images_u8 = np.concatenate(
                [images_u8, np.zeros((pad,) + images_u8.shape[1:], np.uint8)])
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        return self.forward(x).cpu().numpy()[:n]

    def predict(self, images_u8) -> np.ndarray:
        """-> int class ids [B]."""
        return np.argmax(self.logits(images_u8), axis=-1)
