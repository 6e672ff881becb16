"""HTTP inference server: a stdlib http.server wrapper around
serving.Predictor, the end of the deployment path: train -> checkpoint ->
(int8) -> (export) -> serve over HTTP.

  python -m vit_rpe_rope_tpu_torch.cli.serve ckpt.npz --port 8000
  python -m vit_rpe_rope_tpu_torch.cli.serve --artifact model.pt2 --port 8000

Endpoints:
  GET  /health   -> {"status": "ok", "input_shape": [...]}
  POST /predict  -> body: an .npz payload with 'images' (uint8 NHWC or HWC);
                    response: {"predictions": [...], "logits": [[...]] when
                    ?logits=1}

Requests are served one at a time (a threading.Lock serializes device work;
the ThreadingHTTPServer still overlaps request parsing and IO with compute).
Runs on the CUDA device; --device cpu runs on the CPU (an artifact serves on
the device type it was exported on; a data-parallel artifact, from
cli.predict --export_data_parallel N, splits each request's batch over N
devices and needs them).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ViT HTTP inference server")
    p.add_argument("checkpoint", nargs="?", default=None,
                   help="trained checkpoint (.npz / reference .pth); omit "
                        "when using --artifact")
    p.add_argument("--artifact", type=str, default=None,
                   help="serve a .pt2 artifact instead of a checkpoint")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "mnist", "cifar10"])
    p.add_argument("--num_heads", type=int, default=6)
    p.add_argument("--grid_size", type=int, default=None)
    p.add_argument("--rope_mixed_compat_scramble", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8 quantized path (quant.py)")
    p.add_argument("--int8_mode", type=str, default="w8a8",
                   choices=["w8a8", "w8a8-static", "w8a16"],
                   help="w8a8: int8 products; w8a8-static: int8 products "
                        "with offline-calibrated per-tensor scales (--calib "
                        "required); w8a16: weight-only (bf16 matmuls over "
                        "dequantized int8 weights)")
    p.add_argument("--calib", type=str, default=None,
                   help="npz with 'images' (uint8) for w8a8-static "
                        "activation-scale calibration")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "CPU)")
    p.add_argument("--max_batch", type=int, default=1024,
                   help="reject request batches larger than this")
    return p


def make_server(predictor, host: str, port: int, max_batch: int):
    """Build (not start) the HTTP server around a serving.Predictor."""
    import io
    import json
    import threading
    import urllib.parse
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    import numpy as np

    lock = threading.Lock()
    # Bound request-body memory BEFORE reading it: max_batch images of the
    # served shape (uncompressed .npz ≈ raw bytes) + labels/headers slack.
    # A -1 dim (a shape the predictor leaves open) counts as 1024.
    el = 1
    for dim in predictor.in_shape:
        el *= dim if dim > 0 else 1024
    max_body = max_batch * el + (1 << 20)

    class Handler(BaseHTTPRequestHandler):
        timeout = 30  # socket timeout: a stalled client can't pin a thread

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.split("?")[0] == "/health":
                self._reply(200, {"status": "ok",
                                  "input_shape": list(predictor.in_shape)})
            else:
                self._reply(404, {"error": "unknown path; use /health or "
                                           "POST /predict"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._reply(404, {"error": "POST /predict"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                n = -1
            if n < 0 or n > max_body:
                # Reject WITHOUT buffering: Content-Length is client-supplied
                # and must not size an unbounded allocation. Moderately
                # oversized bodies are drained in small discarded chunks
                # (bounded memory AND bounded work) so the client's send
                # completes and it can read the 413; absurd declarations are
                # not drained at all — reply and close the connection.
                remaining = max(n, 0)
                if remaining <= (8 << 20):  # drain cap
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 16, remaining))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                else:
                    self.close_connection = True
                self._reply(413, {"error": f"body of {n} bytes exceeds the "
                                           f"server limit ({max_body})"})
                return
            try:
                with np.load(io.BytesIO(self.rfile.read(n))) as z:
                    images = np.asarray(z["images"])
            except Exception as e:  # malformed payload -> client error
                self._reply(400, {"error": f"expected an .npz body with "
                                           f"'images': {e}"})
                return
            if images.ndim == 3:
                images = images[None]
            if images.ndim != 4 or images.dtype != np.uint8:
                self._reply(400, {"error": "images must be uint8 [B, H, W, C]"})
                return
            want = tuple(predictor.in_shape)
            got = tuple(images.shape[1:])
            if any(w > 0 and w != g for w, g in zip(want, got)):
                self._reply(400, {"error": f"image shape {list(got)} does "
                                           f"not match the served model's "
                                           f"{list(want)}"})
                return
            if images.shape[0] > max_batch:
                self._reply(413, {"error": f"batch {images.shape[0]} exceeds "
                                           f"--max_batch {max_batch}"})
                return
            try:
                with lock:  # one device dispatch at a time
                    logits = predictor.logits(images)
            except Exception as e:
                self._reply(500, {"error": str(e)})
                return
            payload = {"predictions": np.argmax(logits, -1).tolist()}
            if urllib.parse.parse_qs(query).get("logits") == ["1"]:
                payload["logits"] = np.round(logits.astype(float), 6).tolist()
            self._reply(200, payload)

        def log_message(self, fmt, *log_args):  # quiet per-request stderr
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None, serve_forever: bool = True):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.artifact is None and args.checkpoint is None:
        parser.error("need a checkpoint or --artifact")
    if args.artifact is not None and (args.checkpoint is not None
                                      or args.int8):
        parser.error("--artifact cannot be combined with a checkpoint or "
                     "--int8")

    from vit_rpe_rope_tpu_torch import serving

    int8 = args.int8_mode if args.int8 else False
    if args.artifact is not None:
        predictor = serving.Predictor.from_artifact(args.artifact,
                                                    device=args.device)
        desc = f"artifact {args.artifact}"
    else:
        calib_u8 = None
        if int8 == "w8a8-static":
            if args.calib is None:
                parser.error("--int8_mode w8a8-static needs --calib "
                             "images.npz")
            import numpy as np

            with np.load(args.calib) as z:
                calib_u8 = z["images"]
        params, cfg, mean, std, native, dataset = serving.load_serving_state(
            args.checkpoint, dataset=args.dataset, num_heads=args.num_heads,
            grid_size=args.grid_size,
            rope_mixed_compat_scramble=args.rope_mixed_compat_scramble,
            int8=int8, calib_images_u8=calib_u8, device=args.device)
        predictor = serving.Predictor.from_params(params, cfg, mean, std,
                                                  native, device=args.device,
                                                  int8=int8)
        desc = (f"{args.checkpoint} ({cfg.pos_encoding}, {dataset} contract"
                + (f", int8 {int8}" if int8 else "") + ")")

    server = make_server(predictor, args.host, args.port, args.max_batch)
    print(f"Serving {desc} on http://{args.host}:{server.server_address[1]} "
          f"— GET /health, POST /predict (.npz body)", flush=True)
    if serve_forever:
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.shutdown()
    return server


if __name__ == "__main__":
    main()
