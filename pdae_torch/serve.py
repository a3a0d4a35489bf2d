"""JSON-over-HTTP inference server over ``PDAEService.from_config`` (stdlib
only): the counterpart of ``scripts/serve.py``, with its endpoints:

  GET  /healthz                -> {"ok": true, "ops": [...]}
  POST /encode      {"images": [<b64 png>, ...]}            -> {"z": [[...]]}
  POST /autoencode  {"images": [...], "encode_style"?, "decode_style"?}
                                                            -> {"images": [...]}
  POST /generate    {"num_samples": N, "seed"?, ...}        -> {"images": [...]}
  POST /manipulate  {"images": [...], "attribute"|"class_id", "scale"?, ...}
                                                            -> {"images": [...]}

Images travel as base64-encoded PNG. Concurrent image requests are coalesced
into shared batches by a ``CoalescingBatcher`` (``--coalesce-ms`` window,
default 3 ms; 0 serves them one at a time under one lock); ``generate`` takes
the service's lock. A malformed request gets a 400, any other failure a 500,
each with ``{"error": ...}``.

    python -m pdae_torch.serve --config configs/sampler/unconditional_sample.yml \\
        --port 8080 [--device cpu]

It serves on the card unless ``--device`` names another. Tensor and spatial
parallelism (``--tp-size``/``--sp-size``) are not ported and are refused.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .utils.image import png_bytes


def _png_to_array(b64: str, channels: int = 3) -> np.ndarray:
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    arr = np.asarray(img.convert("RGB" if channels == 3 else "L"), np.uint8)
    return arr[..., None] if channels == 1 else arr


def _array_to_png(arr: np.ndarray) -> str:
    return base64.b64encode(png_bytes(arr)).decode()


def make_handler(service, lock, batcher=None):
    """The request handler. With a ``batcher`` the image-list ops go through
    it without the lock; ``generate`` (no batchable input) always takes the
    lock."""

    def run(op, images, **kwargs):
        if batcher is not None:
            return batcher.submit(op, images, **kwargs)
        with lock:
            return getattr(service, op)(images, **kwargs)

    def images_of(req):
        return np.stack([_png_to_array(b, service.channels) for b in req["images"]])

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, obj):
            payload = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, fmt, *args):
            pass

        def do_GET(self):
            if self.path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            # an op is advertised when every config key it loads is present
            cfg = service.config
            ops = ["encode", "autoencode"]
            if all(cfg.get(k) for k in ("latent_config_path", "latent_checkpoint_path",
                                        "inferred_latents_path")):
                ops.append("generate")
            if all(cfg.get(k) for k in ("classifier_checkpoint_path",
                                        "inferred_latents_path")):
                ops.append("manipulate")
            self._reply(200, {"ok": True, "ops": ops})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/encode":
                    self._reply(200, {"z": run("encode", images_of(req)).tolist()})
                    return
                if self.path == "/autoencode":
                    out = run("autoencode", images_of(req),
                              encode_style=req.get("encode_style"),
                              decode_style=req.get("decode_style"))
                elif self.path == "/generate":
                    with lock:
                        out = service.generate(int(req.get("num_samples", 1)),
                                               seed=int(req.get("seed", 0)),
                                               latent_style=req.get("latent_style"),
                                               decode_style=req.get("decode_style"))
                elif self.path == "/manipulate":
                    out = run("manipulate", images_of(req), attribute=req.get("attribute"),
                              class_id=int(req.get("class_id", 31)),
                              scale=float(req.get("scale", 0.3)),
                              encode_style=req.get("encode_style"),
                              decode_style=req.get("decode_style"))
                else:
                    self._reply(404, {"error": "not found"})
                    return
                self._reply(200, {"images": [_array_to_png(im) for im in out]})
            except (ValueError, KeyError, TypeError) as e:
                # a malformed request: bad JSON or base64, an unknown
                # attribute, an oversized batch, wrong types
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # anything else is the server's fault: a 5xx, so that monitors
                # and retry policies engage
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(config: dict, host: str = "127.0.0.1", port: int = 8080,
                coalesce_ms: float = 3.0, device=None):
    """``(server, batcher)``: a ``ThreadingHTTPServer`` bound to (host, port)
    over ``PDAEService.from_config(config, device)``; ``batcher`` is None when
    ``coalesce_ms`` is 0. The caller runs ``serve_forever`` and, at the end,
    ``server.server_close()`` and ``batcher.close()``."""
    from .serving import CoalescingBatcher, PDAEService

    service = PDAEService.from_config(config, device=device)
    batcher = CoalescingBatcher(service, window_ms=coalesce_ms) if coalesce_ms > 0 else None
    server = ThreadingHTTPServer((host, port),
                                 make_handler(service, threading.Lock(), batcher))
    return server, batcher


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--coalesce-ms", type=float, default=3.0,
                   help="batch-coalescing window for concurrent image requests; 0 "
                        "serves them one at a time under one lock")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' to run without one)")
    p.add_argument("--tp-size", type=int, default=None, help="not ported; refused")
    p.add_argument("--sp-size", type=int, default=None, help="not ported; refused")
    args = p.parse_args(argv)
    for flag, value in (("--tp-size", args.tp_size), ("--sp-size", args.sp_size)):
        if value is not None:
            raise SystemExit(f"{flag}: tensor and spatial parallelism are not ported "
                             "(ROADMAP.md, queue 1 item 15); the port serves on one card")

    from .utils import load_yaml

    server, batcher = make_server(load_yaml(args.config), args.host, args.port,
                                  args.coalesce_ms, args.device)
    print(f"serving on http://{args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
