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

It serves on the card unless ``--device`` names another. ``--tp-size K``
serves tensor-parallel under ``torchrun`` (``PDAEService``'s ``tp_size``; K
divides the world): rank 0 runs the HTTP server and the batcher and
broadcasts each op, its arguments and its batch over the default group
before it runs it; every other rank runs a follower loop that takes each
broadcast and runs the op; at shutdown rank 0 broadcasts a stop. A follower
whose op fails as the request's own fault (``ValueError``, ``KeyError``,
``TypeError``: the leader answers it with a 400) goes on; any other error
ends the follower with a nonzero exit. ``--sp-size K`` serves
spatial-parallel the same way (``PDAEService``'s ``sp_size``: each image's
rows over K ranks); the two flags together raise ``pdae_tpu``'s
``ValueError`` before anything else.

    torchrun --nproc-per-node 2 -m pdae_torch.serve --config YML --tp-size 2
    torchrun --nproc-per-node 2 -m pdae_torch.serve --config YML --sp-size 2
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

# a malformed request's errors: bad JSON or base64, an unknown attribute, an
# oversized batch, wrong types (a 400; anything else is a 500)
REQUEST_ERRORS = (ValueError, KeyError, TypeError)


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
            except REQUEST_ERRORS as e:
                # a malformed request: bad JSON or base64, an unknown
                # attribute, an oversized batch, wrong types
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                # anything else is the server's fault: a 5xx, so that monitors
                # and retry policies engage
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


OPS = ("encode", "autoencode", "decode", "generate", "manipulate")


class Lockstep:
    """The service on rank 0 of a tensor-parallel server: each op's name,
    arguments and batch are broadcast over the default group before it
    runs, one op at a time, so that the followers run it too; ``stop()``
    broadcasts the end."""

    def __init__(self, service):
        self._service = service
        self._lock = threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._service, name)
        if name not in OPS:
            return attr

        def call(*args, **kwargs):
            import torch.distributed as dist
            with self._lock:
                dist.broadcast_object_list([(name, args, kwargs)], src=0)
                return attr(*args, **kwargs)
        return call

    def stop(self):
        import torch.distributed as dist
        with self._lock:
            dist.broadcast_object_list([None], src=0)


def follow(service) -> int:
    """A follower rank's loop: run each op rank 0 broadcasts until the
    stop; returns the number of ops run. A request's own error (the leader
    answers it with a 400) is passed over; any other raises."""
    import torch.distributed as dist
    done = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return done
        name, args, kwargs = msg[0]
        try:
            getattr(service, name)(*args, **kwargs)
        except REQUEST_ERRORS:
            pass
        done += 1


def make_server(config: dict, host: str = "127.0.0.1", port: int = 8080,
                coalesce_ms: float = 3.0, device=None, service=None):
    """``(server, batcher)``: a ``ThreadingHTTPServer`` bound to (host, port)
    over ``service`` (by default ``PDAEService.from_config(config,
    device)``); ``batcher`` is None when ``coalesce_ms`` is 0. The caller
    runs ``serve_forever`` and, at the end, ``server.server_close()`` and
    ``batcher.close()``."""
    from .serving import CoalescingBatcher, PDAEService

    if service is None:
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
    p.add_argument("--tp-size", type=int, default=None,
                   help="tensor-parallel model ranks, under torchrun (module docstring)")
    p.add_argument("--sp-size", type=int, default=None,
                   help="spatial-parallel ranks per image, under torchrun (module docstring)")
    args = p.parse_args(argv)
    if (args.tp_size or 1) > 1 and (args.sp_size or 1) > 1:
        raise ValueError("tp_size and sp_size are mutually exclusive")

    from .utils import load_yaml

    config = load_yaml(args.config)
    sizes = {k: v for k, v in (("tp_size", args.tp_size), ("sp_size", args.sp_size))
             if v is not None}
    if not sizes:
        server, batcher = make_server(config, args.host, args.port, args.coalesce_ms,
                                      args.device)
        _serve(server, batcher, args.host)
        return
    from . import parallel
    from .serving import PDAEService

    import torch.distributed as dist

    parallel.init_distributed()
    try:
        service = PDAEService.from_config({**config, **sizes}, device=args.device)
        if not parallel.is_primary():
            print(f"rank {parallel.process_index()}: following", flush=True)
            follow(service)
            return
        leader = Lockstep(service)
        try:
            server, batcher = make_server(config, args.host, args.port, args.coalesce_ms,
                                          service=leader)
            _serve(server, batcher, args.host)
        finally:
            leader.stop()
    finally:
        # torn down before the interpreter exits: a gloo group left to its
        # destructors there can abort the process
        if dist.is_initialized():
            dist.destroy_process_group()


def _serve(server, batcher, host):
    print(f"serving on http://{host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.close()


if __name__ == "__main__":
    main()
