"""Traffic ``autoencode``: one closed-loop caller of
``PDAEService.autoencode``, each request a batch of fresh images.

Set-up makes the encoder's and decoder's weights from the seed on the card,
builds the service from them and serves one request (the warm-up, its own
images). The window then sends request after request, each as soon as the
last returned, until ``--seconds`` have passed; the request in flight then
finishes and counts. Request r's images are made from (seed, r): SYNTHETIC's
8x8 colour blocks upsampled to the image size, plus fine noise, as uint8.

After the window a sample of the requests, drawn from the seed, goes
through the plain reference (the encoder's z, the DPM-Solver++ inversion
and decode, fp32 with TF32 off), and each image the service returned is
held to the reference's: the number compared is the worst image's mean
absolute difference in uint8 levels.

Parameters (the workload file): ``batch``, ``encode_style``,
``decode_style`` (``dpm<N>``), ``check_requests``, ``limits``.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import counts
from ..geometry import geometry as shared_geometry
from ..reference import diffusion
from ..reference.train import build
from ..weights import make_weights, split


def request_images(seed: int, r: int, batch: int, size: int) -> np.ndarray:
    """Request r's uint8 NHWC images."""
    rng = np.random.default_rng([int(seed), int(r)])
    base = rng.random((batch, 8, 8, 3))
    img = np.kron(base, np.ones((1, size // 8, size // 8, 1)))
    img = img + 0.1 * rng.standard_normal(img.shape)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def steps(style: str) -> int:
    """N of ``dpm<N>``."""
    if not style.startswith("dpm"):
        raise ValueError(f"the autoencode traffic takes dpm<N> styles, got {style!r}")
    return int(style[3:])


def evaluations(styles) -> int:
    """ShiftUNet evaluations of one request: the solver grids' steps (a grid
    whose snapped points merge has fewer than N)."""
    abar = diffusion.linear_alphas_cumprod()
    return sum(len(diffusion.solver_grid(abar, steps(s))) - 1 for s in styles)


def geometry(config: dict) -> dict:
    """The configuration's geometry, computed in fp32: ``PDAEService``'s only
    precision (TF32 off)."""
    return dict(shared_geometry(config), compute_dtype="float32")


def image_gap(mine: np.ndarray, ref: np.ndarray) -> float:
    """The worst image's mean |mine - ref| in uint8 levels."""
    d = np.abs(mine.astype(np.int32) - ref.astype(np.int32))
    return float(d.reshape(d.shape[0], -1).mean(axis=1).max())


def reference_autoencode(enc, dec, images: np.ndarray, enc_steps: int, dec_steps: int,
                         device) -> np.ndarray:
    with torch.no_grad():
        x = diffusion.from_uint8(images).to(device)
        return diffusion.to_uint8(diffusion.autoencode(enc, dec, x, enc_steps, dec_steps))


def sample_requests(seed: int, done, count: int) -> list:
    """The requests checked: ``count`` of the answered requests ``done``,
    drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    done = sorted(done)
    return sorted(int(r) for r in rng.choice(done, size=min(count, len(done)),
                                             replace=False))


class Cell:

    def __init__(self, config, workload, seed, device, setup):
        self.config, self.workload, self.seed = config, workload, int(seed)
        self.device, self.setup_times = device, setup
        self.geometry = geometry(config)
        self.batch = int(workload["batch"])
        self.size = self.geometry["image_size"]
        self.styles = workload["encode_style"], workload["decode_style"]
        self.outputs = {}

    def service_config(self) -> dict:
        c = self.config
        return {"trained_ddpm_config": c["denoise_fn_config"],
                "encoder_config": c["encoder_config"], "decoder_config": c["decoder_config"],
                "diffusion_config": c["diffusion_config"], "image_size": self.size,
                "image_channel": 3}

    def setup(self):
        with self.setup_times.part("program_imports"):
            from pdae_torch.ops import _build
            from pdae_torch.serving import PDAEService

        if self.device.type == "cuda":
            with self.setup_times.part("nvcc"):
                _build.build()
        with self.setup_times.part("weights"):
            w = make_weights(self.geometry, self.seed, self.device)
        with self.setup_times.part("service_build"):
            self.service = PDAEService(self.service_config(), split(w, "encoder."),
                                       split(w, "decoder."), device=self.device)
        del w
        with self.setup_times.part("warmup_request"):
            self.service.autoencode(request_images(self.seed, 0, self.batch, self.size),
                                    *self.styles)

    def window(self, seconds: float, trace=None) -> dict:
        """Requests back to back for ``seconds``, all of them traced where
        ``trace`` is given."""
        first = last = None
        r, failed = 0, 0
        if trace is not None:
            trace.begin()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            r += 1
            images = request_images(self.seed, r, self.batch, self.size)
            start = time.perf_counter()
            with torch.profiler.record_function("bench.request"):
                try:
                    self.outputs[r] = self.service.autoencode(images, *self.styles)
                except FloatingPointError:
                    failed += 1
            last = time.perf_counter()
            first = start if first is None else first
        return {"metrics": {"autoencode_imgs_per_s": r * self.batch / (last - first)},
                "attempted": r, "failed": failed, "traced_units": r}

    def check(self) -> dict:
        limits = self.workload["limits"]
        self.service = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        w = make_weights(self.geometry, self.seed, self.device)
        enc, dec = build(self.geometry, w, self.device)
        del w
        gap = 0.0
        for r in sample_requests(self.seed, self.outputs,
                                 int(self.workload["check_requests"])):
            images = request_images(self.seed, r, self.batch, self.size)
            ref = reference_autoencode(enc, dec, images, *map(steps, self.styles),
                                       self.device)
            gap = max(gap, image_gap(self.outputs[r], ref))
        return {"image_gap": (gap, float(limits["image_gap"]))}

    def counts(self) -> dict:
        n = evaluations(self.styles)
        return dict(counts.autoencode_request(self.geometry, self.batch, n), evaluations=n)
