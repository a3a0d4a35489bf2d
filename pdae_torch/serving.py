"""Batched PDAE inference on one card: ``encode``, ``autoencode``, ``decode``,
``generate`` and ``manipulate``, and the ``CoalescingBatcher`` in front.

Port of ``pdae_tpu/serving.py``. Images go in and come out NHWC as in the JAX
service; the models run NCHW on ``device``. Batches are padded to
power-of-two buckets (capped at ``max_batch``) by repeating the first image,
and trimmed on the way out. Every op takes ``ddim<N>`` and ``dpm<N>`` styles.

The service is built from configs and state dicts held in memory, or with
``PDAEService.from_config`` from the checkpoint files a sampler config names
(the JAX service's constructor). It runs fp32, as the JAX service builds
float32 models, with TF32 off: the constructor sets
``torch.backends.cudnn.allow_tf32`` and ``torch.backends.cuda.matmul.allow_tf32``
to ``False`` for the whole process, so convs and matmuls keep full fp32
mantissas.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from . import parallel, resolve_device
from .data import CELEBAHQ_LABEL_TO_ID
from .diffusion import GaussianDiffusion
from .models import (build_classifier, build_decoder, build_encoder,
                     build_latent_denoise_fn)
from .parallel import sp as spatial_parallel
from .parallel import tp as tensor_parallel
from .utils import encoder_tree, mlp_skip_net_tree, unet_tree
from .sampling import SamplerContext
from .sampling.context import DEFAULT_DIFFUSION
from .utils import load_checkpoint, to_uint8


def _bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    return min(1 << max(0, (n - 1)).bit_length(), max_batch)


def _require(op: str, **artifacts) -> None:
    missing = [name for name, value in artifacts.items() if value is None]
    if missing:
        raise ValueError(f"{op} needs {', '.join(missing)}, which this service was "
                         "not given")


class PDAEService:
    """Resident PDAE inference.

    ``config`` keys: ``trained_ddpm_config`` (the UNet geometry of the
    pre-trained DPM), ``decoder_config`` and ``encoder_config`` (each with
    ``latent_dim``), optional ``diffusion_config`` (default linear, 1000
    steps), ``image_size``, ``image_channel`` (3), ``max_batch`` (64),
    ``encoder_ddim_style``/``decoder_ddim_style`` (``ddim100``: autoencode,
    decode, and generate's decode), ``latent_ddim_style`` (``ddim100``:
    generate's latent loop), ``encode_ddim_style``/``decode_ddim_style``
    (``ddim500``/``ddim200``: manipulate), ``latent_config`` (the
    ``latent_denoise_fn_config`` of the latent DPM) and ``num_classes`` (40).
    ``tp_size`` (1) above 1 serves tensor-parallel over the processes of
    an initialized group (``parallel.init_distributed``), as ``pdae_tpu``'s
    service does over its local chips: ``tp_size`` must divide the world,
    every rank builds the service and calls each op in lockstep, the models
    hold each rank's blocks (``parallel/tp.py``, leaves of at least
    ``tp_min_size``, 2**15, elements) and run split over the model group,
    the padded bucket is split over the ``world // tp_size`` data groups as
    ``pad_shard_batch`` splits it, and every rank returns the whole result.
    The classifier's rows are read, not run, and stay whole. ``sp_size`` (1)
    above 1 serves spatial-parallel likewise (``parallel/sp.py``): the
    parameters stay whole, the encoder and decoder run on the rank's rows of
    each map over the ``sp_size`` ranks of an sp group, the bucket splits
    over the ``world // sp_size`` data groups, and the sampling loops keep
    ``x_t`` whole on every rank (each model call gathers its output), so a
    batch of one uses every rank. ``tp_size`` and ``sp_size`` both above 1
    raise ``pdae_tpu``'s ``ValueError``.

    ``encoder_state``/``decoder_state`` are state dicts in the reference
    layout (``pdae_torch.utils.convert``). ``generate`` also needs
    ``latent_config``, ``latent_state`` (an MLPSkipNet state dict) and
    ``latent_stats``; ``manipulate`` needs ``classifier_state`` and
    ``latent_stats``. ``latent_stats`` is ``(mean, std)`` of the inferred
    latents. Those models are built at the first call that needs them; an op
    whose artifact is missing raises. ``device``: ``cuda`` unless given;
    without a card it must be given.

    ``fused_upsample`` (``on``, ``off`` or ``auto``; the JAX service pins an
    XLA rewrite of the decoders' upsample convs with it) is checked and
    ignored: the port computes nearest-up then a 3x3 conv, one numerics for
    every bucket.
    """

    def __init__(self, config: dict, encoder_state: dict, decoder_state: dict,
                 device=None, *, latent_state: Optional[dict] = None,
                 latent_stats=None, classifier_state: Optional[dict] = None):
        tp_size, sp_size = int(config.get("tp_size", 1)), int(config.get("sp_size", 1))
        if tp_size > 1 and sp_size > 1:
            raise ValueError("tp_size and sp_size are mutually exclusive")
        self.tp_layout = self.sp_groups = None
        self._data = (0, 1)         # (data index, data groups)
        if tp_size > 1:
            groups = tensor_parallel.tp_groups(tp_size)
            self.tp_layout = tensor_parallel.Layout(
                groups, int(config.get("tp_min_size", parallel.FSDP_MIN_SIZE)))
            self._data = (groups.data_index, groups.dp)
        elif sp_size > 1:
            self.sp_groups = spatial_parallel.sp_groups(sp_size)
            self._data = (self.sp_groups.data_index, self.sp_groups.dp)
        fused = str(config.get("fused_upsample", "auto")).lower()
        if fused not in ("on", "off", "auto", "true", "false", "1", "0"):
            raise ValueError(f"fused_upsample must be on|off|auto, got {fused!r}")
        self.config = config
        self.device = resolve_device(device)
        self.size = int(config["image_size"])
        self.channels = int(config.get("image_channel", 3))
        self.max_batch = int(config.get("max_batch", 64))
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.gd = GaussianDiffusion(config.get("diffusion_config", DEFAULT_DIFFUSION))
        self.encoder = build_encoder(config["encoder_config"], image_size=self.size)
        self.decoder = build_decoder(config["decoder_config"],
                                     config["trained_ddpm_config"])
        for model, state, to_tree in ((self.encoder, encoder_state, encoder_tree),
                                      (self.decoder, decoder_state, unet_tree)):
            model.load_state_dict(state, strict=True)
            model.to(self.device).eval()
            if self.tp_layout is not None:
                self.tp_layout.add(model, to_tree)
            if self.sp_groups is not None:
                spatial_parallel.shard_rows(model, self.sp_groups, self.size)
        self.latent_dim = int(config["encoder_config"]["latent_dim"])
        self._latent_state = latent_state
        self._latent_stats_in = latent_stats
        self._classifier_state = classifier_state
        self._latent_model = None
        self._stats = None
        self._clf_weight = None
        # the first generate or manipulate can come from a batcher's worker
        # thread and a direct caller at once: each lazy build runs once
        self._init_lock = threading.Lock()

    @classmethod
    def from_config(cls, config: dict, device=None) -> "PDAEService":
        """The service of the PDAE stage at ``config_path``/``checkpoint_path``
        (its EMA encoder and decoder), with the keys of the JAX service:
        ``trained_ddpm_config_path``, ``latent_config_path`` and
        ``latent_checkpoint_path`` plus ``inferred_latents_path``
        (``generate``), ``classifier_checkpoint_path`` plus
        ``inferred_latents_path`` (``manipulate``), ``num_classes``,
        ``image_size``/``image_channel``, ``diffusion_config``, ``max_batch``
        and the styles, read through ``SamplerContext``. The files a key
        names are read here; the models are built at the first op that needs
        them, and an op whose files were not named raises."""
        ctx = SamplerContext(config, device)
        geo = ctx.pdae_geometry()
        encoder_state, decoder_state = ctx.pdae_states()
        later = {}
        if config.get("latent_checkpoint_path"):
            later["latent_state"] = ctx.latent_state()
        if config.get("classifier_checkpoint_path"):
            later["classifier_state"] = ctx.classifier_state()
        if config.get("inferred_latents_path"):
            stats = load_checkpoint(config["inferred_latents_path"])
            later["latent_stats"] = (stats["mean"], stats["std"])
        service_config = {**config, "trained_ddpm_config": geo["trained_ddpm_config"],
                          "encoder_config": geo["encoder_config"],
                          "decoder_config": geo["decoder_config"],
                          "diffusion_config": ctx.diffusion_config,
                          "image_size": geo["image_size"],
                          "image_channel": geo["image_channel"]}
        if config.get("latent_config_path"):
            service_config["latent_config"] = ctx.latent_config()
        return cls(service_config, encoder_state, decoder_state, ctx.device, **later)

    # -- helpers --------------------------------------------------------- #

    def _to_model_input(self, images):
        """uint8 (or float in [-1, 1]) NHWC -> padded fp32 NCHW on the device,
        and the number of real images."""
        arr = np.asarray(images)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0 * 2.0 - 1.0
        arr = np.asarray(arr, np.float32)
        n = arr.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(f"batch {n} exceeds max_batch {self.max_batch}")
        if arr.shape[1:] != (self.size, self.size, self.channels):
            raise ValueError(f"images must be [N, {self.size}, {self.size}, "
                             f"{self.channels}], got {arr.shape}")
        b = _bucket(n, self.max_batch)
        if b > n:
            arr = np.concatenate([arr, np.repeat(arr[:1], b - n, axis=0)], axis=0)
        x = torch.from_numpy(arr).to(self.device).permute(0, 3, 1, 2).contiguous()
        return x, n

    def _latent_stats(self):
        """(mean, std) on the device; the caller holds the init lock."""
        if self._stats is None:
            with torch.inference_mode(False):
                self._stats = tuple(torch.as_tensor(np.array(a, np.float32),
                                                    device=self.device)
                                    for a in self._latent_stats_in)
        return self._stats

    def _latent(self):
        """The latent DPM's denoiser and the latent stats, built once."""
        with self._init_lock:
            if self._latent_model is None:
                _require("generate", latent_config=self.config.get("latent_config"),
                         latent_state=self._latent_state,
                         latent_stats=self._latent_stats_in)
                with torch.inference_mode(False):
                    model = build_latent_denoise_fn(self.config["latent_config"])
                    model.load_state_dict(self._latent_state, strict=True)
                    model.to(self.device).eval()
                    if self.tp_layout is not None:
                        self.tp_layout.add(model, mlp_skip_net_tree)
                    self._latent_model = model
            return self._latent_model, self._latent_stats()

    def _classifier(self):
        """The classifier's ``[num_classes, latent_dim]`` weight and the
        latent stats, built once."""
        with self._init_lock:
            if self._clf_weight is None:
                _require("manipulate", classifier_state=self._classifier_state,
                         latent_stats=self._latent_stats_in)
                with torch.inference_mode(False):
                    clf = build_classifier(int(self.config.get("num_classes", 40)),
                                           self.latent_dim)
                    clf.load_state_dict(self._classifier_state, strict=True)
                    self._clf_weight = clf.weight.detach().to(self.device)
            return self._clf_weight, self._latent_stats()

    def _rows(self, *tensors):
        """This data group's rows of each padded bucket: wrap-padded to a
        multiple of the data groups, then cut evenly (``pad_shard_batch``);
        the tensors themselves with one data group."""
        index, count = self._data
        if count == 1:
            return tensors if len(tensors) > 1 else tensors[0]
        out = []
        for t in tensors:
            b = t.shape[0]
            pad = (-b) % count
            if pad:
                t = torch.cat([t] * (1 + -(-pad // b)))[:b + pad]
            per = t.shape[0] // count
            out.append(t[index * per:(index + 1) * per])
        return tuple(out) if len(out) > 1 else out[0]

    def _whole(self, local: torch.Tensor) -> torch.Tensor:
        """The data groups' results concatenated in order, on every rank
        (each model or sp group's first rank's, gathered over gloo);
        ``local`` itself with one data group. Collective."""
        if self._data[1] == 1:
            return local
        parts = parallel.gather_objects([local.cpu()])
        return torch.cat(parts[::parallel.process_count() // self._data[1]]).to(local.device)

    @staticmethod
    def _to_nhwc(x: torch.Tensor, n: int) -> np.ndarray:
        """The first n images of a model output as NHWC numpy; a non-finite
        value raises here rather than turn into pixels."""
        x = x[:n]
        if not torch.isfinite(x).all():
            raise FloatingPointError("the model produced non-finite values")
        return x.permute(0, 2, 3, 1).cpu().numpy()

    # -- ops ------------------------------------------------------------- #

    @torch.inference_mode()
    def encode(self, images) -> np.ndarray:
        """images -> semantic latents z ``[N, latent_dim]``."""
        x, n = self._to_model_input(images)
        return self._whole(self.encoder(self._rows(x)))[:n].cpu().numpy()

    @torch.inference_mode()
    def autoencode(self, images, encode_style: Optional[str] = None,
                   decode_style: Optional[str] = None) -> np.ndarray:
        """images -> reconstructions (uint8 NHWC)."""
        es = encode_style or self.config.get("encoder_ddim_style", "ddim100")
        ds = decode_style or self.config.get("decoder_ddim_style", "ddim100")
        x, n = self._to_model_input(images)
        out = self.gd.representation_learning_autoencoding(
            es, ds, self.encoder, self.decoder, self._rows(x))
        return to_uint8(self._to_nhwc(self._whole(out), n))

    @torch.inference_mode()
    def decode(self, z, x_T, decode_style: Optional[str] = None,
               stop_percent: float = 0.0) -> np.ndarray:
        """(z ``[N, latent_dim]``, x_T NHWC) -> images (uint8 NHWC)."""
        ds = decode_style or self.config.get("decoder_ddim_style", "ddim100")
        x, n = self._to_model_input(np.asarray(x_T, np.float32))
        zz = np.asarray(z, np.float32)
        if zz.shape[0] != n:
            raise ValueError(f"{zz.shape[0]} latents for {n} images")
        if x.shape[0] > n:
            zz = np.concatenate([zz, np.repeat(zz[:1], x.shape[0] - n, axis=0)])
        x, zz = self._rows(x, torch.from_numpy(zz).to(self.device))
        out = self.gd.representation_learning_ddim_sample(
            ds, None, self.decoder, None, x, zz, stop_percent=stop_percent)
        return to_uint8(self._to_nhwc(self._whole(out), n))

    @torch.inference_mode()
    def generate(self, n: int, seed: int = 0, latent_style: Optional[str] = None,
                 decode_style: Optional[str] = None) -> np.ndarray:
        """Unconditional samples through the latent DPM (uint8 NHWC). z_T,
        then x_T, are drawn at the bucket size from a generator on the device
        seeded with ``seed``, and the result trimmed to ``n``: the same
        (n's bucket, seed) gives the same images."""
        latent_denoise_fn, (mean, std) = self._latent()
        ls = latent_style or self.config.get("latent_ddim_style", "ddim100")
        ds = decode_style or self.config.get("decoder_ddim_style", "ddim100")
        if n < 1:
            raise ValueError("empty batch")
        if n > self.max_batch:
            raise ValueError(f"n {n} exceeds max_batch {self.max_batch}")
        b = _bucket(n, self.max_batch)
        latent_dim = int(self.config["latent_config"]["input_channel"])
        gen = torch.Generator(self.device).manual_seed(int(seed))
        z_T = torch.randn((b, latent_dim), generator=gen, device=self.device)
        x_T = torch.randn((b, self.channels, self.size, self.size), generator=gen,
                          device=self.device)
        z_T, x_T = self._rows(z_T, x_T)
        out = self.gd.latent_diffusion_sample(
            None, ls, ds, latent_denoise_fn, self.decoder, x_T, mean, std,
            latent_dim=latent_dim, z_T=z_T)
        return to_uint8(self._to_nhwc(self._whole(out), n))

    @torch.inference_mode()
    def manipulate(self, images, attribute: Optional[str] = None, class_id: int = 31,
                   scale: float = 0.3, encode_style: Optional[str] = None,
                   decode_style: Optional[str] = None) -> np.ndarray:
        """Semantic attribute edit (uint8 NHWC): encode x_T, then decode it
        with the latent moved along the classifier's row for ``attribute``
        (a CelebA-HQ attribute name) or ``class_id``."""
        weight, (mean, std) = self._classifier()
        if attribute is not None:
            if attribute not in CELEBAHQ_LABEL_TO_ID:
                raise ValueError(f"unknown attribute {attribute!r}; one of "
                                 f"{sorted(CELEBAHQ_LABEL_TO_ID)}")
            class_id = CELEBAHQ_LABEL_TO_ID[attribute]
        if not 0 <= int(class_id) < weight.shape[0]:
            raise ValueError(f"class_id {class_id} is not in [0, {weight.shape[0]})")
        es = encode_style or self.config.get("encode_ddim_style", "ddim500")
        ds = decode_style or self.config.get("decode_ddim_style", "ddim200")
        x, n = self._to_model_input(images)
        x = self._rows(x)
        x_T = self.gd.representation_learning_ddim_encode(
            es, self.encoder, self.decoder, x)
        out = self.gd.manipulation_sample(
            ds, weight, self.encoder, self.decoder, x, x_T, mean, std,
            int(class_id), float(scale))
        return to_uint8(self._to_nhwc(self._whole(out), n))


class CoalescingBatcher:
    """Merge concurrent per-image requests into single device batches.

    N clients each posting a few images would otherwise make N small calls;
    the worker thread drains all requests waiting at the end of a short
    window, groups them by (op, kwargs, per-image shape and dtype),
    concatenates each group's images, runs one bucketed call per chunk of at
    most ``max_batch`` images, and splits the results back. It serves the
    image-list ops (``encode``, ``autoencode``, ``manipulate``); ``generate``
    takes no batchable input, so callers use the service directly.

    ``submit()`` blocks until the caller's slice is ready and re-raises any
    op error in the calling thread. ``stats()["calls"]`` counts the service
    calls made. The service ops enter ``torch.inference_mode`` themselves,
    so it holds in the worker thread too.
    """

    OPS = ("encode", "autoencode", "manipulate")

    def __init__(self, service: PDAEService, window_ms: float = 3.0):
        self.service = service
        self.window_s = window_ms / 1000.0
        self._cv = threading.Condition()
        self._pending = []
        self._stop = False
        self._calls = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, op: str, images, **kwargs):
        if op not in self.OPS:
            raise ValueError(f"op must be one of {self.OPS}, got {op!r}")
        images = np.asarray(images)
        slot = {"event": threading.Event()}
        # the group key holds the per-image shape and dtype: requests of other
        # geometries, or uint8 beside float inputs, must not share a batch
        # (the concat would fail, or promotion would skip the uint8 rescale)
        sig = (op, tuple(sorted(kwargs.items())), images.shape[1:], images.dtype.str)
        try:
            hash(sig)        # an unhashable kwarg fails here, in the caller
        except TypeError as e:
            raise TypeError(f"non-hashable kwargs for coalescing: {e}")
        with self._cv:
            if self._stop:
                raise RuntimeError("batcher closed")
            self._pending.append((sig, images, kwargs, slot))
            self._cv.notify()
        # bounded waits with a liveness check: if the worker thread is gone,
        # do not block forever
        while not slot["event"].wait(timeout=1.0):
            if not self._worker.is_alive():
                raise RuntimeError("batcher worker died; request dropped")
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def stats(self):
        with self._cv:
            return {"calls": self._calls}

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._worker.join()

    def _run(self):
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if self._stop and not self._pending:
                    return
            time.sleep(self.window_s)        # let concurrent posts pile up
            with self._cv:
                batch, self._pending = self._pending, []
            try:
                groups = {}
                for sig, images, kwargs, slot in batch:
                    groups.setdefault(sig, []).append((images, kwargs, slot))
                for sig, entries in groups.items():
                    # chunk so that no call exceeds the service's bucket cap
                    cap = self.service.max_batch
                    i = 0
                    while i < len(entries):
                        chunk, n = [], 0
                        while i < len(entries) and (not chunk
                                                    or n + len(entries[i][0]) <= cap):
                            chunk.append(entries[i])
                            n += len(entries[i][0])
                            i += 1
                        self._run_chunk(sig[0], chunk)
            except BaseException as e:
                # the worker must never exit with waiters blocked: fail every
                # slot of this drained batch not yet resolved; an interrupt
                # then propagates and ends the worker, and blocked submit()
                # calls notice through the liveness check
                err = e if isinstance(e, Exception) else RuntimeError(
                    f"batcher worker interrupted: {e!r}")
                for _, _, _, slot in batch:
                    if not slot["event"].is_set():
                        slot["err"] = err
                        slot["event"].set()
                if not isinstance(e, Exception):
                    raise

    def _run_chunk(self, op, chunk):
        imgs = np.concatenate([e[0] for e in chunk], axis=0)
        kwargs = chunk[0][1]
        try:
            out = getattr(self.service, op)(imgs, **kwargs)
            with self._cv:
                self._calls += 1
            off = 0
            for images, _, slot in chunk:
                slot["out"] = out[off:off + len(images)]
                off += len(images)
                slot["event"].set()
        except Exception as e:       # deliver the failure to every waiter
            for _, _, slot in chunk:
                slot["err"] = e
                slot["event"].set()
