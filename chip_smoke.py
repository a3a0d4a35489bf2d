#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pdae_torch``) on one NVIDIA H100.

Run from the root of the repository, on a machine with a card:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero before the last line:

1. ``build``: compile every kernel from ``pdae_torch/csrc`` with nvcc (all
   sources at once) and report the seconds and ptxas's register/spill lines.
2. ``kernels``: every kernel against its plain PyTorch version on the card, at
   every shape the celeba64 autoencode path (b8) and the train step (b32) give
   it (read off the models with forward hooks; the forward kernels at both
   paths' shapes), in fp32 with TF32 off and in bf16, both GN modes, the
   forward that saves its stats and the GN backward with and without AdaGN
   and z coefficients, as the train step's chains have them; with
   the kernel's device time (CUDA-graph replay), its eager per-call time, and
   the plain version's and a PyTorch library call's device times (attention's
   in bf16 too). Each shape's record names what served it: attention's tiling,
   the GN forward's and the GN backward's variant, cluster size and block
   size; a path shape that a GN cluster variant does not serve fails the
   run, and two backward launches on the same inputs must be bit-equal. Edge
   shapes of the redesigned kernels are compared and not timed: T off the
   tiles, T=1024 with D=256, small D, a D that the wrapper must refuse; for
   both GN kernels slabs that are misaligned, ragged or too large (general
   variant), a cluster of 8, an H*W that is no power of two, and a cluster
   launch inside a CUDA graph; for the backward also a chain without dx.
   ``launch_floor_ms`` is an empty kernel's device time, the floor under the
   small shapes. Every comparison in full goes to
   ``chiprun_out/chip_smoke_kernels.json``.
3. ``serving``: ``PDAEService`` at the full celeba64 width (ShiftUNet
   ``CELEBA64_DPM`` + 64px encoder, latent 512, seeded random weights with the
   zero-init layers perturbed) answers an ``encode`` and an ``autoencode``
   request (b8, ddim100/ddim100). The launch counters, reset just before each
   request, must show exactly the launches the models' structure predicts.
4. ``train``: the representation-learning train step at the same width
   (Adam lr 1e-4, fp32 with TF32 off, batch 32 of seeded uint8 images): one
   warm-up step, then 5 timed ones. Every loss must be finite, every step's
   launch counters (forward GN, backward GN, attention) must equal the
   structure's counts, every GN launch forward and backward must have gone to
   the cluster variant, every trainable parameter must have moved with a finite
   gradient, every frozen one must be bit-equal to its start, and most of the
   EMA's tensors must have moved (all finite).
5. ``serving_ops``: the service's other ops at the same width, with a seeded
   random MLPSkipNet (the celeba64 latent DPM: input 512, model_channel 2048,
   10 layers) and ``Linear(512, 40)`` classifier and latent stats made from
   the seed: ``generate`` b8 ddim100/ddim100, ``manipulate`` b8
   (``attribute="Smiling"``, scale 0.3) at ddim100/ddim100, ``autoencode``
   b8 at dpm20/dpm20, and a ``CoalescingBatcher`` taking one image from each
   of 8 threads to ``autoencode`` at ddim5/ddim5. Each op's launch counters,
   reset just before it, must equal what the models' structure and the
   realized step counts predict, every GN launch on the cluster variant.
   The kernels phase checks the kernels at the shapes of the b1, b2 and b4
   buckets too.
6. ``whole_path``: one full-width ShiftUNet forward at b2, one b2
   ddim5/ddim5 autoencode and one b2 train step (loss and every trainable
   gradient, from the same state, ``t`` and noise) with the kernels against
   the plain versions (``set_use_kernels(False)``) on the card; and at b2,
   on the service's models, kernels against plain versions: the latent
   DPM's ``latent_diffusion_sample`` from fixed z_T and x_T at ddim5/ddim5,
   ``manipulate`` at ddim5/ddim5, ``autoencode`` at dpm5/dpm5 and a ddim5
   trajectory interpolation at alpha 0.5, each within one uint8 level or,
   where more, within what the plain path gives against itself when every
   decoder output moves by the relative size of one kernel forward's error
   (three seeded draws), and each kernel path bit-equal when repeated.

7. ``trainer``: ``RepresentationLearningTrainer`` at full width from a config
   dict (the celeba64 PDAE over the ``CELEBA64_DPM`` trunk, latent 512,
   SYNTHETIC 64px RGB of 320 preloaded items, b32, Adam lr 1e-4, EMA 0.9999,
   fp32 with TF32 off, ``cudnn.deterministic``), the trunk grafted from a
   seeded celeba64 UNet that the port's ``save_checkpoint`` wrote under
   ``ema_denoise_fn``. Run A trains 6 steps, saving ``latest.ckpt`` at 3 and
   6 and writing an 8-image ddim100 eval grid at 6; every loss must be
   finite, every step's launches must equal the train phase's structure
   counts (GN on the cluster variant), the eval's those of 100 b8 ShiftUNet
   evaluations and an encoder pass, the trunk must equal the DPM at start and
   end, the grid must have ``make_grid``'s size. Run B, a fresh trainer,
   resumes a copy of A's step-3 file: its state must equal the file bit for
   bit, and after training to 6 its params, EMA and Adam moments must equal
   A's bit for bit. The phase prints the trainer's step against the bare step
   (the train phase's, and one under the same deterministic algorithms), the
   loop's wait per save and the background write's seconds, the checkpoint's
   bytes, the eval's seconds and peak memory; it fails if ``yaml`` or
   ``msgpack`` was imported, or ``PIL`` other than through TensorFlow. The
   checkpoints (1.67 GB each) are deleted when the script ends;
   ``metrics.jsonl`` and the grid stay under ``chiprun_out/trainer/``.
8. ``samplers``: the sampler suite (``pdae_torch.sampling``) and
   ``PDAEService.from_config`` on the trainer phase's files, as a user
   would run them: its ``config.yml``, step-6 ``latest.ckpt`` and seeded DPM,
   beside a seeded celeba64 MLPSkipNet and ``Linear(512, 40)`` that the phase
   writes under ``ema_latent_denoise_fn`` and ``ema_classifier``; SYNTHETIC
   64px images; fp32, TF32 off. ``InferLatents`` (64 images, b32) writes the
   stats the later steps read, held to a direct encoder pass; the
   ``AutoencodingEval`` (32 images, b16, dpm20/dpm20) prints SSIM, MSE,
   seconds and imgs/s, runs again on the plain versions (each
   reconstruction within the larger of one uint8 level and the whole_path
   phase's control) and predicts the reference styles' time from its time
   per evaluation; ``from_config`` serves a b8 dpm20 ``autoencode``,
   ``generate`` and ``manipulate`` bit-equal to the service built in memory
   from the same trees (``cudnn.deterministic``); every other sampler runs
   once at ddim20/dpm20 styles, ``gap_measure`` and ``autoencoding_example``
   (whose DDPM row runs every step) under a 100-step schedule, each PNG of
   its layout's size, and ``denoise_one_step`` once more through
   ``python -m pdae_torch.sample``. Each run's model calls and kernel
   launches must equal the structure's, every GN launch on the cluster
   variant. Every attention and GN input shape those runs give (b2, b3,
   b5, b9, b16 ... as each sampler batches) is then held to the plain
   versions in fp32 and bf16 and must plan the cluster variant, as the
   kernels phase holds its shapes; the shapes it already compared are not
   compared again (full table in ``chiprun_out/chip_smoke_sampler_shapes.json``).

9. ``metrics``: LPIPS, InceptionV3 and FID (``pdae_torch.metrics``) and the
   process layer (``pdae_torch.parallel``), on the samplers phase's files,
   over seeded weights at full width (AlexNet LPIPS 64-192-384-256-256,
   InceptionV3 at the torchvision channel table) that the phase writes in
   ``pdae_tpu``'s flat layouts; fp32, TF32 off. LPIPS and the Inception
   features at b2 on the card against the CPU, at 64px and 320px (the resize
   to 299 up and down), within 1e-4 of the largest magnitude; Inception
   imgs/s over two sets of 2,560 SYNTHETIC 64px images in chunks of 64 and
   LPIPS pairs/s at b16 (device ms between CUDA events, and wall seconds),
   and the host seconds of the statistics and of ``frechet_distance`` at
   2048-d; ``AutoencodingEval`` with ``lpips_weights`` (32 images, b16,
   dpm20/dpm20) beside the samplers phase's run, and ``UnconditionalSample``
   with ``fid`` (256 samples, b64, ddim10/ddim10, against the features of
   2,560 SYNTHETIC images), each run's model calls and kernel launches held
   to the structure and every new kernel shape to the plain versions
   (``chiprun_out/chip_smoke_metrics_shapes.json``); then ``AutoencodingEval``
   (with LPIPS) and ``InferLatents`` again as two ranks on the one card
   (``python3 chip_smoke.py --rank-worker``, gloo for the objects), each
   within the one-process run's values plus the gap of a control (one
   process over the ranks' batches, in their order) and the means' order.
10. ``stages``: the regular, latent and manipulation trainers through
   ``pdae_torch.train``'s code (``pick_trainer``, the trainer, its loop) from
   config dicts of ``configs/dpm_celeba64.yml`` (the full-width celeba64 UNet,
   b32, Adam), ``configs/celeba64_latent.yml`` (MLPSkipNet 512 -> 2048, 10
   layers, b128, AdamW; over the trainer phase's step-6 PDAE and the samplers
   phase's InferLatents stats) and ``configs/celebahq_manipulation.yml``
   (``Linear(512, 40)`` at 128px, b128; over a seeded PDAE of the
   ``configs/dpm_celebahq.yml`` trunk and the 128px encoder that the phase
   writes), each on SYNTHETIC data that is uint8 and device-resident (the
   regular corpus flipped on the card). Each: run A 6 steps (saves at 3 and 6,
   the eval at 6: an 8-image ddim100 grid, a ddim100/ddim100 latent sample
   of 8, a ddim100/ddim100 manipulation where the trainer's default is
   ddim500/ddim200), run B resumed from A's step-3 file to 6 and bit-equal to
   A (``cudnn.deterministic``); for the latent and manipulation stages run
   P with ``latent_train_source: precomputed`` (the corpus encoded once in
   chunks of 512), each loss within 1e-5 of A's. Every step's launches equal
   the structure's (GN forward and backward on the cluster variant), every
   eval's too; step seconds, peak memory, save waits and writes, eval seconds
   and a profiled step's device idle share are printed. Every kernel key
   the runs give that no earlier phase compared (the plain UNet's GN backward
   with AdaGN and no z, b128 and b512 encoder passes, the 128px models) is
   held to the plain versions in fp32 and bf16 and its variant recorded; the
   regular step's kernel time per step is summed from the per-shape times
   (``chiprun_out/chip_smoke_stage_shapes.json``).
11. ``precision``: bf16 compute over fp32 params and rematerialisation at
   full width. The trainer phase's ``RepresentationLearningTrainer`` config
   and the stages phase's ``configs/dpm_celeba64.yml`` dict with
   ``runner_config.compute_dtype: bfloat16``, one warm-up and 5 timed b32
   steps each: finite losses, fp32 params and grads, every conv and linear in
   bf16, the frozen trunk bit-equal, launches equal to the structure's (GN on
   the cluster variant, attention's bf16 keys on the ``mma.sync`` tiles),
   step seconds and peak memory beside the fp32 phases'. At b2 one ShiftUNet
   forward and both steps' loss and gradients through the bf16 kernels
   against the bf16 plain versions, each within PRECISION_RATIO times the
   plain path's own bf16-against-fp32 gap (printed with the ratio). Then the
   FFHQ128 representation step (``configs/ffhq_representation_learning.yml``
   over a seeded trunk of ``configs/dpm_ffhq.yml``, SYNTHETIC 128px, b32)
   under remat none, ``skips`` and full, in fp32 and bf16, each from the same
   state, t and noise (``cudnn.deterministic``): one warm-up and 2 timed
   steps, the launches against ``remat_structure``, the modes' losses and
   first gradients bit-equal (or each within REMAT_GRAD_TOL of its tensor's
   largest), seconds and peak memory printed. Every kernel key these runs
   give that no earlier phase compared is held to the plain versions in fp32
   and bf16 on the cluster variant, the 128x128 GN keys timed
   (``chiprun_out/chip_smoke_precision_shapes.json``). The kernels phase
   times every timed shape in bf16 too (``bf16_ms``, ``bf16_library_ms``,
   ``bf16_bound_ms``; bf16 attention's bound on the tensor cores' 989
   TFLOP/s), and the summary sums them over a train step.
12. ``ingest``: the files a user brings, through the port's CLIs and the
   native host code. 256 seeded JPEGs at CelebA's 178x218 (quality 95) packed
   by ``python -m pdae_torch.prepare_lmdb --key-format 'None-%07d'``; the
   trainer phase's DPM exported to a reference ``.pt`` by ``python -m
   pdae_torch.convert --export`` and converted back, bit-equal on every leaf
   and byte-equal as a file; the celeba64 ``RepresentationLearningTrainer``
   (the trainer phase's config, b32, fp32, TF32 off) from the converted DPM
   on CELEBA64 over the LMDB with ``fast_decode`` at its default (the train
   split cut to the packed images), one warm-up and 4 timed steps, each
   step's launches held to the structure, with ``time/load_data`` per step
   and the reader and decoder that ran; on the host, the native and PIL
   decode of every packed image at the CELEBA64 crop to 64 px in imgs/s at 1
   and 4 threads (native within 3 levels of PIL and within 1 on 99% of
   values) and the native and pure-Python readers' gets/s; last, the trained
   checkpoint exported to ``.pt``, converted back (the trees bit-equal) and
   served by ``PDAEService.from_config``: a b8 ddim10/ddim10 ``autoencode``
   bit-equal to the same request on the unconverted checkpoint, its launches
   held to the structure. ``cudnn.deterministic`` throughout. The native
   reader must build; the decoder may fall back to PIL only where
   ``/usr/include/jpeglib.h`` is missing (``"decoder": "pil"`` and the
   compiler's last line). The phase's images, LMDB and checkpoints are
   deleted when it ends. Then the script's total seconds.

Then a ``{"kernels": [...]}`` summary line, the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them,
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

LATENT = 512
BATCH = 8
STEPS = 100                      # ddim100 encode + ddim100 decode
TRAIN_BATCH = 32                 # the 64px train batch of the JAX package's bench
BUCKETS = (1, 2, 4)              # the smaller buckets the batcher forms
# the celeba64 latent DPM (configs/celeba64_latent.yml) and the manipulation
# classifier over its 40 CelebA-HQ attributes
LATENT_CONFIG = {"model": "CELEBA64LatentDenoiseFn", "input_channel": LATENT,
                 "model_channel": 2048, "num_layers": 10, "time_emb_channel": 64,
                 "use_norm": True, "dropout": 0.0}
NUM_CLASSES = 40
TRAIN_STEPS = 5                  # timed, after one warm-up step
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores
BF16_FLOPS = 989e12              # H100 SXM, bf16 on the tensor cores (dense)

# Tolerances: |kernel - plain| <= atol + rtol * |plain| elementwise.
TOL = {
    # fp32: the kernel and the plain version sum in another order
    ("attention", torch.float32): (2e-5, 1e-4),
    ("gn_model", torch.float32): (1e-4, 1e-4),
    ("gn_fold", torch.float32): (1e-4, 1e-4),
    # bf16: the plain attention rounds q*scale and k*scale to bf16 before the
    # fp32 logits (the JAX reference does too), the kernel does not; a stat
    # that differs in its last bit can move a GN output by a bf16 step
    ("attention", torch.bfloat16): (2e-2, 2e-2),
    ("gn_model", torch.bfloat16): (3e-2, 2e-2),
    ("gn_fold", torch.bfloat16): (3e-2, 2e-2),
    # GN backward (dx, dA, dB): kernel and plain version compute in fp32 from
    # the same stats and sum H*W terms in another order; atol is times
    # max(1, max|plain|) of the tensor compared, as the JAX package's own
    # backward test scales it. bf16: dx is rounded to bf16 at the end
    ("gn_bwd", torch.float32): (1e-4, 1e-4),
    ("gn_bwd", torch.bfloat16): (3e-2, 2e-2),
    # the saved [B, G] mean and rstd: a sum over the slab in another order
    ("gn_stats", torch.float32): (1e-5, 1e-4),
    ("gn_stats", torch.bfloat16): (1e-5, 1e-4),
}
WHOLE_PATH_TOL = (1e-4, 1e-3)    # (atol, rtol): one ShiftUNet forward, fp32
# one train step, kernels against plain versions: loss relative, and every
# trainable gradient within atol * (that tensor's own max|plain grad|) +
# rtol * |plain|, so that a tensor whose gradients are small is held as
# tightly as one whose gradients are large; none may be all zero
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = (1e-3, 1e-3)
# every comparison in full, beside the printed summary
ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
# attention shapes that are compared and not timed: T off the query and key
# tiles, the TPU kernel's limits, small D
ATTENTION_EDGES = [(1, 1, 1024, 256), (2, 3, 50, 36), (1, 2, 1000, 64), (3, 1, 16, 16),
                   (2, 2, 77, 8), (2, 2, 1024, 128), (3, 2, 100, 32)]
# GN shapes that are compared and not timed, with the variant that must serve
# each (fp32): a cluster of 8, H*W no power of two, H*W no multiple of the
# 16-byte vector, a slab over 8 x 64 KB
GN_EDGES = [((1, 64, 256, 256), ("cluster", 8)), ((2, 64, 12, 12), ("cluster", 1)),
            ((2, 64, 3, 3), ("general", 0)), ((1, 64, 384, 384), ("general", 0))]
# GN backward shapes that are compared and not timed, (shape, AdaGN and z,
# dx), with the variant that must serve each (fp32): a cluster of 8 with two
# channels a group, no dx over a cluster of 4, H*W no power of two, H*W no
# multiple of the vector, a slab pair over 8 parts
GN_BWD_EDGES = [(((1, 64, 128, 256), True, True), ("cluster", 8)),
                (((2, 256, 64, 64), False, False), ("cluster", 4)),
                (((2, 64, 12, 12), True, True), ("cluster", 1)),
                (((2, 64, 3, 3), True, True), ("general", 0)),
                (((1, 64, 384, 384), False, True), ("general", 0))]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Time per eager call over ``iters`` back-to-back calls (CUDA events):
    for a small kernel this is the host's dispatch cost, the card idling."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call without the host: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * reps)


def timings(kernel, plain, library) -> dict:
    return {"ms": device_ms(kernel), "host_ms": host_ms(kernel),
            "plain_ms": device_ms(plain), "library_ms": device_ms(library)}


def scaled(tol, want):
    """``tol`` with its atol times max(1, max|want|)."""
    return (tol[0] * max(1.0, float(want.float().abs().max())), tol[1])


def compare(got, want, tol) -> dict:
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError("kernel output is not finite")
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return {"max_abs_err": float(diff.max()),
            "max_rel_err": float((diff / want.abs().clamp_min(1e-6)).max()),
            "atol": atol, "rtol": rtol, "ok": ok}


def perturb_zero_params(module, gen) -> None:
    """Give every all-zero parameter (zero-init output convs and attention
    projections, biases) small random values, so no branch is silent."""
    with torch.no_grad():
        for p in module.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)


def build_models(seed, device):
    """The celeba64 ShiftUNet and 64px encoder at full width on ``device``, in
    eval mode, with seeded random weights; and the seeded CPU generator that
    made them, which goes on to make the kernels' inputs."""
    from pdae_torch.models import CELEBA64_DPM, ShiftUNet, encoder_for_resolution

    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM)
    encoder = encoder_for_resolution(64, LATENT)
    perturb_zero_params(decoder, gen)
    perturb_zero_params(encoder, gen)
    return decoder.to(device).eval(), encoder.to(device).eval(), gen


def path_shapes(decoder, encoder, device, train=False, batch=BATCH):
    """Count, per input shape, the GN chains and attention blocks of one
    ShiftUNet evaluation and one encoder pass at ``batch``. With ``train``
    the pass is the train step's (the encoder's z feeds the decoder, grad
    enabled, at b2 with the batch then written as TRAIN_BATCH), and a chain
    that will run a backward is also counted under ``("gn_bwd", *shape,
    has_st, has_z, need_dx)``."""
    from pdae_torch import ops
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain

    dec_counts, enc_counts = collections.Counter(), collections.Counter()
    current = [None]
    batch = TRAIN_BATCH if train else batch

    def gn_hook(mod, args):
        x = args[0]
        has_st = len(args) > 1 and args[1] is not None
        has_z = len(args) > 3 and args[3] is not None
        shape = (batch,) + tuple(x.shape[1:])
        current[0][("gn",) + shape + (has_st, has_z)] += 1
        if torch.is_grad_enabled() and any(
                a is not None and a.requires_grad for a in (*args, mod.weight)):
            current[0][("gn_bwd",) + shape + (has_st, has_z, x.requires_grad)] += 1

    def attn_hook(mod, args):
        _, c, h, w = args[0].shape
        current[0][("attention", batch, mod.num_heads, h * w,
                    c // mod.num_heads)] += 1

    handles = []
    for model in (decoder, encoder):
        for m in model.modules():
            if isinstance(m, GNSiluChain):
                handles.append(m.register_forward_pre_hook(gn_hook))
            elif isinstance(m, AttentionBlock):
                handles.append(m.register_forward_pre_hook(attn_hook))
    ops.set_use_kernels(False)
    try:
        if train:
            x = torch.zeros(2, 3, 64, 64, device=device)
            current[0] = enc_counts
            z = encoder(x)
            current[0] = dec_counts
            decoder(x, torch.zeros(2, dtype=torch.int32, device=device), z)
            del z
        else:
            with torch.inference_mode():
                current[0] = dec_counts
                decoder(torch.zeros(batch, 3, 64, 64, device=device),
                        torch.zeros(batch, dtype=torch.int32, device=device),
                        torch.zeros(batch, LATENT, device=device))
                current[0] = enc_counts
                encoder(torch.zeros(batch, 3, 64, 64, device=device))
    finally:
        ops.set_use_kernels(None)
        for h in handles:
            h.remove()
    return dec_counts, enc_counts


def check_attention(shape, gen, device, timed=True):
    from pdae_torch import ops
    from pdae_torch.ops import attention

    b, h, t, d = shape
    scale = 1.0 / math.sqrt(math.sqrt(d))
    res = {"shape": list(shape), "err": {}, "tiling": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        if (d * dtype.itemsize) % 16:
            continue                 # the wrapper refuses it: see check_edges
        q, k, v = (torch.randn(shape, generator=gen, device=gen.device).to(device, dtype)
                   for _ in range(3))
        got = attention.attention_cuda(q, k, v)
        torch.cuda.synchronize()
        plan = attention.attention_plan(b * h, t, d, q.element_size())
        if attention.library_smem_bytes(plan, t, d, q.element_size()) != plan.smem_bytes:
            raise AssertionError(f"attention {shape} {name}: the plan's shared memory "
                                 "is not the built source's")
        res["tiling"][name] = plan._asdict()
        res["err"][name] = compare(got, ops.reference_attention(q, k, v, scale),
                                   TOL[("attention", dtype)])
        if not timed:
            continue

        def library():
            return F.scaled_dot_product_attention(q, k, v, scale=1.0 / math.sqrt(d))

        if dtype == torch.float32:
            res.update(timings(lambda: attention.attention_cuda(q, k, v),
                               lambda: ops.reference_attention(q, k, v, scale), library))
            res["bytes"] = 4 * q.numel() * q.element_size()
            res["flops"] = 4 * b * h * t * t * d
        else:
            res["bf16_ms"] = device_ms(lambda: attention.attention_cuda(q, k, v))
            res["bf16_library_ms"] = device_ms(library)
            # the mma tiles run both products on the tensor cores
            res["bf16_bound_ms"] = max(4 * q.numel() * 2 / HBM_BYTES_PER_S,
                                       4 * b * h * t * t * d / BF16_FLOPS) * 1e3
    return res


def gn_coefficients(shape, has_st, has_z, gen, device, dtype):
    """A GN chain's inputs, drawn from ``gen`` on its own device (a CUDA
    generator draws the large slabs where they are used)."""
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen, device=gen.device).to(device, dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen, device=gen.device)).to(device)
    beta = (0.1 * torch.randn(c, generator=gen, device=gen.device)).to(device)
    # the halves of one [B, 2C] Linear output, strided as the ResBlocks pass them
    st = (0.1 * torch.randn(b, 2 * c, generator=gen, device=gen.device)).to(
        device, dtype).chunk(2, dim=1)
    zz = (0.1 * torch.randn(b, 2 * c, generator=gen, device=gen.device)).to(
        device, dtype).chunk(2, dim=1)
    return (x, gamma, beta, *(st if has_st else (None, None)),
            *(zz if has_z else (None, None)))


def library_gn(x, gamma, beta, s, t, zs, zt, groups):
    y = F.group_norm(x, groups, gamma, beta, 1e-5)
    if s is not None:
        y = y * (1 + s[:, :, None, None]) + t[:, :, None, None]
    if zs is not None:
        y = (1 + zs[:, :, None, None]) * y + zt[:, :, None, None]
    return F.silu(y)


def library_gn_saved(x, gamma, beta, s, t, zs, zt, groups):
    """What autograd keeps of ``library_gn``'s forward for its backward."""
    b, c = x.shape[:2]
    gn, mean, rstd = torch.ops.aten.native_group_norm(
        x, gamma, beta, b, c, x[0, 0].numel(), groups, 1e-5)
    y = gn
    y1 = None
    if s is not None:
        y = y1 = gn * (1 + s[:, :, None, None]) + t[:, :, None, None]
    if zs is not None:
        y = (1 + zs[:, :, None, None]) * y + zt[:, :, None, None]
    return x, gamma, mean, rstd, gn, y1, y, s, zs, groups


def library_gn_backward(g, saved, need_dx):
    """The backward autograd runs for ``library_gn``, op by op: PyTorch's
    ``silu_backward``, the elementwise tail with its spatial sums, then
    ``native_group_norm_backward``. Written out (and not left to
    ``torch.autograd.grad``) so that a CUDA graph can capture it."""
    x, gamma, mean, rstd, gn, y1, y, s, zs, groups = saved
    b, c = x.shape[:2]
    d = torch.ops.aten.silu_backward(g, y)
    grads = []
    if zs is not None:
        inner = gn if y1 is None else y1
        grads += [(d * inner).sum(dim=(2, 3)), d.sum(dim=(2, 3))]
        d = d * (1 + zs[:, :, None, None])
    if s is not None:
        grads += [(d * gn).sum(dim=(2, 3)), d.sum(dim=(2, 3))]
        d = d * (1 + s[:, :, None, None])
    return grads + list(torch.ops.aten.native_group_norm_backward(
        d, x, mean, rstd, gamma, b, c, x[0, 0].numel(), groups,
        [need_dx, True, True]))


def check_gn(key, gen, device, timed=True):
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm

    shape, has_st, has_z = key[1:5], key[5], key[6]
    groups = 32
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "err": {}, "variant": {}}
    for dtype in (torch.float32, torch.bfloat16):
        args = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
        before = dict(groupnorm.variant_launches)
        got = groupnorm.gn_cuda(*args, groups=groups)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        # what served it: the variant whose counter the launch raised, and the
        # plan the wrapper made for this input and the output it returned
        served = [v for v, n in groupnorm.variant_launches.items() if n != before[v]]
        plan = groupnorm.plan_for(args[0], got, groups)
        if served != [plan.variant]:
            raise AssertionError(f"GN {shape} {name}: served by {served}, planned {plan}")
        res["variant"][name] = plan._asdict()
        res["err"][f"model_{name}"] = compare(
            got, ops.gn_adagn_silu_fwd(*args, groups=groups), TOL[("gn_model", dtype)])
        x, gamma, beta, s, t, zs, zt = args
        zero = torch.zeros(shape[0], shape[1], device=device, dtype=dtype)
        full = (s if s is not None else zero, t if t is not None else zero,
                zs if zs is not None else zero, zt if zt is not None else zero)
        got = groupnorm.gn_cuda(x, gamma, beta, *full, groups=groups, fold=True)
        torch.cuda.synchronize()
        res["err"][f"fold_{name}"] = compare(
            got, ops.reference_gn_adagn_silu(x, gamma, beta, *full, groups),
            TOL[("gn_fold", dtype)])
        if dtype == torch.float32 and timed:
            res.update(timings(
                lambda: groupnorm.gn_cuda(*args, groups=groups),
                lambda: ops.gn_adagn_silu_fwd(*args, groups=groups),
                lambda: library_gn(*args, groups)))
            res["bytes"] = (2 * x.numel() * x.element_size() + 8 * shape[1]
                            + sum(a.numel() * a.element_size()
                                  for a in (s, t, zs, zt) if a is not None))
            res["flops"] = 15 * x.numel()
        elif timed:
            # bf16: the library call on bf16 GroupNorm parameters (cast once)
            lib = (x, gamma.to(dtype), beta.to(dtype), s, t, zs, zt)
            res["bf16_ms"] = device_ms(lambda: groupnorm.gn_cuda(*args, groups=groups))
            res["bf16_library_ms"] = device_ms(lambda: library_gn(*lib, groups))
            bf16_bytes = (2 * x.numel() * x.element_size() + 8 * shape[1]
                          + sum(a.numel() * a.element_size()
                                for a in (s, t, zs, zt) if a is not None))
            res["bf16_bound_ms"] = max(bf16_bytes / HBM_BYTES_PER_S,
                                       15 * x.numel() / FP32_FLOPS) * 1e3
    return res


def check_gn_bwd(key, gen, device, timed=True):
    """The backward kernel against its plain version at one shape of the
    train step: dx (where the chain's input needs one), dA and dB, and a
    second launch on the same inputs bit-equal to the first; the variant that
    served it; the forward kernel's saved stats against the plain forward's;
    and that asking for the stats leaves the forward's output bit-equal to
    the one ``check_gn`` holds against the plain forward at this shape."""
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm, groupnorm_train

    shape, has_st, has_z, need_dx = key[1:5], key[5], key[6], key[7]
    groups = 32
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "dx": need_dx, "err": {},
           "variant": {}, "bit_equal_repeat": {}}
    for dtype in (torch.float32, torch.bfloat16):
        args = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
        x, gamma, beta, coef = args[0], args[1], args[2], args[3:]
        g = torch.randn(shape, generator=gen, device=gen.device).to(device, dtype)
        out, mean, rstd = groupnorm.gn_cuda(*args, groups=groups, save_stats=True)
        torch.cuda.synchronize()
        if not torch.equal(out, groupnorm.gn_cuda(*args, groups=groups)):
            raise AssertionError(f"saving the stats changed the forward at {shape}")
        _, mean_p, rstd_p = ops.gn_adagn_silu_fwd(*args, groups=groups,
                                                  return_stats=True)
        name = str(dtype).split(".")[-1]
        res["err"][f"mean_{name}"] = compare(mean, mean_p, TOL[("gn_stats", dtype)])
        res["err"][f"rstd_{name}"] = compare(rstd, rstd_p, TOL[("gn_stats", dtype)])
        before = dict(groupnorm_train.variant_launches)
        got = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef,
                                          groups=groups, need_dx=need_dx)
        torch.cuda.synchronize()
        served = [v for v, n in groupnorm_train.variant_launches.items() if n != before[v]]
        plan = groupnorm_train.plan_for(x, g, got[0], groups)
        if served != [plan.variant]:
            raise AssertionError(f"GN backward {shape} {name}: served by {served}, "
                                 f"planned {plan}")
        res["variant"][name] = plan._asdict()
        again = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef,
                                            groups=groups, need_dx=need_dx)
        torch.cuda.synchronize()
        res["bit_equal_repeat"][name] = all(
            a is None and b is None or torch.equal(a, b) for a, b in zip(got, again))
        if not res["bit_equal_repeat"][name]:
            raise AssertionError(f"GN backward {shape} {name}: two launches differ")
        want = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef,
                                           groups=groups, need_dx=need_dx)
        for part, a, b in zip(("dx", "dA", "dB"), got, want):
            if a is None and b is None and not need_dx:
                continue
            res["err"][f"{part}_{name}"] = compare(
                a, b, scaled(TOL[("gn_bwd", dtype)], b))
        if dtype == torch.float32 and timed:
            saved = library_gn_saved(x, gamma, beta, *coef, groups)
            res.update(
                ms=device_ms(lambda: groupnorm_train.gn_bwd_cuda(
                    x, g, mean, rstd, gamma, beta, *coef, groups=groups,
                    need_dx=need_dx)),
                host_ms=host_ms(lambda: groupnorm_train.gn_bwd_cuda(
                    x, g, mean, rstd, gamma, beta, *coef, groups=groups,
                    need_dx=need_dx)),
                plain_ms=device_ms(lambda: ops.gn_adagn_silu_bwd_plain(
                    x, g, mean, rstd, gamma, beta, *coef, groups=groups,
                    need_dx=need_dx)))
            res["library_ms"] = device_ms(
                lambda: library_gn_backward(g, saved, need_dx))
            res["bytes"] = ((3 if need_dx else 2) * x.numel() * x.element_size()
                            + 8 * shape[1] + 8 * shape[0] * groups
                            + 8 * shape[0] * shape[1]
                            + sum(a.numel() * a.element_size()
                                  for a in coef if a is not None))
            res["flops"] = (45 if need_dx else 25) * x.numel()
        elif timed:
            saved = library_gn_saved(x, gamma.to(dtype), beta.to(dtype), *coef, groups)
            res["bf16_ms"] = device_ms(lambda: groupnorm_train.gn_bwd_cuda(
                x, g, mean, rstd, gamma, beta, *coef, groups=groups, need_dx=need_dx))
            res["bf16_library_ms"] = device_ms(
                lambda: library_gn_backward(g, saved, need_dx))
            bf16_bytes = ((3 if need_dx else 2) * x.numel() * x.element_size()
                          + 8 * shape[1] + 8 * shape[0] * groups + 8 * shape[0] * shape[1]
                          + sum(a.numel() * a.element_size() for a in coef if a is not None))
            res["bf16_bound_ms"] = max(bf16_bytes / HBM_BYTES_PER_S,
                                       (45 if need_dx else 25) * x.numel() / FP32_FLOPS) * 1e3
    return res


def check_edges(gen, device) -> dict:
    """The redesigned kernels where their tilings end, compared and not
    timed: every record's ``err`` entries are held to ``TOL`` like a path
    shape's. Also: the attention wrapper refuses a D whose rows are no
    multiple of 16 bytes; a misaligned GN input (forward: x; backward: x or
    g) goes to the general variant and agrees with the aligned one; a cluster
    launch of either GN kernel captured in a CUDA graph replays to the eager
    result."""
    from pdae_torch.ops import attention, groupnorm, groupnorm_train

    attn = [check_attention(shape, gen, device, timed=False) for shape in ATTENTION_EDGES]
    q = torch.randn(1, 1, 8, 6, device=device)
    try:
        attention.attention_cuda(q, q, q)
    except ValueError as e:
        refused = "16 bytes" in str(e)
    else:
        refused = False
    if not refused:
        raise AssertionError("the attention wrapper took D=6 (rows of 24 bytes)")

    gn = []
    for shape, want in GN_EDGES:
        res = check_gn(("gn", *shape, True, True), gen, device, timed=False)
        got = (res["variant"]["float32"]["variant"], res["variant"]["float32"]["cluster"])
        if got != want:
            raise AssertionError(f"GN edge {shape}: served by {got}, expected {want}")
        gn.append(res)

    # a misaligned x (4 bytes into its storage) must take the general variant
    shape = (2, 64, 8, 8)
    args = gn_coefficients(shape, True, False, gen, device, torch.float32)
    x = args[0]
    off = torch.empty(x.numel() + 1, device=device)[1:].view(shape).copy_(x)
    before = dict(groupnorm.variant_launches)
    aligned = groupnorm.gn_cuda(*args, groups=32)
    shifted = groupnorm.gn_cuda(off, *args[1:], groups=32)
    torch.cuda.synchronize()
    took = {v: n - before[v] for v, n in groupnorm.variant_launches.items()}
    misaligned = compare(shifted, aligned, TOL[("gn_model", torch.float32)])
    if took != {"cluster": 1, "general": 1} or off.data_ptr() % 16 == 0:
        raise AssertionError(f"misaligned GN input: variants took {took}")

    # a cluster launch (4 blocks per slab) inside a CUDA graph
    args = gn_coefficients((8, 384, 64, 64), False, False, gen, device, torch.float32)
    eager = groupnorm.gn_cuda(*args, groups=32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupnorm.gn_cuda(*args, groups=32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = groupnorm.gn_cuda(*args, groups=32)
    graph.replay()
    torch.cuda.synchronize()
    graph_ok = torch.equal(captured, eager)
    if not graph_ok:
        raise AssertionError("a captured cluster launch does not replay to the eager result")

    bwd = []
    for (shape, adagn_z, need_dx), want in GN_BWD_EDGES:
        res = check_gn_bwd(("gn_bwd", *shape, adagn_z, adagn_z, need_dx), gen, device,
                           timed=False)
        got = (res["variant"]["float32"]["variant"], res["variant"]["float32"]["cluster"])
        if got != want:
            raise AssertionError(f"GN backward edge {shape}: served by {got}, "
                                 f"expected {want}")
        bwd.append(res)

    # a misaligned x, then a misaligned g (4 bytes into their storage): the
    # general variant, in agreement with the aligned launch on the cluster one
    shape = (2, 64, 8, 8)
    args = gn_coefficients(shape, True, True, gen, device, torch.float32)
    x, gamma, beta, coef = args[0], args[1], args[2], args[3:]
    g = torch.randn(shape, generator=gen).to(device)
    _, mean, rstd = groupnorm.gn_cuda(*args, groups=32, save_stats=True)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=device)[1:].view(t.shape).copy_(t)

    bwd_misaligned = {}
    for what, xs, gs in (("x", shifted(x), g), ("g", x, shifted(g))):
        before = dict(groupnorm_train.variant_launches)
        aligned = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
        off = groupnorm_train.gn_bwd_cuda(xs, gs, mean, rstd, gamma, beta, *coef)
        torch.cuda.synchronize()
        took = {v: n - before[v] for v, n in groupnorm_train.variant_launches.items()}
        if took != {"cluster": 1, "general": 1}:
            raise AssertionError(f"misaligned GN backward {what}: variants took {took}")
        for part, a, b in zip(("dx", "dA", "dB"), off, aligned):
            bwd_misaligned[f"{what}_{part}"] = compare(
                a, b, scaled(TOL[("gn_bwd", torch.float32)], b))

    # a cluster launch of the backward (4 blocks per slab) inside a CUDA graph
    shape = (8, 256, 64, 64)
    args = gn_coefficients(shape, False, False, gen, device, torch.float32)
    g = torch.randn(shape, generator=gen).to(device)
    _, mean, rstd = groupnorm.gn_cuda(*args, groups=32, save_stats=True)
    bwd_args = (args[0], g, mean, rstd, args[1], args[2])
    eager = groupnorm_train.gn_bwd_cuda(*bwd_args)
    if groupnorm_train.plan_for(args[0], g, eager[0], 32).cluster != 4:
        raise AssertionError("the backward's graph edge is not a cluster of 4")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupnorm_train.gn_bwd_cuda(*bwd_args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = groupnorm_train.gn_bwd_cuda(*bwd_args)
    graph.replay()
    torch.cuda.synchronize()
    bwd_graph_ok = all(torch.equal(a, b) for a, b in zip(captured, eager))
    if not bwd_graph_ok:
        raise AssertionError("a captured backward cluster launch does not replay to the "
                             "eager result")
    return {"attention": attn, "gn_adagn_silu": gn, "gn_adagn_silu_bwd": bwd,
            "attention_refuses_d6": refused, "gn_misaligned": misaligned,
            "gn_bwd_misaligned": bwd_misaligned, "cluster_launch_in_graph_ok": graph_ok,
            "bwd_cluster_launch_in_graph_ok": bwd_graph_ok}


def brief(res, launches, train_launches) -> dict:
    """A per-shape record for the printed line: the launches per request and
    per train step at this shape, max abs/rel errors (3 digits; in full in
    the json file) and times."""
    out = {k: v for k, v in res.items() if k not in ("err", "bytes", "flops")}
    out["launches_per_request"] = launches
    out["launches_per_train_step"] = train_launches
    for kind in ("max_abs_err", "max_rel_err"):
        out[kind] = {k: float(f"{v[kind]:.3g}") for k, v in res["err"].items()}
    if "bytes" in res:               # a timed shape
        out["bound_ms"] = max(res["bytes"] / HBM_BYTES_PER_S,
                              res["flops"] / FP32_FLOPS) * 1e3
    return out


def launches_of(evals, encoder_passes, dec_counts, enc_counts) -> dict:
    """The kernel launches of ``evals`` ShiftUNet evaluations and
    ``encoder_passes`` encoder passes (inference: no backward)."""
    def per(counts, kind):
        return sum(v for k, v in counts.items() if k[0] == kind)

    return {"attention": evals * per(dec_counts, "attention")
            + encoder_passes * per(enc_counts, "attention"),
            "gn_adagn_silu": evals * per(dec_counts, "gn")
            + encoder_passes * per(enc_counts, "gn"),
            "gn_adagn_silu_bwd": 0}


def counted(fn):
    """``fn()`` between a reset and a read of the launch counters, on the
    host's clock up to a synchronise, with the run's peak device memory."""
    from pdae_torch import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, {"s": seconds, "launches": ops.launch_counts(),
                 "gn_variants": ops.gn_variant_counts(),
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serving_ops(service, images, dec_counts, enc_counts, seed) -> dict:
    """``generate``, ``manipulate`` and a dpm20/dpm20 ``autoencode`` at b8,
    then 8 one-image ``autoencode`` requests through a ``CoalescingBatcher``;
    each op's record, with the launches its structure predicts."""
    from pdae_torch.serving import CoalescingBatcher

    gd = service.gd
    ddim = gd.ddim_schedule(f"ddim{STEPS}").num_steps
    dpm_encode = gd.solver_tables("dpm20", direction="encode").num_steps
    dpm_decode = gd.solver_tables("dpm20").num_steps
    # the first calls build the latent DPM and the classifier: not counted
    service.generate(BATCH, seed, "ddim2", "ddim2")
    service.manipulate(images, attribute="Smiling", encode_style="ddim2",
                       decode_style="ddim2")
    style = f"ddim{STEPS}"
    runs = {
        "generate": (lambda: service.generate(BATCH, seed, style, style),
                     launches_of(ddim, 0, dec_counts, enc_counts)),
        "manipulate": (lambda: service.manipulate(images, attribute="Smiling", scale=0.3,
                                                  encode_style=style, decode_style=style),
                       launches_of(2 * ddim, 2, dec_counts, enc_counts)),
        "autoencode_dpm20": (lambda: service.autoencode(images, "dpm20", "dpm20"),
                             launches_of(dpm_encode + dpm_decode, 1, dec_counts,
                                         enc_counts)),
    }
    records = {"steps": {f"ddim{STEPS}": ddim, "dpm20_encode": dpm_encode,
                         "dpm20_decode": dpm_decode}}
    outs = {}
    for name, (fn, want) in runs.items():
        out, rec = counted(fn)
        outs[name] = out
        rec.update(imgs_per_s=BATCH / rec["s"], launches_expected=want,
                   shape=list(out.shape), dtype=str(out.dtype))
        rec["ok"] = (out.shape == images.shape and out.dtype == np.uint8
                     and rec["launches"] == want
                     and rec["gn_variants"] == {"cluster": want["gn_adagn_silu"],
                                                "general": 0})
        records[name] = rec
    # every row of generate's draws is its own image
    distinct = len({o.tobytes() for o in outs["generate"]})
    records["generate"].update(distinct_images=distinct,
                               ok=records["generate"]["ok"] and distinct == BATCH)

    # 8 clients, one image each, through the batcher: every encoder pass is
    # one call, at the bucket it was given
    small = gd.ddim_schedule("ddim5").num_steps
    buckets = []
    hook = service.encoder.register_forward_pre_hook(
        lambda mod, args: buckets.append(int(args[0].shape[0])))
    batcher = CoalescingBatcher(service, window_ms=20.0)
    replies, errors = [None] * BATCH, []

    def client(i):
        try:
            replies[i] = batcher.submit("autoencode", images[i:i + 1],
                                        encode_style="ddim5", decode_style="ddim5")
        except Exception as e:          # reported below, and fails the phase
            errors.append(repr(e))

    def run_clients():
        threads = [threading.Thread(target=client, args=(i,)) for i in range(BATCH)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        return [t.is_alive() for t in threads]

    try:
        alive, rec = counted(run_clients)
    finally:
        batcher.close()
        hook.remove()
    calls = batcher.stats()["calls"]
    want = launches_of(2 * small * calls, calls, dec_counts, enc_counts)
    rec.update(clients=BATCH, calls=calls, buckets=buckets, errors=errors,
               launches_expected=want)
    rec["ok"] = (calls < BATCH and not any(alive) and not errors
                 and len(buckets) == calls and sum(buckets) >= BATCH
                 and all(r is not None and r.shape == (1, 64, 64, 3)
                         and r.dtype == np.uint8 for r in replies)
                 and rec["launches"] == want
                 and rec["gn_variants"] == {"cluster": want["gn_adagn_silu"], "general": 0})
    records["batcher_autoencode_ddim5"] = rec
    return records


def summarise(name, source, replaces, results, per_request, per_step, launches,
              train_launches,
              per=f"one b{BATCH} ddim{STEPS}/ddim{STEPS} autoencode request "
                  "(sum over its launches)"):
    """One kernel's line: the main path's launches, and every time summed over
    the launches of one autoencode request (or, for the backward kernel, one
    train step) at that path's shapes (fp32); ``train_step_ms`` is the
    kernel's time summed over one train step's launches, ``bf16_train_step``
    the bf16 kernel's, library call's and bound's over the same launches."""
    def total(field, weights=per_request):
        return sum(weights.get(k, 0) * r[field] for k, r in results.items())

    bytes_, flops = total("bytes"), total("flops")
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "launches_per_train_step": train_launches,
            "max_abs_err": max(v["max_abs_err"] for r in results.values()
                               for key, v in r["err"].items()
                               if key.endswith("float32")),
            "ms": total("ms"), "host_ms": total("host_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"), "per": per,
            "train_step_ms": total("ms", per_step),
            # the same train step's launches in bf16 (the precision phase's)
            "bf16_train_step": {f: total(f"bf16_{f}", per_step)
                                for f in ("ms", "library_ms", "bound_ms")}}


def png_size(path) -> tuple:
    """(height, width) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def trainer_config(dpm_path) -> dict:
    """The trainer phase's run: the celeba64 PDAE over the DPM at
    ``dpm_path``, SYNTHETIC 64px, b32, Adam lr 1e-4, saves at 3 and 6, the
    eval at 6."""
    from pdae_torch.models import CELEBA64_DPM

    return {
        "train_dataset_config": {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                                 "length": 320, "preload": True, "latent_dim": LATENT},
        "eval_dataset_config": {},
        "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
        "trained_ddpm_config": {"denoise_fn_config": {"model": "UNet", **CELEBA64_DPM}},
        "trained_ddpm_checkpoint": dpm_path,
        "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
        "decoder_config": {"model": "CELEBA64Decoder", "latent_dim": LATENT},
        "dataloader_config": {"train": {"num_workers": 4, "batch_size": TRAIN_BATCH},
                              "eval": {"num_generations": BATCH}},
        "optimizer_config": {"lr": 1e-4, "adam_betas": "(0.9, 0.999)", "adam_eps": 1e-8,
                             "weight_decay": 0.0, "enable_amp": False},
        "runner_config": {"display_steps": 1, "evaluate_every_steps": 6,
                          "save_latest_every_steps": 3,
                          "save_checkpoint_every_steps": 10000, "num_iterations": 1,
                          "ema_every": 1, "ema_decay": 0.9999}}


def trainer_phase(seed, device, want_step, want_eval, bare_step_s) -> dict:
    """``RepresentationLearningTrainer`` at full width from a config dict:
    run A trains 6 steps (saves at 3 and 6, an eval grid at 6), run B resumes
    a copy of A's step-3 checkpoint and trains to 6. cuDNN runs deterministic
    algorithms for both, so B must end bit-equal to A."""
    import shutil

    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM, UNet
    from pdae_torch.training import RepresentationLearningTrainer
    from pdae_torch.utils import load_checkpoint, save_checkpoint, unet_tree
    from pdae_torch.utils.image import make_grid

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "trainer")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # the DPM to graft: a seeded celeba64 UNet, written by the port
    gen = torch.Generator().manual_seed(seed + 5)
    torch.manual_seed(seed + 5)
    unet = UNet(**CELEBA64_DPM)
    perturb_zero_params(unet, gen)
    dpm_tree = unet_tree(unet.state_dict())
    dpm_path = os.path.join(root, "dpm.ckpt")
    save_checkpoint(dpm_path, {"step": np.asarray(0, np.int32), "ema_denoise_fn": dpm_tree})
    dpm_sd = {k: v.to(device) for k, v in unet.state_dict().items()}
    del unet
    config = trainer_config(dpm_path)
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        run_a = RepresentationLearningTrainer(config=config, run_path=os.path.join(root, "a"),
                                              seed=seed)
        build_s = time.perf_counter() - t0
        trunk = [k for k in run_a.decoder.state_dict() if k in dpm_sd]
        grafted = all(torch.equal(run_a.decoder.state_dict()[k], dpm_sd[k]) for k in trunk)
        step3 = os.path.join(root, "step3.ckpt")
        records = {"launches": [], "gn": [], "gn_bwd": [], "s": [], "loss": []}
        inner_step, inner_eval = run_a.train_step, run_a.evaluate

        def counted_step(batch):
            if run_a.step == 5:
                # keep A's step-3 file for run B (a hard link: the save at 6
                # renames a new file over latest.ckpt); outside the timing
                run_a._join_save()
                latest = os.path.join(root, "a", "checkpoints", "latest.ckpt")
                try:
                    os.link(latest, step3)
                except OSError:
                    shutil.copyfile(latest, step3)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            s0 = time.perf_counter()
            out = inner_step(batch)
            torch.cuda.synchronize()
            records["s"].append(time.perf_counter() - s0)
            records["launches"].append(ops.launch_counts())
            records["gn"].append(ops.gn_variant_counts())
            records["gn_bwd"].append(ops.gn_bwd_variant_counts())
            records["loss"].append(float(out["prediction_loss"]))
            return out

        eval_rec = {}

        def counted_eval(step):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            s0 = time.perf_counter()
            inner_eval(step)
            torch.cuda.synchronize()
            eval_rec["run"] = {"s": time.perf_counter() - s0, "launches": ops.launch_counts(),
                               "gn_variants": ops.gn_variant_counts()}

        run_a.train_step, run_a.evaluate = counted_step, counted_eval
        t0 = time.perf_counter()
        assert run_a.train(max_steps=6) == 6
        loop_s = time.perf_counter() - t0
        trunk_kept = all(torch.equal(run_a.decoder.state_dict()[k], dpm_sd[k]) for k in trunk)
        latest_a = os.path.join(root, "a", "checkpoints", "latest.ckpt")
        steps_on_file = [int(load_checkpoint(p)["step"]) for p in (step3, latest_a)]
        grid_path = os.path.join(root, "a", "samples", "sample0k.png")
        grid_want = make_grid(np.zeros((2 * BATCH, 64, 64, 3), np.uint8), nrow=2).shape[:2]
        grid_got = png_size(grid_path) if os.path.exists(grid_path) else None
        with open(os.path.join(root, "a", "metrics.jsonl")) as f:
            metric_steps = [json.loads(line)["step"] for line in f]

        # run B: a fresh trainer resumes A's step-3 file and trains to 6
        os.makedirs(os.path.join(root, "b", "checkpoints"))
        shutil.copyfile(step3, os.path.join(root, "b", "checkpoints", "latest.ckpt"))
        config_b = {**config, "runner_config": {**config["runner_config"],
                                                "evaluate_every_steps": 10000}}
        t0 = time.perf_counter()
        run_b = RepresentationLearningTrainer(config=config_b, run_path=os.path.join(root, "b"),
                                              resume="latest", seed=seed)
        resume_s = time.perf_counter() - t0
        raw = load_checkpoint(step3)
        loaded = run_b.state_dict()
        flat_loaded, flat_raw = _flat(loaded), _flat({k: raw[k] for k in loaded})
        loaded_equal = (run_b.start_step == 3 and sorted(flat_loaded) == sorted(flat_raw)
                        and all(np.array_equal(np.asarray(v), np.asarray(flat_raw[k]))
                                for k, v in flat_loaded.items()))
        del flat_loaded, flat_raw
        del raw, loaded
        assert run_b.train(max_steps=6) == 6
        mismatched = [f"{g}.{k}" for g in ("encoder", "shift")
                      for k, p in run_a.state.params[g].items()
                      if not torch.equal(p, run_b.state.params[g][k])
                      or not torch.equal(run_a.state.ema_params[g][k],
                                         run_b.state.ema_params[g][k])
                      or not all(torch.equal(run_a.optimizer.state[p][m],
                                             run_b.optimizer.state[run_b.state.params[g][k]][m])
                                 for m in ("exp_avg", "exp_avg_sq", "step"))]
        ckpt_bytes = os.path.getsize(latest_a)
        # the bare step under the same deterministic algorithms, on B's
        # state after the comparison
        batch = next(run_b._batch_iterator(6))
        bare = []
        for i in range(4):
            g = torch.Generator(device=device).manual_seed(seed + i)
            torch.cuda.synchronize()
            s0 = time.perf_counter()
            run_b._step_fn(run_b.state, batch["x_0"], g)
            torch.cuda.synchronize()
            bare.append(time.perf_counter() - s0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        saves = run_a.save_seconds + run_b.save_seconds
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
    # A's step-6 file and the DPM stay for the samplers phase
    for name in ("step3.ckpt", "b/checkpoints/latest.ckpt"):
        os.unlink(os.path.join(root, name))
    trainer_step_s = sum(records["s"][1:]) / len(records["s"][1:])
    modules = ("yaml", "msgpack", "PIL", "tensorboard", "tensorflow")
    loaded_modules = {m: m in sys.modules for m in modules}
    import importlib.util
    available = {m: importlib.util.find_spec(m) is not None for m in modules}
    rec = {
        "config": "celeba64 PDAE, CELEBA64_DPM trunk, latent 512, SYNTHETIC 64px RGB "
                  "length 320 preload, b32, Adam lr 1e-4, EMA 0.9999, linear 1000, fp32, "
                  "TF32 off, cudnn.deterministic",
        "build_s": build_s, "resume_build_s": resume_s, "loop_s_run_a": loop_s,
        "losses": records["loss"], "step_s": records["s"],
        "trainer_step_s": trainer_step_s, "bare_step_s_deterministic": sum(bare[1:]) / 3,
        "bare_step_s_train_phase": bare_step_s,
        "trainer_vs_bare_deterministic": trainer_step_s / (sum(bare[1:]) / 3),
        "save_wait_s": [r[0] for r in saves], "save_write_s": [r[1] for r in saves],
        "checkpoint_bytes": ckpt_bytes, "eval_s": eval_rec["run"]["s"],
        "eval_launches": eval_rec["run"]["launches"], "eval_launches_expected": want_eval,
        "eval_gn_variants": eval_rec["run"]["gn_variants"],
        "launches_per_step": records["launches"][-1], "launches_expected": want_step,
        "peak_mem_gb": peak, "trunk_grafted": grafted, "trunk_unchanged": trunk_kept,
        "checkpoint_steps": steps_on_file, "grid_hw": grid_got, "grid_hw_expected": grid_want,
        "metrics_steps": metric_steps, "resume_loaded_equal": loaded_equal,
        "resume_mismatched": mismatched[:5], "modules_loaded": loaded_modules,
        "modules_available": available, "phase_s": time.perf_counter() - phase_t0}
    rec["ok"] = bool(
        all(math.isfinite(v) for v in records["loss"]) and len(records["loss"]) == 6
        and all(c == want_step for c in records["launches"])
        and all(v == {"cluster": want_step["gn_adagn_silu"], "general": 0}
                for v in records["gn"])
        and all(v == {"cluster": want_step["gn_adagn_silu_bwd"], "general": 0}
                for v in records["gn_bwd"])
        and eval_rec["run"]["launches"] == want_eval
        and eval_rec["run"]["gn_variants"] == {"cluster": want_eval["gn_adagn_silu"],
                                               "general": 0}
        and grafted and trunk_kept and steps_on_file == [3, 6]
        and grid_got == grid_want and metric_steps == [1, 2, 3, 4, 5, 6]
        and loaded_equal and not mismatched
        and not loaded_modules["yaml"] and not loaded_modules["msgpack"]
        and (not loaded_modules["PIL"] or loaded_modules["tensorflow"]))
    return rec


def _flat(tree, prefix=""):
    """``{"a/b/c": leaf}`` of a nested dict; an empty dict stays a leaf."""
    if isinstance(tree, dict) and tree:
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    return {prefix: tree}


def per_call(model, *inputs) -> dict:
    """The kernel launches one call of ``model`` makes: its GN chains and
    attention blocks, counted with hooks on a plain-path call."""
    from pdae_torch import ops
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain

    counts = collections.Counter()
    handles = [m.register_forward_pre_hook(
        lambda mod, args, kind="gn_adagn_silu" if isinstance(m, GNSiluChain) else "attention":
        counts.update([kind]))
        for m in model.modules() if isinstance(m, (GNSiluChain, AttentionBlock))]
    ops.set_use_kernels(False)
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        ops.set_use_kernels(None)
        for h in handles:
            h.remove()
    return {"attention": counts["attention"], "gn_adagn_silu": counts["gn_adagn_silu"],
            "gn_adagn_silu_bwd": 0}


def grid_hw(n, nrow=None) -> tuple:
    """(height, width) of ``make_grid`` over n 64px images."""
    from pdae_torch.utils import make_grid
    return make_grid(np.zeros((n, 64, 64, 3), np.uint8), nrow=nrow).shape[:2]


def rows_hw(*lengths) -> tuple:
    """(height, width) of ``paste_rows`` over rows of these lengths."""
    sizes = [grid_hw(n, nrow=n) for n in lengths]
    return sum(h for h, _ in sizes), max(w for _, w in sizes)


HEAVY_FILES = ("trainer/dpm.ckpt", "trainer/step3.ckpt", "trainer/a/checkpoints/latest.ckpt",
               "trainer/b/checkpoints/latest.ckpt", "samplers/latent.ckpt",
               "precision/dpm_ffhq.ckpt", "metrics/inception.ckpt", "metrics/lpips.ckpt")


def drop_heavy_files() -> None:
    """Delete the checkpoints of the trainer, samplers and stages phases
    (1.67 GB a PDAE checkpoint, 0.17-1 GB the others): what the script
    leaves under ``chiprun_out/`` stays small."""
    paths = [os.path.join(OUT_DIR, name) for name in HEAVY_FILES]
    for parent, _, names in os.walk(os.path.join(OUT_DIR, "stages")):
        paths += [os.path.join(parent, n) for n in names if n.endswith(".ckpt")]
    for path in paths:
        if os.path.exists(path):
            os.unlink(path)
    drop_ingest_files()


def counted_run(name, fn, want_calls, structure, seen):
    """``fn()`` counted: the top-level model calls (a forward pre-hook on
    every module counts the modules named in ``structure``) and the kernel
    launches, each held to ``structure`` (launches per call of each model);
    the kernels' input shapes go into ``seen``, keyed as ``path_shapes``
    keys them, with the runs that gave them."""
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain

    calls = collections.Counter()

    def hook(mod, args):
        if type(mod).__name__ in structure:
            calls[type(mod).__name__] += 1
        elif isinstance(mod, GNSiluChain):
            seen[("gn", *args[0].shape, len(args) > 1 and args[1] is not None,
                  len(args) > 3 and args[3] is not None)].add(name)
        elif isinstance(mod, AttentionBlock):
            b, c, h, w = args[0].shape
            seen[("attention", b, mod.num_heads, h * w, c // mod.num_heads)].add(name)

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        out, rec = counted(fn)
    finally:
        handle.remove()
    want = {k: sum(n * structure[m][k] for m, n in want_calls.items())
            for k in ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd")}
    rec.update(calls=dict(calls), calls_expected=want_calls, launches_expected=want)
    rec["ok"] = (dict(calls) == {m: n for m, n in want_calls.items() if n}
                 and rec["launches"] == want
                 and rec["gn_variants"] == {"cluster": want["gn_adagn_silu"], "general": 0})
    return out, rec


def compare_new_shapes(seen, compared, seed, device, table) -> dict:
    """Every kernel input shape in ``seen`` that is not in ``compared`` held
    to the plain versions in fp32 and bf16 (compared, not timed), each GN
    shape on the cluster variant; the full table goes to ``table`` under
    ``chiprun_out/``, and ``compared`` takes the new shapes."""
    shape_gen = torch.Generator().manual_seed(seed)
    new = sorted(k for k in seen if k not in compared)
    shape_res = [dict(check_attention(k[1:], shape_gen, device, timed=False)
                      if k[0] == "attention" else
                      check_gn(k, shape_gen, device, timed=False),
                      runs=sorted(seen[k])) for k in new]
    with open(os.path.join(OUT_DIR, table), "w") as f:
        json.dump(shape_res, f, indent=1)
    disagree = [(r["shape"], k) for r in shape_res for k, v in r["err"].items()
                if not v["ok"]]
    off_cluster = [(r["shape"], k) for r in shape_res
                   for k, plan in r.get("variant", {}).items()
                   if plan["variant"] != "cluster"]
    compared.update(seen)
    return {"batches": sorted({k[1] for k in seen}),
            "shapes": len(seen), "compared_before": len(seen) - len(new),
            "compared_here": len(new),
            "max_abs_err_fp32": max((v["max_abs_err"] for r in shape_res
                                     for k, v in r["err"].items() if "float32" in k),
                                    default=0.0),
            "disagree": disagree, "off_cluster_variant": off_cluster,
            "ok": bool(seen) and not disagree and not off_cluster}


def sampler_base() -> dict:
    """The sampler config over the samplers phase's files: the trainer
    phase's run config and step-6 checkpoint, the seeded latent DPM and
    classifier and the InferLatents stats; SYNTHETIC 64px RGB, 64 images."""
    trainer = os.path.join(OUT_DIR, "trainer")
    root = os.path.join(OUT_DIR, "samplers")
    return {"config_path": os.path.join(trainer, "a", "config.yml"),
            "checkpoint_path": os.path.join(trainer, "a", "checkpoints", "latest.ckpt"),
            "dataset_config": {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                               "length": 64},
            "latent_config_path": os.path.join(root, "latent.yml"),
            "latent_checkpoint_path": os.path.join(root, "latent.ckpt"),
            "inferred_latents_path": os.path.join(root, "synthetic.ckpt"),
            "classifier_checkpoint_path": os.path.join(root, "classifier.ckpt"),
            "num_classes": NUM_CLASSES}


def samplers_phase(seed, device, dec_counts, enc_counts, rho, compared) -> dict:
    """The sampler suite and the file-built service on the trainer phase's
    files (its run config, step-6 checkpoint and DPM), with a seeded celeba64
    MLPSkipNet and ``Linear(512, 40)`` written beside them: InferLatents
    (whose stats the later steps read), AutoencodingEval through the kernels
    and through the plain versions, ``PDAEService.from_config`` against the
    in-memory service on the same trees, then every other sampler once and
    one through ``python -m pdae_torch.sample``. Every model call and kernel
    launch of each run is counted and held to the structure's, and every
    kernel input shape the runs give that is not in ``compared`` (the shapes
    the kernels phase held to the plain versions) is compared here."""
    import shutil

    from pdae_torch import ops
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.models import (CELEBA64_DPM, UNet, build_classifier,
                                   build_latent_denoise_fn)
    from pdae_torch.sampling import SAMPLERS, SamplerContext
    from pdae_torch.serving import PDAEService
    from pdae_torch.utils import (classifier_state_dict, classifier_tree, encoder_state_dict,
                                  load_checkpoint, mlp_skip_net_state_dict, mlp_skip_net_tree,
                                  save_checkpoint, save_yaml, to_uint8, unet_state_dict)

    phase_t0 = time.perf_counter()
    trainer = os.path.join(OUT_DIR, "trainer")
    root = os.path.join(OUT_DIR, "samplers")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def path(name):
        return os.path.join(root, name)

    # the later stages' artifacts, made from the seed
    gen = torch.Generator().manual_seed(seed + 6)
    torch.manual_seed(seed + 6)
    latent = build_latent_denoise_fn(LATENT_CONFIG)
    classifier = build_classifier(NUM_CLASSES, LATENT)
    perturb_zero_params(latent, gen)
    perturb_zero_params(classifier, gen)
    save_yaml({"latent_denoise_fn_config": LATENT_CONFIG}, path("latent.yml"))
    save_checkpoint(path("latent.ckpt"),
                    {"ema_latent_denoise_fn": mlp_skip_net_tree(latent.state_dict())})
    save_checkpoint(path("classifier.ckpt"),
                    {"ema_classifier": classifier_tree(classifier.state_dict())})
    diffusion = {"timesteps": 1000, "betas_type": "linear"}
    save_yaml({"denoise_fn_config": {"model": "UNet", **CELEBA64_DPM},
               "diffusion_config": diffusion}, path("dpm.yml"))
    del latent, classifier
    base = sampler_base()
    short = {"timesteps": 100, "betas_type": "linear"}     # the depth cut
    gd, gd_short = GaussianDiffusion(diffusion), GaussianDiffusion(short)

    def steps(style, g=gd, direction="decode"):
        if style.startswith("dpm"):
            return g.solver_tables(style, direction=direction).num_steps
        return g.ddim_schedule(style).num_steps

    unet_call = per_call(UNet(**CELEBA64_DPM).to(device).eval(),
                         torch.zeros(1, 3, 64, 64, device=device),
                         torch.zeros(1, dtype=torch.int32, device=device))
    structure = {"ShiftUNet": launches_of(1, 0, dec_counts, enc_counts),
                 "SemanticEncoder": launches_of(0, 1, dec_counts, enc_counts),
                 "UNet": unet_call}
    # every kernel input shape the counted runs give, keyed as path_shapes
    # keys them, with the runs that gave it
    seen = collections.defaultdict(set)

    def run(name, fn, want_calls):
        return counted_run(name, fn, want_calls, structure, seen)

    records = {"config": "the trainer phase's celeba64 run (config.yml, step-6 latest.ckpt, "
                         "its seeded DPM), a seeded celeba64 MLPSkipNet and Linear(512, 40); "
                         "SYNTHETIC 64px RGB, 64 images; fp32, TF32 off",
               "depth_cut": "gap_measure and autoencoding_example (its DDPM row runs every "
                            "step) under a 100-step linear schedule; every other sampler on "
                            "the run's 1000 steps; styles ddim20/dpm20; interpolation at 3 "
                            "alphas"}

    # 1. InferLatents: the stats the later steps read ----------------------------
    cfg = dict(base, batch_size=32, output_path=path("synthetic.ckpt"))
    out, rec = run("infer_latents", lambda: SAMPLERS["infer_latents"](cfg).start(),
                   {"SemanticEncoder": 2})
    stats = load_checkpoint(out)
    ctx = SamplerContext(cfg)
    ctx.build_pdae()
    with torch.inference_mode():
        ds = ctx.dataset()
        x = torch.from_numpy(np.stack([ds[i]["x_0"] for i in range(64)])).to(device)
        z = ctx.encoder(x.permute(0, 3, 1, 2).contiguous()).cpu().numpy().astype(np.float64)
    direct = {"mean": z.mean(0), "std": z.std(0, ddof=1)}
    rel = {k: float(np.abs(stats[k] - direct[k]).max() / np.abs(direct[k]).max())
           for k in ("mean", "std")}
    rec.update(shape=[list(np.shape(stats[k])) for k in ("mean", "std")],
               finite=bool(all(np.isfinite(stats[k]).all() for k in ("mean", "std"))),
               rel_err_vs_direct_b64_pass=rel)
    rec["ok"] = (rec["ok"] and rec["finite"] and rec["shape"] == [[LATENT], [LATENT]]
                 and max(rel.values()) <= 1e-5)
    records["infer_latents"] = rec
    del ctx, x

    # 2. AutoencodingEval, through the kernels and through the plain versions -----
    eval_cfg = dict(base, batch_size=16, max_samples=32, encoder_ddim_style="dpm20",
                    decoder_ddim_style="dpm20")
    per_batch = steps("dpm20", direction="encode") + steps("dpm20")
    inner = GaussianDiffusion.representation_learning_autoencoding

    def evaluator(decoder_wrap=None):
        """An AutoencodingEval with its models built (outside any timing):
        calling it runs the eval and returns its metrics and reconstructions
        (NHWC, [-1, 1])."""
        sampler = SAMPLERS["autoencoding_eval"](eval_cfg)
        sampler.ctx.build_pdae()
        if decoder_wrap is not None:
            sampler.ctx.decoder = decoder_wrap(sampler.ctx.decoder)

        def evaluate():
            captured = []

            def capture(self, *args, **kwargs):
                out = inner(self, *args, **kwargs)
                captured.append(out.permute(0, 2, 3, 1).cpu().numpy())
                return out

            GaussianDiffusion.representation_learning_autoencoding = capture
            try:
                metrics = sampler.start()
            finally:
                GaussianDiffusion.representation_learning_autoencoding = inner
            return metrics, np.concatenate(captured)
        return evaluate

    (res_k, recon_k), rec = run("autoencoding_eval", evaluator(),
                                {"ShiftUNet": 2 * per_batch, "SemanticEncoder": 2})
    ops.set_use_kernels(False)
    try:
        evaluate = evaluator()
        t0 = time.perf_counter()
        res_p, recon_p = evaluate()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    finally:
        ops.set_use_kernels(None)

    def levels(a, b):
        return int(np.abs(to_uint8(a).astype(int) - to_uint8(b).astype(int)).max())

    diff = levels(recon_k, recon_p)
    control = []
    if diff > 1:
        # the plain path against itself, every decoder output moved by the
        # relative size of one kernel forward's error (the whole_path phase's
        # control), three seeded draws
        def perturbed(draw):
            g = torch.Generator(device=device).manual_seed(seed + draw)

            def wrap(decoder):
                def dec(x, t, z):
                    return tuple(o * (1.0 + rho * torch.randn(o.shape, generator=g,
                                                              device=device))
                                 for o in decoder(x, t, z))
                return dec
            return wrap

        ops.set_use_kernels(False)
        try:
            control = [levels(evaluator(perturbed(draw))()[1], recon_p) for draw in range(3)]
        finally:
            ops.set_use_kernels(None)
    s_per_eval = rec["s"] / (2 * per_batch)
    rec.update(batch=16, images=32, styles="dpm20/dpm20", ssim=res_k["ssim"],
               mse=res_k["mse"], plain_ssim=res_p["ssim"], plain_mse=res_p["mse"],
               ssim_diff=res_k["ssim"] - res_p["ssim"], mse_diff=res_k["mse"] - res_p["mse"],
               imgs_per_s=32 / rec["s"], plain_s=plain_s, evals_per_batch=per_batch,
               s_per_eval_b16=s_per_eval, max_uint8_diff_vs_plain=diff,
               control_max_uint8_diff=control or "not run: within one level",
               bound_uint8=max([1] + control),
               predicted_ddim1000_ddim100_s_per_b16_batch=1100 * s_per_eval,
               metrics_finite=all(math.isfinite(v) for r in (res_k, res_p)
                                  for v in r.values()))
    rec["ok"] = (rec["ok"] and diff <= rec["bound_uint8"] and rec["metrics_finite"]
                 and recon_k.shape == (32, 64, 64, 3))
    records["autoencoding_eval"] = rec
    del recon_k, recon_p

    # 3. the service from the files against the one built in memory ---------------
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        svc_cfg = dict(base, max_batch=64)
        t0 = time.perf_counter()
        from_files = PDAEService.from_config(svc_cfg)
        build_s = time.perf_counter() - t0
        raw = load_checkpoint(base["checkpoint_path"])
        geo = SamplerContext(svc_cfg).pdae_geometry()
        in_memory = PDAEService(
            {**svc_cfg, **{k: geo[k] for k in ("trained_ddpm_config", "encoder_config",
                                              "decoder_config", "image_size")},
             "diffusion_config": diffusion, "latent_config": LATENT_CONFIG},
            encoder_state_dict(raw["ema_encoder"]), unet_state_dict(raw["ema_decoder"]),
            latent_state=mlp_skip_net_state_dict(
                load_checkpoint(path("latent.ckpt"))["ema_latent_denoise_fn"]),
            latent_stats=(stats["mean"], stats["std"]),
            classifier_state=classifier_state_dict(
                load_checkpoint(path("classifier.ckpt"))["ema_classifier"]))
        del raw
        images = np.random.RandomState(seed + 7).randint(0, 256, (BATCH, 64, 64, 3),
                                                         np.uint8)
        service_ops = {
            "autoencode_dpm20": (lambda s: s.autoencode(images, "dpm20", "dpm20"),
                                 {"ShiftUNet": steps("dpm20", direction="encode")
                                  + steps("dpm20"), "SemanticEncoder": 1}),
            "generate_dpm20": (lambda s: s.generate(BATCH, 0, "dpm20", "dpm20"),
                               {"ShiftUNet": steps("dpm20")}),
            "manipulate_dpm20": (lambda s: s.manipulate(images, attribute="Smiling",
                                                        encode_style="dpm20",
                                                        decode_style="dpm20"),
                                 {"ShiftUNet": steps("dpm20", direction="encode")
                                  + steps("dpm20"), "SemanticEncoder": 2}),
        }
        svc = {"build_s": build_s}
        for name, (op, want_calls) in service_ops.items():
            got, rec = run(name, lambda: op(from_files), want_calls)
            want = op(in_memory)
            rec.update(bit_equal_to_in_memory=bool(np.array_equal(got, want)),
                       shape=list(got.shape), dtype=str(got.dtype))
            rec["ok"] = (rec["ok"] and rec["bit_equal_to_in_memory"]
                         and got.shape == (BATCH, 64, 64, 3) and got.dtype == np.uint8)
            svc[name] = rec
        svc["ok"] = all(v["ok"] for k, v in svc.items() if isinstance(v, dict))
        records["from_config"] = svc
        del from_files, in_memory
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags

    # 4. every other sampler once ------------------------------------------------
    alphas = [0.0, 0.5, 1.0]
    scales = [-0.3, -0.1, 0.1, 0.3]
    ddim20 = steps("ddim20")
    others = {
        "test_dpms": ({"config_path": path("dpm.yml"),
                       "checkpoint_path": os.path.join(trainer, "dpm.ckpt"),
                       "image_size": 64, "image_channel": 3, "num_samples": 9,
                       "ddim_style": "ddim20"},
                      {"UNet": ddim20}, grid_hw(9, 3)),
        "autoencoding_example": (dict(base, image_index=0, encoder_ddim_style="ddim20",
                                      decoder_ddim_style="ddim20", diffusion_config=short),
                                 {"ShiftUNet": 3 * steps("ddim20", gd_short)
                                  + short["timesteps"], "SemanticEncoder": 3},
                                 grid_hw(12, 12)),
        "denoise_one_step": (dict(base, image_index=0),
                             {"ShiftUNet": 1, "SemanticEncoder": 1}, rows_hw(6, 6)),
        "interpolation": (dict(base, image_index_1=0, image_index_2=1, ddim_style="ddim20",
                               alphas=alphas),
                          {"ShiftUNet": ddim20 + 3 * ddim20 * len(alphas),
                           "SemanticEncoder": 1},
                          rows_hw(len(alphas) + 2, len(alphas) + 2)),
        "manipulation": (dict(base, image_index=0, encode_ddim_style="ddim20",
                              decode_ddim_style="ddim20", scale_list=scales),
                         {"ShiftUNet": ddim20 * (1 + len(scales)),
                          "SemanticEncoder": 1 + len(scales)},
                         grid_hw(len(scales) + 1, len(scales) + 1)),
        "unconditional_sample": (dict(base, num_samples=8, latent_ddim_style="ddim20",
                                      decoder_ddim_style="ddim20"),
                                 {"ShiftUNet": ddim20}, grid_hw(8)),
        "gap_measure": (dict(base, batch_size=2, num_samples=2, diffusion_config=short),
                        {"ShiftUNet": short["timesteps"], "SemanticEncoder": 1}, None),
    }
    for name, (cfg, want_calls, hw) in others.items():
        cfg = dict(cfg, output_path=path(f"{name}.png"))
        out, rec = run(name, lambda: SAMPLERS[name](cfg).start(), want_calls)
        if name == "gap_measure":
            gap, ae_gap = out
            written = [p for p in (cfg["output_path"], cfg["output_path"] + ".npz")
                       if os.path.exists(p)]
            rec.update(curve_len=[len(gap), len(ae_gap)], written=written,
                       gap_first_last=[float(gap[0]), float(gap[-1])],
                       ae_gap_first_last=[float(ae_gap[0]), float(ae_gap[-1])])
            rec["ok"] = (rec["ok"] and rec["curve_len"] == [short["timesteps"]] * 2
                         and bool(np.isfinite(gap).all() and np.isfinite(ae_gap).all())
                         and len(written) == 1)
        else:
            rec.update(png_hw=png_size(out) if os.path.exists(out) else None,
                       png_hw_expected=list(hw))
            rec["ok"] = rec["ok"] and rec["png_hw"] is not None and \
                list(rec["png_hw"]) == list(hw)
        records[name] = rec

    # one sampler end to end through the CLI, in a process of its own
    cli_cfg = path("denoise_one_step_cli.yml")
    save_yaml(dict(base, image_index=1), cli_cfg)
    cli_out = path("denoise_one_step_cli.png")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pdae_torch.sample", "--sampler",
                           "denoise_one_step", "--config", cli_cfg, "--set",
                           f"output_path={cli_out}"], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    records["cli_denoise_one_step"] = {
        "s": time.perf_counter() - t0, "returncode": proc.returncode,
        "stdout_tail": proc.stdout.strip().splitlines()[-1:],
        "stderr_tail": proc.stderr.strip().splitlines()[-3:],
        "png_hw": png_size(cli_out) if os.path.exists(cli_out) else None,
        "ok": proc.returncode == 0 and os.path.exists(cli_out)
        and list(png_size(cli_out)) == list(rows_hw(6, 6))}

    # 5. every kernel shape of those runs against the plain versions -----------
    # (compared, not timed; the shapes the kernels phase compared are not
    # compared again, and the stages phase compares only what is new)
    records["kernel_shapes"] = compare_new_shapes(seen, compared, seed + 8, device,
                                                  "chip_smoke_sampler_shapes.json")
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict))
    return records


# -- LPIPS, InceptionV3, FID and two ranks on one card (metrics phase) -------- #

METRIC_TOL = 1e-4                # card against CPU, relative to the largest magnitude
METRIC_SIZES = (64, 320)         # InceptionV3 resizes up from one, down from the other
FID_SET = 2560                   # SYNTHETIC images a feature set: more rows than features
LPIPS_BATCH = 16
LPIPS_TIMED_BATCHES = 20
FID_SAMPLES = 256                # UnconditionalSample's generated set (the phase ~120 s)
FID_BATCH = 64
FID_STYLES = ("ddim10", "ddim10")
WORLD2_MEAN_RTOL = 1e-12         # the float64 means' order
WORLD2_LATENT_RTOL = 1e-6        # the float32 mean's order over another concatenation


def seeded_metric_weights(seed, root) -> dict:
    """Seeded AlexNet LPIPS and InceptionV3 weights at full width (He-scaled
    kernels, BN statistics near 1 and 0, non-negative ``lin`` weights),
    written as ``scripts/convert_torch_checkpoint.py`` writes the pretrained
    ones: ``pdae_tpu``'s flat layouts, conv kernels HWIO."""
    from pdae_torch.metrics.inception import InceptionV3
    from pdae_torch.metrics.lpips import ALEX, CHANNELS
    from pdae_torch.utils import save_checkpoint

    rs = np.random.RandomState(seed)
    inception = {}
    for k, v in InceptionV3().state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(".conv.weight"):
            o, i, kh, kw = v.shape
            w = rs.randn(kh, kw, i, o) * np.sqrt(2.0 / (kh * kw * i))
        elif k.endswith(("running_var", "bn.weight")):
            w = rs.uniform(0.5, 1.5, tuple(v.shape))
        else:
            w = 0.1 * rs.randn(*v.shape)
        inception[k] = w.astype(np.float32)
    lpips, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(ALEX):
        lpips[f"conv{i}_w"] = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (k * k * cin))
                               ).astype(np.float32)
        lpips[f"conv{i}_b"] = (0.1 * rs.randn(cout)).astype(np.float32)
        cin = cout
    for i, c in enumerate(CHANNELS):
        lpips[f"lin{i}_w"] = (np.abs(rs.randn(c)) / c).astype(np.float32)
    paths = {"inception": os.path.join(root, "inception.ckpt"),
             "lpips": os.path.join(root, "lpips.ckpt")}
    save_checkpoint(paths["inception"], inception)
    save_checkpoint(paths["lpips"], lpips)
    return paths


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn`` between CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def conv_flops(model, *inputs) -> int:
    """The multiply-adds (x2) of every ``nn.Conv2d`` in one ``model(*inputs)``,
    counted from the output shapes: the operations a bound is taken over."""
    total = [0]

    def hook(mod, args, out):
        k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        total[0] += 2 * out.numel() * k

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Conv2d)]
    try:
        with torch.inference_mode():
            model(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def rel_to_largest(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_worker(spec_path, out_path) -> int:
    """One rank of the metrics phase's two-process run (``python3
    chip_smoke.py --rank-worker SPEC OUT``, torchrun's environment set by the
    phase): joins the gloo group, runs each sampler of the spec on the card,
    models built before the timing, and writes each result and its seconds."""
    import torch.distributed as dist

    from pdae_torch.parallel import init_distributed, process_index, sync_global_devices
    from pdae_torch.sampling import SAMPLERS

    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed()
    out = {"rank": process_index()}
    try:
        for name, config in spec.items():
            sampler = SAMPLERS[name](config)
            sampler.ctx.build_pdae()
            sync_global_devices(name)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = sampler.start()
            torch.cuda.synchronize()
            out[name] = {"result": result, "s": time.perf_counter() - t0}
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def world2(spec, root) -> dict:
    """The spec's samplers as two ranks on the one card (both ``LOCAL_RANK``
    0, as two hosts of one card each would be), gloo carrying the objects;
    each rank's output, and the run's wall seconds. A rank that fails fails
    the phase."""
    spec_path = os.path.join(root, "world2_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = str(free_port())
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                       MASTER_ADDR="localhost", MASTER_PORT=port)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank-worker",
                 spec_path, os.path.join(root, f"rank{rank}.json")],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {rank} of the two-process run exited "
                                 f"{p.returncode}:\n{log[-3000:]}")
    ranks = []
    for rank in range(2):
        with open(os.path.join(root, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    return {"ranks": ranks, "wall_s": wall}


def metrics_phase(seed, device, dec_counts, enc_counts, samplers, compared) -> dict:
    """LPIPS, InceptionV3 and FID over seeded full-width weights, and the
    process layer, on the samplers phase's files (fp32, TF32 off): the
    backbones on the card against the CPU, their throughput, the FID's
    host seconds; ``AutoencodingEval`` with LPIPS and ``UnconditionalSample``
    with FID, counted as the samplers phase counts its runs, every new kernel
    shape held to the plain versions; then ``AutoencodingEval`` (with LPIPS)
    and ``InferLatents`` as two ranks on the one card against the one-process
    runs, within a control that runs one process over the ranks' batches."""
    import shutil

    import pdae_torch.sampling.samplers as sampler_module
    from pdae_torch.data import build_dataset
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.metrics import LPIPSMetric, activation_statistics, frechet_distance
    from pdae_torch.metrics.fid import chunked_features
    from pdae_torch.metrics.inception import load_inception, load_inception_feature_fn
    from pdae_torch.metrics.lpips import load_lpips
    from pdae_torch.parallel import process_shard_indices
    from pdae_torch.sampling import SAMPLERS
    from pdae_torch.utils import load_checkpoint

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "metrics")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    paths = seeded_metric_weights(seed + 9, root)
    records = {"weights": "seeded AlexNet LPIPS 64-192-384-256-256 and InceptionV3 at the "
                          "torchvision channel table, pdae_tpu's flat layouts (HWIO); fp32, "
                          "TF32 off"}
    rs = np.random.RandomState(seed + 10)

    # 1. the backbones on the card against the CPU -----------------------------
    lp = {d: load_lpips(paths["lpips"], device=d) for d in (device, "cpu")}
    inc = {d: load_inception(paths["inception"], device=d) for d in (device, "cpu")}
    card_cpu = {}
    with torch.inference_mode():
        for size in METRIC_SIZES:
            u8 = rs.randint(0, 256, (2, size, size, 3), np.uint8)
            other = rs.randint(0, 256, (2, size, size, 3), np.uint8)
            pair = [torch.from_numpy(a).permute(0, 3, 1, 2).float() / 127.5 - 1.0
                    for a in (u8, other)]
            got = {d: (lp[d](*(t.to(d) for t in pair)).cpu().numpy(),
                       inc[d](torch.from_numpy(u8).to(d)).cpu().numpy())
                   for d in (device, "cpu")}
            card_cpu[f"{size}px"] = {
                "lpips_card": got[device][0].tolist(), "lpips_cpu": got["cpu"][0].tolist(),
                "lpips_rel_err": rel_to_largest(got[device][0], got["cpu"][0]),
                "inception_rel_err": rel_to_largest(got[device][1], got["cpu"][1]),
                "inception_max_abs_feature": float(np.abs(got["cpu"][1]).max()),
                "inception_features_differ_by_image": bool(
                    np.abs(got["cpu"][1][0] - got["cpu"][1][1]).max() > 0)}
    del lp["cpu"], inc["cpu"]
    card_cpu["bound"] = METRIC_TOL
    card_cpu["ok"] = all(v["lpips_rel_err"] <= METRIC_TOL and v["inception_rel_err"] <= METRIC_TOL
                         and v["inception_features_differ_by_image"]
                         for k, v in card_cpu.items() if k.endswith("px"))
    records["card_vs_cpu"] = card_cpu

    # 2. throughput ---------------------------------------------------------------
    ds = build_dataset({"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                        "length": 2 * FID_SET})
    sets = [np.stack([ds[i]["gt"] for i in range(k * FID_SET, (k + 1) * FID_SET)])
            for k in (0, 1)]
    feature_fn = load_inception_feature_fn(paths["inception"], device)
    chunk = torch.from_numpy(sets[0][:64]).to(device)
    with torch.inference_mode():
        inc_chunk_ms = event_ms(lambda: inc[device](chunk))
    inc_flops = conv_flops(inc[device], chunk)
    feats, walls = [], []
    for images in sets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats.append(chunked_features(feature_fn, images))
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    stats = [activation_statistics(f) for f in feats]
    stats_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fid_ab = frechet_distance(*stats[0], *stats[1])
    fid_s = time.perf_counter() - t0
    gts = [torch.from_numpy(sets[k][:LPIPS_BATCH]).to(device).permute(0, 3, 1, 2).float()
           / 255.0 for k in (0, 1)]
    with torch.inference_mode():
        lp_ms = event_ms(lambda: lp[device](gts[0] * 2 - 1, gts[1] * 2 - 1))
    lp_flops = conv_flops(lp[device], gts[0] * 2 - 1, gts[1] * 2 - 1)
    lpips_m = LPIPSMetric(paths["lpips"], device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LPIPS_TIMED_BATCHES):
        lpips_m.process(gts[0], gts[1])
    lp_wall = time.perf_counter() - t0
    records["throughput"] = {
        "inception_chunk": 64, "inception_device_ms_per_chunk": inc_chunk_ms,
        "inception_imgs_per_s_device": 64e3 / inc_chunk_ms,
        "inception_conv_gflop_per_chunk": inc_flops / 1e9,
        "inception_conv_tflops_device": inc_flops / inc_chunk_ms / 1e9,
        "inception_bound_ms_per_chunk": inc_flops / FP32_FLOPS * 1e3,
        "inception_bound_by": "operations (fp32 convs over 67 TFLOP/s)",
        "inception_wall_s": walls, "inception_imgs_per_s_wall": [FID_SET / w for w in walls],
        "feature_rows": FID_SET, "feature_dim": int(feats[0].shape[1]),
        "activation_statistics_s": stats_s, "frechet_distance_s": fid_s,
        "fid_set_a_vs_set_b": fid_ab,
        "lpips_batch": LPIPS_BATCH, "lpips_device_ms_per_batch": lp_ms,
        "lpips_pairs_per_s_device": LPIPS_BATCH * 1e3 / lp_ms,
        "lpips_conv_gflop_per_batch": lp_flops / 1e9,
        "lpips_bound_ms_per_batch": lp_flops / FP32_FLOPS * 1e3,
        "lpips_wall_s": lp_wall,
        "lpips_pairs_per_s_wall": LPIPS_BATCH * LPIPS_TIMED_BATCHES / lp_wall,
        "ok": (all(f.shape == (FID_SET, 2048) and np.isfinite(f).all() for f in feats)
               and math.isfinite(fid_ab) and fid_ab >= 0.0
               and len(lpips_m) == LPIPS_BATCH * LPIPS_TIMED_BATCHES
               and all(math.isfinite(v) and v >= 0.0 for v in lpips_m.results))}
    del feats, sets, lp, inc, lpips_m, feature_fn, chunk

    # 3. the samplers with their metrics ---------------------------------------------
    base = sampler_base()
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    structure = {"ShiftUNet": launches_of(1, 0, dec_counts, enc_counts),
                 "SemanticEncoder": launches_of(0, 1, dec_counts, enc_counts)}
    seen = collections.defaultdict(set)

    def built(name, cfg):
        sampler = SAMPLERS[name](cfg)
        sampler.ctx.build_pdae()                 # outside the timing
        return sampler

    eval_cfg = dict(base, batch_size=16, max_samples=32, encoder_ddim_style="dpm20",
                    decoder_ddim_style="dpm20", lpips_weights=paths["lpips"])
    before = samplers["autoencoding_eval"]
    eval_sampler = built("autoencoding_eval", eval_cfg)
    w1_eval, rec = counted_run("autoencoding_eval_lpips", eval_sampler.start,
                               before["calls_expected"], structure, seen)
    rec.update(w1_eval, imgs_per_s=32 / rec["s"], samplers_phase_imgs_per_s=before["imgs_per_s"],
               samplers_phase_s=before["s"], ssim_diff_vs_samplers_phase=w1_eval["ssim"]
               - before["ssim"], mse_diff_vs_samplers_phase=w1_eval["mse"] - before["mse"])
    rec["ok"] = (rec["ok"] and sorted(w1_eval) == ["lpips", "mse", "ssim"]
                 and math.isfinite(w1_eval["lpips"]) and w1_eval["lpips"] >= 0.0)
    records["autoencoding_eval_lpips"] = rec

    lat_style, dec_style = FID_STYLES
    fid_cfg = dict(base, num_samples=FID_SAMPLES, batch_size=FID_BATCH,
                   latent_ddim_style=lat_style, decoder_ddim_style=dec_style,
                   dataset_config=dict(base["dataset_config"], length=FID_SET),
                   fid={"inception_path": paths["inception"], "num_reference": FID_SET},
                   output_path=os.path.join(root, "unconditional_fid.png"))
    calls = -(-FID_SAMPLES // FID_BATCH) * gd.ddim_schedule(dec_style).num_steps
    sampler = built("unconditional_sample", fid_cfg)
    sampler.ctx.build_latent()
    (png, fid), rec = counted_run("unconditional_sample_fid", sampler.start,
                                  {"ShiftUNet": calls}, structure, seen)
    rec.update(samples=FID_SAMPLES, batch=FID_BATCH, styles="/".join(FID_STYLES),
               reference_images=FID_SET, fid=fid, imgs_per_s=FID_SAMPLES / rec["s"],
               png_hw=png_size(png) if os.path.exists(png) else None,
               png_hw_expected=list(grid_hw(FID_SAMPLES)))
    rec["ok"] = (rec["ok"] and fid is not None and math.isfinite(fid) and fid >= 0.0
                 and rec["png_hw"] is not None
                 and list(rec["png_hw"]) == rec["png_hw_expected"])
    records["unconditional_sample_fid"] = rec
    records["kernel_shapes"] = compare_new_shapes(seen, compared, seed + 11, device,
                                                  "chip_smoke_metrics_shapes.json")

    # 4. two ranks on the one card against one process ----------------------------------
    w2_cfg = {"autoencoding_eval": eval_cfg,
              "infer_latents": dict(base, batch_size=32,
                                    output_path=os.path.join(root, "latents_w2.ckpt"))}
    w2 = world2(w2_cfg, root)
    # the control: one process over the ranks' batches, in the ranks' order
    order = {n: np.concatenate([process_shard_indices(n, r, 2, pad_to_even=pad)
                                for r in range(2)])
             for n, pad in ((32, True), (64, False))}
    real_shards = sampler_module.process_shard_indices
    sampler_module.process_shard_indices = lambda n, pad_to_even=True: order[n]
    try:
        ctrl_eval = eval_sampler.start()
        ctrl_path = os.path.join(root, "latents_ctrl.ckpt")
        built("infer_latents", dict(w2_cfg["infer_latents"], output_path=ctrl_path)).start()
    finally:
        sampler_module.process_shard_indices = real_shards
    got = [r["autoencoding_eval"]["result"] for r in w2["ranks"]]
    eval_rec = {k: {"world1": w1_eval[k], "world2": got[0][k], "control": ctrl_eval[k],
                    "world2_minus_world1": got[0][k] - w1_eval[k],
                    "control_minus_world1": ctrl_eval[k] - w1_eval[k],
                    "world2_minus_control": got[0][k] - ctrl_eval[k],
                    "bound": abs(ctrl_eval[k] - w1_eval[k])
                    + WORLD2_MEAN_RTOL * abs(w1_eval[k])}
                for k in w1_eval}
    lat = {who: load_checkpoint(p) for who, p in (
        ("world1", base["inferred_latents_path"]), ("world2", w2_cfg["infer_latents"][
            "output_path"]), ("control", ctrl_path))}
    lat_rec = {}
    for k in ("mean", "std"):
        scale = float(np.abs(lat["world1"][k]).max())
        gap = float(np.abs(lat["control"][k] - lat["world1"][k]).max())
        lat_rec[k] = {"world2_minus_world1": float(np.abs(lat["world2"][k]
                                                           - lat["world1"][k]).max()),
                      "control_minus_world1": gap,
                      "world2_minus_control": float(np.abs(lat["world2"][k]
                                                           - lat["control"][k]).max()),
                      "bound": gap + WORLD2_LATENT_RTOL * scale}
    records["world2"] = {
        "ranks": 2, "card": "one, both ranks on cuda:0", "objects_over": "gloo",
        "wall_s": w2["wall_s"],
        "rank_s": {name: [r[name]["s"] for r in w2["ranks"]] for name in w2_cfg},
        "world1_autoencoding_eval_s": records["autoencoding_eval_lpips"]["s"],
        "world1_infer_latents_s": samplers["infer_latents"]["s"],
        "autoencoding_eval": eval_rec, "infer_latents": lat_rec,
        "ok": (got[0] == got[1]
               and all(abs(v["world2_minus_world1"]) <= v["bound"] for v in eval_rec.values())
               and all(v["world2_minus_world1"] <= v["bound"] for v in lat_rec.values())
               and all(r["infer_latents"]["result"] == w2_cfg["infer_latents"]["output_path"]
                       for r in w2["ranks"]))}
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict))
    return records


# -- the regular, latent and manipulation trainers (stages phase) ------------ #

# the 128px DPM of configs/dpm_celebahq.yml, the trunk under the
# manipulation stage's PDAE
CELEBAHQ_DPM = dict(
    input_channel=3, base_channel=128, channel_multiplier=(1, 1, 2, 2, 4, 4),
    num_residual_blocks_of_a_block=2, attention_resolutions=(16,), num_heads=4,
    head_channel=-1, use_new_attention_order=False, dropout=0.0)
STAGE_STEPS = 6                  # saves at 3 and 6, the eval at 6
STAGE_LENGTH = {"regular": 320, "latent": 640, "manipulation": 640}
STAGE_BATCH = {"regular": 32, "latent": 128, "manipulation": 128}   # the configs'
# the depth cut of the manipulation eval (the trainer's default ddim500/ddim200)
MANIPULATION_EVAL = {"encode_style": "ddim100", "decode_style": "ddim100"}
LATENT_LOSS_RTOL = 1e-5          # precomputed z against the encoder in the step


def stage_runner():
    """The shipped configs' runner_config with the cadences of a 6-step run:
    a line a step, saves at 3 and 6, the eval at 6. ``steps_per_dispatch``
    is 1: the port's is a cadence check, and 3 is no multiple of 4 or 50."""
    return {"display_steps": 1, "evaluate_every_steps": STAGE_STEPS,
            "save_latest_every_steps": 3, "save_checkpoint_every_steps": 10000,
            "num_iterations": 1, "ema_every": 1, "ema_decay": 0.9999}


STAGE_DIFFUSION = {"timesteps": 1000, "betas_type": "linear"}
STAGE_ADAM = {"lr": 1e-4, "adam_betas": "(0.9, 0.999)", "adam_eps": 1e-8,
              "weight_decay": 0.0, "enable_amp": False}


def stage_data(stage, size, **extra) -> dict:
    return {"name": "SYNTHETIC", "image_size": size, "image_channel": 3,
            "length": STAGE_LENGTH[stage], "preload": True, "transfer_uint8": True,
            "device_resident": True, **extra}


def stage_loader(stage) -> dict:
    return {"train": {"num_workers": 4, "batch_size": STAGE_BATCH[stage]},
            "eval": {"num_generations": BATCH}}


def regular_config() -> dict:
    """The config dict of ``configs/dpm_celeba64.yml`` the stages phase trains."""
    from pdae_torch.models import CELEBA64_DPM

    return {"train_dataset_config": stage_data("regular", 64, augmentation=True),
            "eval_dataset_config": {"augmentation": False},
            "diffusion_config": STAGE_DIFFUSION,
            "denoise_fn_config": {"model": "UNet", **CELEBA64_DPM},
            "dataloader_config": stage_loader("regular"), "optimizer_config": STAGE_ADAM,
            "runner_config": stage_runner()}


def stage_configs(files) -> dict:
    """Config dicts of ``configs/dpm_celeba64.yml``, ``celeba64_latent.yml``
    and ``celebahq_manipulation.yml`` at their own widths, batches and
    optimizers, with SYNTHETIC data (uint8, device-resident, preloaded) and
    the stage files ``files`` names in place of the LMDBs and checkpoints."""
    data, loader, adam = stage_data, stage_loader, STAGE_ADAM

    def later(stage, pdae):
        return {"trained_ddpm_config": pdae["dpm_config"],
                "trained_representation_learning_config": pdae["config"],
                "trained_representation_learning_checkpoint": pdae["checkpoint"],
                "inferred_latents": pdae["stats"], "diffusion_config": STAGE_DIFFUSION,
                "eval_dataset_config": {"augmentation": False},
                "dataloader_config": loader(stage)}

    return {
        "regular": regular_config(),
        "latent": {
            **later("latent", files["celeba64"]),
            "train_dataset_config": data("latent", 64, latent_dim=LATENT, augmentation=False),
            "latent_denoise_fn_config": LATENT_CONFIG,
            "optimizer_config": {**adam, "name": "AdamW", "lr": 0.001, "weight_decay": 0.01},
            "runner_config": stage_runner()},
        "manipulation": {
            **later("manipulation", files["celebahq128"]),
            "train_dataset_config": data("manipulation", 128, latent_dim=LATENT,
                                         augmentation=False, multilabel=NUM_CLASSES),
            "optimizer_config": adam, "runner_config": stage_runner()},
    }


class KernelKeys:
    """A forward pre-hook on every module that counts, per run name, the
    kernel input keys as ``path_shapes`` keys them (a GN chain that will run
    a backward also under ``gn_bwd``); no run name, nothing counted."""

    def __init__(self):
        from pdae_torch.models.blocks import AttentionBlock, GNSiluChain
        self.kinds = (GNSiluChain, AttentionBlock)
        self.name = None
        self.counts = collections.defaultdict(collections.Counter)
        self.handle = torch.nn.modules.module.register_module_forward_pre_hook(self.hook)

    def hook(self, mod, args):
        if self.name is None or not isinstance(mod, self.kinds):
            return
        counts = self.counts[self.name]
        if isinstance(mod, self.kinds[0]):
            x = args[0]
            has_st = len(args) > 1 and args[1] is not None
            has_z = len(args) > 3 and args[3] is not None
            counts[("gn", *x.shape, has_st, has_z)] += 1
            if torch.is_grad_enabled() and any(
                    a is not None and a.requires_grad for a in (*args, mod.weight)):
                counts[("gn_bwd", *x.shape, has_st, has_z, x.requires_grad)] += 1
        else:
            b, c, h, w = args[0].shape
            counts[("attention", b, mod.num_heads, h * w, c // mod.num_heads)] += 1

    def runs_of(self):
        """{key: sorted run names that gave it}."""
        runs = collections.defaultdict(set)
        for name, counts in self.counts.items():
            for key in counts:
                runs[key].add(name)
        return {k: sorted(v) for k, v in runs.items()}


def idle_share(fn, reps: int = 5) -> dict:
    """``fn()`` ``reps`` times under ``torch.profiler``: wall and device-busy
    ms per call (the union of the card's kernel intervals) and the card's
    idle share."""
    from pdae_torch.tools.profile_autoencode import _busy_us
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.time_range.start, e.time_range.end) for e in prof.events()
               if getattr(e.device_type, "name", str(e.device_type)) == "CUDA"]
    busy = _busy_us(kernels)
    return {"wall_ms": wall_us / reps / 1e3,
            "device_busy_ms": busy / reps / 1e3 if kernels else None,
            "device_idle_share": 1.0 - busy / wall_us if kernels else None,
            "device_kernels_per_call": len(kernels) / reps}


def drive_stage(trainer, keys, name, eval_kwargs=None, keep_step3=None,
                save_on_exit=True) -> dict:
    """Train ``trainer`` to STAGE_STEPS through its own
    loop, each step synchronised and timed, its launches, GN variants and
    loss recorded and its kernel keys counted under ``{name}_step``; the eval
    (the config's cadence) timed and counted apart under ``{name}_eval``.
    Before step 6 the step-3 ``latest.ckpt`` is linked to ``keep_step3``
    (the save at 6 renames a new file over it)."""
    import shutil

    from pdae_torch import ops

    rec = {"s": [], "launches": [], "gn": [], "gn_bwd": [], "loss": []}
    inner_step, inner_eval = trainer.train_step, trainer.evaluate

    def counted_step(batch):
        if keep_step3 is not None and trainer.step == 5:
            trainer._join_save()
            latest = os.path.join(trainer.run_path, "checkpoints", "latest.ckpt")
            try:
                os.link(latest, keep_step3)
            except OSError:
                shutil.copyfile(latest, keep_step3)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        keys.name = f"{name}_step"
        s0 = time.perf_counter()
        out = inner_step(batch)
        torch.cuda.synchronize()
        rec["s"].append(time.perf_counter() - s0)
        keys.name = None
        rec["launches"].append(ops.launch_counts())
        rec["gn"].append(ops.gn_variant_counts())
        rec["gn_bwd"].append(ops.gn_bwd_variant_counts())
        rec["loss"].append(float(next(iter(out.values()))))
        return out

    def counted_eval(step):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        keys.name = f"{name}_eval"
        s0 = time.perf_counter()
        inner_eval(step, **(eval_kwargs or {}))
        torch.cuda.synchronize()
        keys.name = None
        rec["eval"] = {"s": time.perf_counter() - s0, "launches": ops.launch_counts(),
                       "gn_variants": ops.gn_variant_counts()}

    trainer.train_step, trainer.evaluate = counted_step, counted_eval
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if trainer.train(max_steps=STAGE_STEPS, save_on_exit=save_on_exit) != STAGE_STEPS:
        raise AssertionError(f"{name}: the loop stopped early")
    rec["loop_s"] = time.perf_counter() - t0
    rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    trainer.train_step, trainer.evaluate = inner_step, inner_eval
    return rec


def same_state(a, b) -> list:
    """The names of ``a``'s trained tensors whose params, EMA or Adam moments
    differ from ``b``'s in any bit."""
    bad = []
    for k, p in a.state.params["model"].items():
        q = b.state.params["model"][k]
        if not (torch.equal(p, q) and torch.equal(a.state.ema_params["model"][k],
                                                  b.state.ema_params["model"][k])
                and all(torch.equal(a.optimizer.state[p][m], b.optimizer.state[q][m])
                        for m in ("exp_avg", "exp_avg_sq", "step"))):
            bad.append(k)
    return bad


def write_celebahq_pdae(root, seed) -> dict:
    """The manipulation stage's frozen PDAE, which is not in the repository:
    the ShiftUNet over the ``configs/dpm_celebahq.yml`` trunk and the 128px
    encoder (latent 512) with seeded weights (zero-init layers perturbed),
    written as a checkpoint (``ema_encoder``, ``ema_decoder``) beside its
    run config and the DPM's config, with seeded latent stats."""
    from pdae_torch.models import ShiftUNet, encoder_for_resolution
    from pdae_torch.utils import encoder_tree, save_checkpoint, save_yaml, unet_tree

    gen = torch.Generator().manual_seed(seed + 9)
    torch.manual_seed(seed + 9)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBAHQ_DPM)
    encoder = encoder_for_resolution(128, LATENT)
    perturb_zero_params(decoder, gen)
    perturb_zero_params(encoder, gen)
    dpm = {"denoise_fn_config": {"model": "UNet", **CELEBAHQ_DPM},
           "diffusion_config": {"timesteps": 1000, "betas_type": "linear"}}
    files = {k: os.path.join(root, name) for k, name in (
        ("config", "pdae128.yml"), ("checkpoint", "pdae128.ckpt"),
        ("stats", "latents128.ckpt"), ("dpm_config", "dpm128.yml"))}
    save_yaml(dpm, files["dpm_config"])
    save_yaml({**dpm, "trained_ddpm_config": files["dpm_config"],
               "encoder_config": {"model": "CELEBAHQEncoder", "latent_dim": LATENT},
               "decoder_config": {"model": "CELEBAHQDecoder", "latent_dim": LATENT}},
              files["config"])
    save_checkpoint(files["checkpoint"], {
        "step": np.asarray(0, np.int32), "ema_encoder": encoder_tree(encoder.state_dict()),
        "ema_decoder": unet_tree(decoder.state_dict())})
    srs = np.random.RandomState(seed + 10)
    save_checkpoint(files["stats"], {
        "mean": (0.1 * srs.randn(LATENT)).astype(np.float32),
        "std": srs.uniform(0.5, 1.5, LATENT).astype(np.float32)})
    return files


def stages_phase(seed, device, files, compared, timed) -> dict:
    """The regular, latent and manipulation trainers at the shipped configs'
    widths through ``pdae_torch.train``'s code (``pick_trainer``, the trainer,
    its loop), each: run A 6 steps (saves at 3 and 6, the eval at 6), run B a
    fresh trainer resumed from A's step-3 file to 6, bit-equal to A; for the
    latent and manipulation stages also run P, ``latent_train_source:
    precomputed``, whose losses must equal A's within LATENT_LOSS_RTOL. Each
    step's launches are held to the structure's, every kernel key the runs
    give that no earlier phase compared (``compared``) is held to the plain
    versions, and the regular step's kernel time per step is summed from
    ``timed`` (the kernels phase's per-shape times) and the new shapes'."""
    import gc
    import shutil

    from pdae_torch.train import pick_trainer

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "stages")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    files = dict(files, celebahq128=write_celebahq_pdae(root, seed))
    configs = stage_configs(files)
    keys = KernelKeys()
    records = {"config": {
        "regular": "configs/dpm_celeba64.yml: UNet base 128 x(1,2,2,4), 2 blocks, 4 heads, "
                   "b32, Adam 1e-4; SYNTHETIC 64px RGB, 320 items, uint8, resident, the "
                   "device flip on",
        "latent": "configs/celeba64_latent.yml: MLPSkipNet 512 -> 2048, 10 layers, b128, "
                  "AdamW 1e-3 wd 0.01; the trainer phase's step-6 PDAE and the samplers "
                  "phase's InferLatents stats; SYNTHETIC 64px, 640 items, uint8, resident",
        "manipulation": "configs/celebahq_manipulation.yml: Linear(512, 40), b128, Adam "
                        "1e-4; a seeded PDAE over the configs/dpm_celebahq.yml trunk and "
                        "the 128px encoder; SYNTHETIC 128px, 640 items, 40 labels, uint8, "
                        "resident",
        "cuts": "6 steps each; manipulation eval ddim100/ddim100 (the trainer's "
                "ddim500/ddim200); steps_per_dispatch 1 (cadence check only)",
        "numerics": "fp32, TF32 off, cudnn.deterministic"}}

    def build(stage, run, config=None, resume=None):
        t0 = time.perf_counter()
        trainer = pick_trainer(config or configs[stage])(
            config=config or configs[stage], run_path=os.path.join(root, stage, run),
            resume=resume, seed=seed)
        if stage == "regular":
            # the config's augmentation: SYNTHETIC flips nothing on the host,
            # so the flag is set as the JAX package's own resident test sets
            # it, and each gathered row is flipped on the card by its coin
            trainer.train_dataset.augmentation = True
        return trainer, time.perf_counter() - t0

    def release(*trainers):
        for tr in trainers:
            tr._resident_cache = None
        gc.collect()
        torch.cuda.empty_cache()

    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for stage in ("regular", "latent", "manipulation"):
            cfg = configs[stage]
            a, build_s = build(stage, "a")
            if stage == "regular":
                per = per_call(a.model, torch.zeros(1, 3, 64, 64, device=device),
                               torch.zeros(1, dtype=torch.int32, device=device))
                want_step = {**per, "gn_adagn_silu_bwd": per["gn_adagn_silu"]}
                want_eval = {k: v * a.gd.ddim_schedule("ddim100").num_steps
                             for k, v in per.items()}
                eval_kwargs = None
            else:
                size = cfg["train_dataset_config"]["image_size"]
                x = torch.zeros(1, 3, size, size, device=device)
                enc = per_call(a.encoder, x)
                dec = per_call(a.decoder, x, torch.zeros(1, dtype=torch.int32, device=device),
                               torch.zeros(1, LATENT, device=device))
                want_step = enc
                if stage == "latent":
                    n_dec, n_enc = a.gd.ddim_schedule("ddim100").num_steps, 0
                    eval_kwargs = None
                else:
                    eval_kwargs = MANIPULATION_EVAL
                    n_dec = sum(a.gd.ddim_schedule(s).num_steps
                                for s in MANIPULATION_EVAL.values())
                    n_enc = 2
                want_eval = {k: n_dec * dec[k] + n_enc * enc[k] for k in dec}
            step3 = os.path.join(root, stage, "step3.ckpt")
            run_a = drive_stage(a, keys, f"{stage}_a", eval_kwargs, keep_step3=step3)
            latest = os.path.join(root, stage, "a", "checkpoints", "latest.ckpt")
            a._join_save()
            ckpt_bytes = os.path.getsize(latest)
            with open(os.path.join(root, stage, "a", "metrics.jsonl")) as f:
                metric_steps = [json.loads(line)["step"] for line in f]
            os.makedirs(os.path.join(root, stage, "b", "checkpoints"))
            shutil.copyfile(step3, os.path.join(root, stage, "b", "checkpoints",
                                                "latest.ckpt"))
            cfg_b = {**cfg, "runner_config": {**cfg["runner_config"],
                                              "evaluate_every_steps": 10000}}
            b, resume_s = build(stage, "b", cfg_b, resume="latest")
            run_b = drive_stage(b, keys, f"{stage}_b")
            mismatched = same_state(a, b)
            rec = {"build_s": build_s, "resume_build_s": resume_s, "start_step_b": b.start_step,
                   "losses": run_a["loss"], "step_s": run_a["s"],
                   "mean_step_s": sum(run_a["s"][1:]) / (len(run_a["s"]) - 1),
                   "launches_per_step": run_a["launches"][-1],
                   "launches_expected": want_step, "gn_variants_per_step": run_a["gn"][-1],
                   "gn_bwd_variants_per_step": run_a["gn_bwd"][-1],
                   "peak_mem_gb": run_a["peak_mem_gb"], "loop_s": run_a["loop_s"],
                   "save_wait_s": [r[0] for r in a.save_seconds + b.save_seconds],
                   "save_write_s": [r[1] for r in a.save_seconds + b.save_seconds],
                   "checkpoint_bytes": ckpt_bytes, "eval_s": run_a["eval"]["s"],
                   "eval_launches": run_a["eval"]["launches"],
                   "eval_launches_expected": want_eval,
                   "eval_gn_variants": run_a["eval"]["gn_variants"],
                   "metrics_steps": metric_steps, "resume_mismatched": mismatched[:5]}
            runs = [run_a, run_b]
            ok = (all(math.isfinite(v) for v in run_a["loss"] + run_b["loss"])
                  and rec["start_step_b"] == 3 and not mismatched
                  and metric_steps == list(range(1, STAGE_STEPS + 1))
                  and run_a["eval"]["launches"] == want_eval)
            if stage != "regular":
                pcfg = {**cfg, "runner_config": {**cfg["runner_config"],
                                                 "latent_train_source": "precomputed",
                                                 "evaluate_every_steps": 10000,
                                                 "save_latest_every_steps": 10000}}
                p, _ = build(stage, "p", pcfg)
                keys.name = f"{stage}_p_encode_corpus"
                t0 = time.perf_counter()
                p._resident_device_data()          # the corpus encoded once, timed apart
                torch.cuda.synchronize()
                encode_s = time.perf_counter() - t0
                keys.name = None
                run_p = drive_stage(p, keys, f"{stage}_p", save_on_exit=False)
                rel = [abs(x - y) / max(abs(y), 1e-30)
                       for x, y in zip(run_p["loss"], run_a["loss"])]
                zero = {"attention": 0, "gn_adagn_silu": 0, "gn_adagn_silu_bwd": 0}
                rec["precomputed"] = {
                    "encode_corpus_s": encode_s, "losses": run_p["loss"],
                    "loss_rel_err_vs_encode": rel, "step_s": run_p["s"],
                    "mean_step_s": sum(run_p["s"][1:]) / (len(run_p["s"]) - 1),
                    "launches_per_step": run_p["launches"][-1],
                    "peak_mem_gb": run_p["peak_mem_gb"],
                    "profile": idle_share(lambda: p.train_step(next(p._batch_iterator(
                        STAGE_STEPS))))}
                ok = ok and max(rel) <= LATENT_LOSS_RTOL and all(
                    c == zero for c in run_p["launches"])
                release(p)
                del p
            batch = next(b._batch_iterator(STAGE_STEPS))
            rec["profile"] = idle_share(lambda: b.train_step(batch))
            del batch
            ok = ok and all(c == want_step for c in run_a["launches"] + run_b["launches"])
            ok = ok and all(v == {"cluster": want_step["gn_adagn_silu"], "general": 0}
                            for r in runs for v in r["gn"])
            ok = ok and all(v == {"cluster": want_step["gn_adagn_silu_bwd"], "general": 0}
                            for r in runs for v in r["gn_bwd"])
            rec["ok"] = bool(ok)
            records[stage] = rec
            release(a, b)
            del a, b
            for path in (step3, latest, os.path.join(root, stage, "b", "checkpoints",
                                                     "latest.ckpt")):
                os.unlink(path)
    finally:
        keys.handle.remove()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags

    # every kernel key of those runs against the plain versions; the regular
    # step's keys are timed where the kernels phase did not time them
    runs_of = keys.runs_of()
    step_counts = keys.counts["regular_a_step"]
    check_gen = torch.Generator(device=device).manual_seed(seed + 11)
    checks = {"attention": check_attention, "gn": check_gn, "gn_bwd": check_gn_bwd}
    results = {}
    for key in sorted(runs_of):
        timed_here = key in step_counts and key not in timed
        if key in compared and not timed_here:
            continue
        arg = key[1:] if key[0] == "attention" else key
        results[key] = dict(checks[key[0]](arg, check_gen, device, timed=timed_here),
                            runs=runs_of[key], timed=timed_here)
    compared.update(results)          # the precision phase compares only what is new
    with open(os.path.join(OUT_DIR, "chip_smoke_stage_shapes.json"), "w") as f:
        json.dump([{"key": list(k), **v} for k, v in results.items()], f, indent=1)
    disagree = [(k, e) for k, r in results.items() for e, v in r["err"].items()
                if not v["ok"]]
    variants = collections.Counter(
        (k[0], plan["variant"], plan["cluster"]) for k, r in results.items()
        for name, plan in r.get("variant", {}).items() if name == "float32")
    records["kernel_shapes"] = {
        "batches": sorted({k[1] for k in runs_of}), "shapes": len(runs_of),
        "compared_here": len(results),
        "gn_bwd_modes_compared": sorted({f"adagn={k[5]},z={k[6]},dx={k[7]}"
                                         for k in results if k[0] == "gn_bwd"}),
        "max_abs_err_fp32": max((v["max_abs_err"] for r in results.values()
                                 for e, v in r["err"].items() if "float32" in e),
                                default=0.0),
        "fp32_variants": {f"{k}/{v}/c{c}": n for (k, v, c), n in sorted(variants.items())},
        "off_cluster_fp32": [list(k) for k, r in results.items()
                             if r.get("variant", {}).get("float32", {}).get(
                                 "variant", "cluster") != "cluster"],
        "disagree": disagree, "ok": not disagree}

    # the regular step's kernel time per step: each key's launches in one step
    # times its per-launch device time
    def per_launch(key):
        return (results[key] if key in results and results[key]["timed"] else timed[key])

    steps = len(records["regular"]["step_s"])
    per_step = {}
    for kind, name in (("attention", "attention"), ("gn", "gn_adagn_silu"),
                       ("gn_bwd", "gn_adagn_silu_bwd")):
        mine = {k: n / steps for k, n in step_counts.items() if k[0] == kind}
        sums = {f: sum(n * per_launch(k)[f] for k, n in mine.items())
                for f in ("ms", "plain_ms", "library_ms")}
        t_bytes = sum(n * per_launch(k)["bytes"] for k, n in mine.items()) / HBM_BYTES_PER_S
        t_ops = sum(n * per_launch(k)["flops"] for k, n in mine.items()) / FP32_FLOPS
        per_step[name] = {**sums, "launches": sum(mine.values()), "shapes": len(mine),
                          "bound_ms": max(t_bytes, t_ops) * 1e3,
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    records["regular"]["kernel_ms_per_step"] = per_step
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict)
                        and "ok" in v)
    return records


# configs/dpm_ffhq.yml's denoise_fn_config: the FFHQ128 DPM under the PDAE of
# configs/ffhq_representation_learning.yml
FFHQ_DPM = dict(
    input_channel=3, base_channel=128, channel_multiplier=(1, 1, 2, 2, 4, 4),
    num_residual_blocks_of_a_block=2, attention_resolutions=(16,), num_heads=4,
    head_channel=-1, use_new_attention_order=False, dropout=0.0)
FFHQ_STEPS = 2                   # timed per (dtype, remat), after one warm-up
REMAT_MODES = {"none": None, "skips": "skips", "full": True}
# bf16 whole path: kernels against plain versions within this many times the
# plain path's own bf16-against-fp32 relative L2 on the same inputs
PRECISION_RATIO = 2.0
# remat modes that are not bit-equal: each gradient within this times its
# tensor's largest
REMAT_GRAD_TOL = 1e-6


def quiet_runner() -> dict:
    """``stage_runner`` with no save and no eval inside a 6-step run."""
    return {**stage_runner(), "evaluate_every_steps": 10000, "save_latest_every_steps": 10000}


def ffhq_config(dpm_config, dpm_checkpoint, dtype: str) -> dict:
    """``configs/ffhq_representation_learning.yml`` as a dict: ``FFHQEncoder``
    and ``FFHQDecoder`` (latent 512) over the DPM config file
    ``dpm_config`` and the trunk ``dpm_checkpoint``, b32, its Adam; SYNTHETIC
    128px in place of the FFHQ LMDB; compute dtype ``dtype``."""
    return {
        "train_dataset_config": {"name": "SYNTHETIC", "image_size": 128, "image_channel": 3,
                                 "length": 64, "preload": True, "latent_dim": LATENT},
        "eval_dataset_config": {},
        "diffusion_config": dict(STAGE_DIFFUSION),
        "trained_ddpm_config": dpm_config, "trained_ddpm_checkpoint": dpm_checkpoint,
        "encoder_config": {"model": "FFHQEncoder", "latent_dim": LATENT},
        "decoder_config": {"model": "FFHQDecoder", "latent_dim": LATENT},
        "dataloader_config": {"train": {"num_workers": 4, "batch_size": TRAIN_BATCH},
                              "eval": {"num_generations": BATCH}},
        "optimizer_config": dict(STAGE_ADAM),
        "runner_config": {**quiet_runner(), "compute_dtype": dtype}}


def remat_structure(encoder, decoder) -> dict:
    """The kernel launches of one representation step under each remat mode,
    from the models' structure. Every GN chain and attention block runs once
    a forward: the encoder's, the trunk's (``input_blocks``), the epsilon
    decode's and the shift branch's. The backward runs the encoder's and the
    shift branch's chains. ``skips`` runs the shift branch again, ``full``
    the trunk and the shift branch, its checkpointed region; the recompute
    of a region stops at the last tensor the backward needs
    (``torch.utils.checkpoint``'s early stop), the input of the shift
    branch's output conv, which comes after every GN chain and attention
    block."""
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain

    regions = {"trunk": ("input_blocks",), "epsilon": ("middle_block", "output_blocks", "out"),
               "shift": ("shift_middle_block", "shift_output_blocks", "shift_out")}

    def count(model, heads=None):
        out = {"gn": 0, "attention": 0}
        for name, m in model.named_modules():
            if heads is not None and name.split(".")[0] not in heads:
                continue
            if isinstance(m, GNSiluChain):
                out["gn"] += 1
            elif isinstance(m, AttentionBlock):
                out["attention"] += 1
        return out

    enc = count(encoder)
    part = {k: count(decoder, v) for k, v in regions.items()}
    if count(decoder) != {k: sum(p[k] for p in part.values()) for k in enc}:
        raise AssertionError("a GN chain or attention block of the decoder lies outside "
                             "the trunk, the epsilon decode and the shift branch")
    again = {"none": (), "skips": ("shift",), "full": ("trunk", "shift")}
    return {mode: {"attention": enc["attention"] + sum(p["attention"] for p in part.values())
                   + sum(part[r]["attention"] for r in extra),
                   "gn_adagn_silu": enc["gn"] + sum(p["gn"] for p in part.values())
                   + sum(part[r]["gn"] for r in extra),
                   "gn_adagn_silu_bwd": enc["gn"] + part["shift"]["gn"]}
            for mode, extra in again.items()}


def rel_l2(a, b) -> float:
    """|a - b| / |b| over lists of tensors, in float64."""
    a = torch.cat([t.detach().double().flatten() for t in a])
    b = torch.cat([t.detach().double().flatten() for t in b])
    return float((a - b).norm() / b.norm())


def within_control(kernel, plain, plain32, floor=0.0) -> dict:
    """Kernels against plain versions (both bf16) beside the control, the
    plain path's own bf16-against-fp32 gap (raised to ``floor``)."""
    control = max(rel_l2(plain, plain32), floor)
    err = rel_l2(kernel, plain)
    return {"rel_l2": err, "control": control, "ratio": err / control,
            "ok": bool(err <= PRECISION_RATIO * control and 0.0 < control)}


def bf16_step_record(trainer, run, want, fp32, models) -> dict:
    """A bf16 stage run of ``drive_stage``: its losses, times and launches
    beside the fp32 run's figures ``fp32``; params and grads fp32; every
    conv and linear of ``models`` in bf16."""
    from pdae_torch.models.blocks import Conv1d, Conv2d, Linear
    from pdae_torch.training.state import flat_params

    params = flat_params(trainer.state.params)
    layers = [m for model in models for m in model.modules()
              if isinstance(m, (Conv1d, Conv2d, Linear))]
    rec = {"losses": run["loss"], "step_s": run["s"],
           "mean_step_s": sum(run["s"][1:]) / (len(run["s"]) - 1),
           "peak_mem_gb": run["peak_mem_gb"], "fp32": fp32,
           "launches_per_step": run["launches"][-1], "launches_expected": want,
           "gn_variants_per_step": run["gn"][-1], "gn_bwd_variants_per_step": run["gn_bwd"][-1],
           "params_fp32": all(p.dtype == torch.float32 for p in params),
           "grads_fp32_finite": all(p.grad is not None and p.grad.dtype == torch.float32
                                    and bool(torch.isfinite(p.grad).all()) for p in params),
           "layers_bf16": bool(layers) and all(m.compute_dtype == torch.bfloat16
                                               for m in layers)}
    rec["speedup_vs_fp32"] = fp32["mean_step_s"] / rec["mean_step_s"]
    rec["ok"] = bool(
        all(math.isfinite(v) for v in run["loss"]) and rec["params_fp32"]
        and rec["grads_fp32_finite"] and rec["layers_bf16"]
        and all(c == want for c in run["launches"])
        and all(v == {"cluster": want["gn_adagn_silu"], "general": 0} for v in run["gn"])
        and all(v == {"cluster": want["gn_adagn_silu_bwd"], "general": 0}
                for v in run["gn_bwd"]))
    return rec


def precision_phase(seed, device, compared, want_step, fp32) -> dict:
    """bf16 compute over fp32 params and rematerialisation at full width:
    the celeba64 representation and regular trainers in bf16 (``drive_stage``:
    one warm-up and 5 timed steps each, beside the fp32 figures ``fp32``); at
    b2 the bf16 kernels against the bf16 plain versions, held to the plain
    path's own bf16-against-fp32 gap; the FFHQ128 representation step at b32
    under each remat mode in fp32 and bf16, each from the same state, t and
    noise (``cudnn.deterministic``), its launches against
    ``remat_structure``; then every kernel key of these runs that no earlier
    phase compared (``compared``) against the plain versions in fp32 and
    bf16, the 128x128 GN keys timed."""
    import gc
    import shutil

    from pdae_torch.models import FROZEN_PREFIXES, UNet
    from pdae_torch.ops import attention
    from pdae_torch.train import pick_trainer
    from pdae_torch.training import RepresentationLearningTrainer
    from pdae_torch.utils import save_checkpoint, save_yaml, unet_tree

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "precision")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    keys = KernelKeys()
    records = {"config": {
        "representation": "the trainer phase's config (celeba64 PDAE over the seeded "
                          "CELEBA64_DPM trunk, b32, Adam 1e-4), compute_dtype bfloat16",
        "regular": "the stages phase's configs/dpm_celeba64.yml dict (b32, resident "
                   "uint8, the device flip), compute_dtype bfloat16, cudnn.deterministic",
        "ffhq128": "configs/ffhq_representation_learning.yml (FFHQEncoder, FFHQDecoder, "
                   "latent 512, b32, Adam 1e-4) over a seeded trunk of configs/dpm_ffhq.yml "
                   "(base 128 x(1,1,2,2,4,4), attention at 16, 4 heads); SYNTHETIC 128px; "
                   "cudnn.deterministic",
        "numerics": "bf16 compute over fp32 params; fp32 with TF32 off"}}
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    try:
        # 1. bf16 steps at celeba64 ------------------------------------------
        cfg = trainer_config(os.path.join(OUT_DIR, "trainer", "dpm.ckpt"))
        cfg["runner_config"] = {**quiet_runner(), "compute_dtype": "bfloat16"}
        rep = RepresentationLearningTrainer(config=cfg, run_path=os.path.join(root, "rep"),
                                            seed=seed)
        trunk = {k: v.clone() for k, v in rep.decoder.state_dict().items()
                 if k.split(".")[0] in FROZEN_PREFIXES}
        run = drive_stage(rep, keys, "precision_representation", save_on_exit=False)
        rec = bf16_step_record(rep, run, want_step, fp32["representation"],
                               (rep.encoder, rep.decoder))
        now = rep.decoder.state_dict()
        rec["trunk_unchanged"] = all(torch.equal(now[k], v) for k, v in trunk.items())
        attn = [k for k in keys.counts["precision_representation_step"] if k[0] == "attention"]
        rec["attention_on_mma_tiles"] = [list(k[1:]) for k in attn
                                         if attention.attention_plan(k[1] * k[2], k[3], k[4],
                                                                     2).mma]
        rec["ok"] = bool(rec["ok"] and rec["trunk_unchanged"]
                         and len(rec["attention_on_mma_tiles"]) == len(attn) > 0)
        records["representation"] = rec
        del trunk, now

        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        cfg = regular_config()
        cfg["runner_config"] = {**quiet_runner(), "compute_dtype": "bfloat16"}
        reg = pick_trainer(cfg)(config=cfg, run_path=os.path.join(root, "regular"), seed=seed)
        reg.train_dataset.augmentation = True     # as the stages phase runs it
        per = per_call(reg.model, torch.zeros(1, 3, 64, 64, device=device),
                       torch.zeros(1, dtype=torch.int32, device=device))
        run = drive_stage(reg, keys, "precision_regular", save_on_exit=False)
        records["regular"] = bf16_step_record(
            reg, run, {**per, "gn_adagn_silu_bwd": per["gn_adagn_silu"]}, fp32["regular"],
            (reg.model,))
        reg._resident_cache = None
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags

        # 2. the bf16 whole path at b2: kernels against plain versions -------
        records["whole_path_bf16"] = bf16_whole_path(seed, device, rep, reg, cfg)
        del rep, reg
        release()

        # 3. the FFHQ128 representation step under each remat mode ------------
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        dpm_config = os.path.join(root, "dpm_ffhq.yml")
        dpm_path = os.path.join(root, "dpm_ffhq.ckpt")
        save_yaml({"denoise_fn_config": {"model": "UNet", **FFHQ_DPM},
                   "diffusion_config": STAGE_DIFFUSION}, dpm_config)
        gen = torch.Generator().manual_seed(seed + 13)
        torch.manual_seed(seed + 13)
        unet = UNet(**FFHQ_DPM)
        perturb_zero_params(unet, gen)
        save_checkpoint(dpm_path, {"step": np.asarray(0, np.int32),
                                   "ema_denoise_fn": unet_tree(unet.state_dict())})
        del unet
        ffhq = {}
        inputs = None
        for dtype in ("float32", "bfloat16"):
            t0 = time.perf_counter()
            tr = RepresentationLearningTrainer(config=ffhq_config(dpm_config, dpm_path, dtype),
                                               run_path=os.path.join(root, f"ffhq_{dtype}"),
                                               seed=seed)
            build_s = time.perf_counter() - t0
            if inputs is None:
                g = torch.Generator(device=device).manual_seed(seed + 14)
                x_0 = next(tr._batch_iterator(0))["x_0"]
                inputs = (x_0, torch.randint(0, 1000, (TRAIN_BATCH,), generator=g,
                                             device=device, dtype=torch.int32),
                          torch.randn(x_0.shape, generator=g, device=device))
            ffhq[dtype] = ffhq_remat_runs(tr, keys, inputs, dtype, device)
            ffhq[dtype]["build_s"] = build_s
            del tr
            release()
        os.unlink(dpm_path)
        records["ffhq128"] = ffhq
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
    finally:
        keys.handle.remove()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags

    # 4. every new kernel key against the plain versions, fp32 and bf16 -------
    runs_of = keys.runs_of()
    check_gen = torch.Generator(device=device).manual_seed(seed + 15)
    checks = {"attention": check_attention, "gn": check_gn, "gn_bwd": check_gn_bwd}
    results = {}
    for key in sorted(k for k in runs_of if k not in compared):
        timed = key[0] != "attention" and key[3] == 128     # the 128x128 GN slabs
        arg = key[1:] if key[0] == "attention" else key
        results[key] = dict(checks[key[0]](arg, check_gen, device, timed=timed),
                            runs=runs_of[key], timed=timed)
    compared.update(results)
    with open(os.path.join(OUT_DIR, "chip_smoke_precision_shapes.json"), "w") as f:
        json.dump([{"key": list(k), **v} for k, v in results.items()], f, indent=1)
    disagree = [(list(k), e) for k, r in results.items() for e, v in r["err"].items()
                if not v["ok"]]
    off_cluster = [(list(k), name) for k, r in results.items()
                   for name, plan in r.get("variant", {}).items()
                   if plan["variant"] != "cluster"]
    timed_rows = {json.dumps(list(k)): {f: r.get(f) for f in (
        "ms", "bf16_ms", "plain_ms", "library_ms", "bf16_library_ms", "bf16_bound_ms")}
        for k, r in results.items() if r["timed"]}
    for k, r in results.items():
        if r["timed"]:
            timed_rows[json.dumps(list(k))]["bound_ms"] = max(
                r["bytes"] / HBM_BYTES_PER_S, r["flops"] / FP32_FLOPS) * 1e3
            timed_rows[json.dumps(list(k))]["plan_fp32"] = r["variant"]["float32"]
    records["kernel_shapes"] = {
        "shapes": len(runs_of), "compared_here": len(results),
        "max_abs_err_fp32": max((v["max_abs_err"] for r in results.values()
                                 for e, v in r["err"].items() if "float32" in e), default=0.0),
        "timed_128px": timed_rows, "off_cluster": off_cluster, "disagree": disagree,
        "ok": not disagree and not off_cluster}
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


def bf16_whole_path(seed, device, rep, reg, reg_cfg) -> dict:
    """At b2, from the same weights, t and noise: one ShiftUNet forward, the
    representation step's loss and every trainable gradient, and the regular
    step's, through the bf16 kernels and through the bf16 plain versions,
    beside the control: the plain path in bf16 against fp32 twins of the same
    models. Each within PRECISION_RATIO times its control; a loss, one number
    whose rounding is a single draw, with the larger of its own control and
    its step's gradient control."""
    from pdae_torch import ops
    from pdae_torch.models import build_decoder, build_denoise_fn, build_encoder
    from pdae_torch.training import trainable_params
    from pdae_torch.training.artifacts import resolve_model_config
    from pdae_torch.training.state import flat_params

    rs = np.random.RandomState(seed + 12)

    def tensor(*shape):
        return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(device)

    x_0, noise, z = tensor(2, 3, 64, 64).clamp(-1, 1), tensor(2, 3, 64, 64), tensor(2, LATENT)
    t = torch.tensor([10, 500], dtype=torch.int32, device=device)
    cfg = rep.config
    twins = {"encoder": build_encoder(cfg["encoder_config"], image_size=64),
             "decoder": build_decoder(cfg["decoder_config"],
                                      resolve_model_config(cfg["trained_ddpm_config"])),
             "unet": build_denoise_fn(reg_cfg["denoise_fn_config"])}
    for name, model in (("encoder", rep.encoder), ("decoder", rep.decoder),
                        ("unet", reg.model)):
        twins[name].load_state_dict(model.state_dict(), strict=True)
        twins[name].to(device).train(model.training)

    def forward(dec):
        with torch.inference_mode():
            return list(dec(x_0, t, z))

    def rep_grads(enc, dec):
        leaves = flat_params(trainable_params(enc, dec))
        loss = rep.gd.representation_learning_train_one_batch(
            None, enc, dec, x_0, t=t, noise=noise)["prediction_loss"]
        return [loss.detach()], list(torch.autograd.grad(loss, leaves))

    def reg_grads(model):
        leaves = [p for p in model.parameters() if p.requires_grad]
        loss = reg.gd.regular_train_one_batch(None, model, x_0, None, t=t,
                                              noise=noise)["prediction_loss"]
        return [loss.detach()], list(torch.autograd.grad(loss, leaves))

    runs = {
        "shift_unet_forward": lambda bf16: forward(rep.decoder if bf16 else twins["decoder"]),
        "representation_step": lambda bf16: rep_grads(
            *((rep.encoder, rep.decoder) if bf16 else (twins["encoder"], twins["decoder"]))),
        "regular_step": lambda bf16: reg_grads(reg.model if bf16 else twins["unet"]),
    }
    out = {}
    for name, run in runs.items():
        kernel = run(True)
        ops.set_use_kernels(False)
        try:
            plain, plain32 = run(True), run(False)
        finally:
            ops.set_use_kernels(None)
        if name == "shift_unet_forward":
            out[name] = within_control(kernel, plain, plain32)
            continue
        grads = within_control(kernel[1], plain[1], plain32[1])
        grads["tensors"] = len(kernel[1])
        grads["all_nonzero_finite"] = all(bool(torch.isfinite(g).all()) and bool(g.any())
                                          for g in kernel[1])
        grads["ok"] = grads["ok"] and grads["all_nonzero_finite"]
        out[name] = {"loss": within_control(kernel[0], plain[0], plain32[0],
                                            floor=grads["control"]),
                     "grads": grads,
                     "loss_values": {"kernels_bf16": float(kernel[0][0]),
                                     "plain_bf16": float(plain[0][0]),
                                     "plain_fp32": float(plain32[0][0])}}
        out[name]["ok"] = out[name]["loss"]["ok"] and grads["ok"]
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def ffhq_remat_runs(tr, keys, inputs, dtype, device) -> dict:
    """The FFHQ128 representation step of trainer ``tr`` under each remat
    mode, each from the trainer's initial state (params, EMA, an empty Adam)
    on the same ``(x_0, t, noise)``: one warm-up step and FFHQ_STEPS timed,
    the launches of each against ``remat_structure``, the first step's loss
    and gradients against the mode without remat."""
    from pdae_torch import ops
    from pdae_torch.training import make_representation_train_step
    from pdae_torch.training.state import flat_params

    x_0, t, noise = inputs
    params, ema = flat_params(tr.state.params), flat_params(tr.state.ema_params)
    start = [p.detach().clone() for p in params]
    ema_start = [e.clone() for e in ema]
    want = remat_structure(tr.encoder, tr.decoder)
    out = {"structure": want}
    first = {}
    for mode, remat in REMAT_MODES.items():
        with torch.no_grad():
            for p, s, e, e0 in zip(params, start, ema, ema_start):
                p.copy_(s)
                p.grad = None
                e.copy_(e0)
        tr.optimizer.state.clear()
        tr.state.step = 0
        step = make_representation_train_step(tr.gd, tr.encoder, tr.decoder, tr.optimizer,
                                              device=device, remat=remat)
        rec = {"s": [], "loss": [], "launches": [], "gn": [], "gn_bwd": []}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 + FFHQ_STEPS):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            keys.name = f"ffhq_{dtype}_{mode}"
            s0 = time.perf_counter()
            loss = step(tr.state, x_0, t=t, noise=noise)
            torch.cuda.synchronize()
            rec["s"].append(time.perf_counter() - s0)
            keys.name = None
            rec["loss"].append(float(loss))
            rec["launches"].append(ops.launch_counts())
            rec["gn"].append(ops.gn_variant_counts())
            rec["gn_bwd"].append(ops.gn_bwd_variant_counts())
            if i == 0:
                first[mode] = (loss.clone(), [p.grad.clone() for p in params])
        w = want[mode]
        out[mode] = {
            "losses": rec["loss"], "step_s": rec["s"],
            "mean_step_s": sum(rec["s"][1:]) / FFHQ_STEPS,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches_per_step": rec["launches"][-1], "launches_expected": w,
            "ok": bool(all(math.isfinite(v) for v in rec["loss"])
                       and all(c == w for c in rec["launches"])
                       and all(v == {"cluster": w["gn_adagn_silu"], "general": 0}
                               for v in rec["gn"])
                       and all(v == {"cluster": w["gn_adagn_silu_bwd"], "general": 0}
                               for v in rec["gn_bwd"]))}
    base_loss, base_grads = first["none"]
    for mode in ("skips", "full"):
        loss, grads = first[mode]
        bit_equal = (bool(torch.equal(loss, base_loss))
                     and all(torch.equal(a, b) for a, b in zip(grads, base_grads))
                     and out[mode]["losses"] == out["none"]["losses"])
        worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(grads, base_grads))
        out[mode]["vs_none"] = {
            "bit_equal": bit_equal, "loss_rel_err": abs(float(loss) - float(base_loss)) / abs(float(base_loss)),
            "worst_grad_err_of_its_max": worst}
        out[mode]["ok"] = bool(out[mode]["ok"] and (bit_equal or (
            worst <= REMAT_GRAD_TOL and out[mode]["vs_none"]["loss_rel_err"] <= REMAT_GRAD_TOL)))
    out["ok"] = all(out[m]["ok"] for m in REMAT_MODES)
    return out


INGEST_IMAGES = 256              # synthetic JPEGs at CelebA's geometry, packed by the CLI
INGEST_HW = (218, 178)           # CelebA's aligned images, height x width
INGEST_QUALITY = 95
INGEST_STEPS = 5                 # the first is a warm-up
INGEST_STYLE = "ddim10"          # the served request's encode and decode style
DECODE_THREADS = (1, 4)          # 4: the shipped configs' loader workers
DECODE_MAX_LEVELS, DECODE_WITHIN_ONE = 3, 0.99   # native against PIL (tests/test_data.py)
JPEG_HEADER = "/usr/include/jpeglib.h"


def synthetic_photos(seed, n, hw=INGEST_HW) -> np.ndarray:
    """``n`` seeded RGB images: smooth colour fields with noise, so that their
    JPEGs keep detail at every frequency the resize filters."""
    rs = np.random.RandomState(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f, phase = rs.uniform(5, 30, (2, 3)), rs.uniform(0, 6, 3)
        field = 128 + 100 * np.sin(xx[..., None] / f[0] + phase) * np.cos(yy[..., None] / f[1])
        out[i] = np.clip(field + rs.normal(0, 20, (h, w, 3)), 0, 255)
    return out


def run_module(*args) -> dict:
    """``python -m ARGS`` from the checkout's root, as a user runs the port's
    CLIs: its seconds and the last line it printed. Fails on a non-zero exit."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return {"s": time.perf_counter() - t0, "said": lines[-1] if lines else ""}


def same_trees(a, b) -> bool:
    """Every leaf of ``a`` and ``b`` (numpy trees) equal bit for bit, with
    the same keys, shapes and dtypes."""
    fa, fb = _flat(a), _flat(b)
    return sorted(fa) == sorted(fb) and all(
        np.asarray(v).dtype == np.asarray(fb[k]).dtype
        and np.array_equal(np.asarray(v), np.asarray(fb[k])) for k, v in fa.items())


def per_second(fn, items, threads, reps=2) -> float:
    """``fn`` over ``items`` on a pool of ``threads``: calls per host second."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(threads) as pool:
        list(pool.map(fn, items))                      # warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            list(pool.map(fn, items))
        return reps * len(items) / (time.perf_counter() - t0)


def ingest_phase(seed, device, want_step, want_request, trainer_step_s) -> dict:
    """The files a user brings, on their way to the card: seeded JPEGs at
    CelebA's geometry packed by ``python -m pdae_torch.prepare_lmdb``; the
    trainer phase's DPM exported to a reference ``.pt`` and converted back by
    ``python -m pdae_torch.convert``; the celeba64 representation trainer on
    CELEBA64 over that LMDB (``fast_decode`` at its default) from the
    converted DPM; the native and PIL decode rates and the LMDB readers' get
    rates on the host; and the trained checkpoint exported, converted back
    and served by ``PDAEService.from_config``, bit-equal to the service of
    the unconverted file. ``cudnn.deterministic`` throughout."""
    import shutil

    from PIL import Image

    from pdae_torch import ops
    from pdae_torch.data import CELEBA64, NativeReader, Reader
    from pdae_torch.data import lmdb_store, native_image
    from pdae_torch.serving import PDAEService
    from pdae_torch.training import RepresentationLearningTrainer
    from pdae_torch.utils import _host_build, load_checkpoint

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "ingest")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def path(name):
        return os.path.join(root, name)

    rec = {"config": f"{INGEST_IMAGES} seeded JPEGs {INGEST_HW[1]}x{INGEST_HW[0]} "
                     f"quality {INGEST_QUALITY}; the trainer phase's config on CELEBA64 "
                     "(augmentation on, the train split cut to the packed images) over "
                     "the converted DPM, b32, fp32, TF32 off, cudnn.deterministic"}
    # the backends: the reader must build; the decoder falls back to PIL
    # only where libjpeg's header is missing
    reader_lib = lmdb_store.native_lib()
    decoder = "native" if native_image.available() else "pil"
    rec["backends"] = {"reader_library": reader_lib is not None, "decoder": decoder,
                       "jpeglib_h": os.path.exists(JPEG_HEADER)}
    if decoder == "pil":
        rec["backends"]["decoder_build_last_line"] = _host_build.last_line("image_decode.cpp")
    backends_ok = reader_lib is not None and (decoder == "native"
                                              or not rec["backends"]["jpeglib_h"])
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        # 1. the user's images, packed ------------------------------------------------
        t0 = time.perf_counter()
        os.makedirs(path("images"))
        for i, img in enumerate(synthetic_photos(seed + 20, INGEST_IMAGES)):
            Image.fromarray(img).save(path(f"images/{i:06d}.jpg"), quality=INGEST_QUALITY)
        write_s = time.perf_counter() - t0
        packed = run_module("pdae_torch.prepare_lmdb", path("images"), path("lmdb"),
                            "--key-format", CELEBA64.key_fmt)
        rec["pack"] = {"write_jpegs_s": write_s, "prepare_lmdb_s": packed["s"],
                       "said": packed["said"],
                       "lmdb_bytes": os.path.getsize(path("lmdb/data.mdb"))}

        # 2. the DPM to a reference .pt and back ---------------------------------------
        dpm = os.path.join(OUT_DIR, "trainer", "dpm.ckpt")
        export = run_module("pdae_torch.convert", dpm, path("dpm.pt"), "--export")
        back = run_module("pdae_torch.convert", path("dpm.pt"), path("dpm.ckpt"))
        with open(dpm, "rb") as a, open(path("dpm.ckpt"), "rb") as b:
            dpm_bytes_equal = a.read() == b.read()
        rec["dpm_round_trip"] = {
            "export_s": export["s"], "convert_s": back["s"],
            "ckpt_bytes": os.path.getsize(dpm), "pt_bytes": os.path.getsize(path("dpm.pt")),
            "leaves_bit_equal": same_trees(load_checkpoint(dpm), load_checkpoint(path("dpm.ckpt"))),
            "file_bytes_equal": dpm_bytes_equal}

        # 3. the representation trainer on the LMDB -----------------------------------
        config = trainer_config(path("dpm.ckpt"))
        config["train_dataset_config"] = {
            "name": "CELEBA64", "data_path": path("lmdb"), "image_size": 64,
            "image_channel": 3, "latent_dim": LATENT, "augmentation": True, "split": "train"}
        config["eval_dataset_config"] = {"split": "valid", "augmentation": False}
        config["runner_config"] = {**config["runner_config"], "evaluate_every_steps": 10000,
                                   "save_latest_every_steps": 10000}
        run = RepresentationLearningTrainer(config=config, run_path=path("run"), seed=seed)
        # the split holds 162,770 keys; the LMDB the first INGEST_IMAGES
        run.train_dataset.length = INGEST_IMAGES
        steps = {"s": [], "launches": [], "gn": [], "gn_bwd": [], "loss": []}
        inner = run.train_step

        def counted_step(batch):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            s0 = time.perf_counter()
            out = inner(batch)
            torch.cuda.synchronize()
            steps["s"].append(time.perf_counter() - s0)
            steps["launches"].append(ops.launch_counts())
            steps["gn"].append(ops.gn_variant_counts())
            steps["gn_bwd"].append(ops.gn_bwd_variant_counts())
            steps["loss"].append(float(out["prediction_loss"]))
            return out

        run.train_step = counted_step
        t0 = time.perf_counter()
        assert run.train(max_steps=INGEST_STEPS) == INGEST_STEPS
        loop_s = time.perf_counter() - t0
        with open(path("run/metrics.jsonl")) as f:
            load_data = [json.loads(line)["time/load_data"] for line in f]
        mean_step_s = sum(steps["s"][1:]) / (INGEST_STEPS - 1)
        rec["train"] = {
            "reader": type(run.train_dataset._txn()).__name__,
            "decoder": decoder if run.train_dataset.fast_decode else "pil",
            "losses": steps["loss"], "step_s": steps["s"], "mean_step_s": mean_step_s,
            "trainer_phase_step_s": trainer_step_s,
            "vs_trainer_phase": mean_step_s / trainer_step_s, "loop_s": loop_s,
            "time_load_data_s": load_data, "launches_per_step": steps["launches"][-1],
            "launches_expected": want_step}
        rec["train"]["ok"] = bool(
            all(math.isfinite(v) for v in steps["loss"])
            and len(steps["loss"]) == INGEST_STEPS
            and all(c == want_step for c in steps["launches"])
            and all(v == {"cluster": want_step["gn_adagn_silu"], "general": 0}
                    for v in steps["gn"])
            and all(v == {"cluster": want_step["gn_adagn_silu_bwd"], "general": 0}
                    for v in steps["gn_bwd"])
            and rec["train"]["reader"] == "NativeReader")
        dataset = run.train_dataset
        del run

        # 4. decode and read rates on the host ----------------------------------------
        pil = CELEBA64({"data_path": path("lmdb"), "image_size": 64, "fast_decode": False})
        indices = list(range(INGEST_IMAGES))
        images = np.stack([np.asarray(dataset._load_image(i)) for i in indices[:BATCH]])
        rec["decode"] = {
            "crop": list(CELEBA64.crop), "size": 64,
            "pil_imgs_per_s": {t: per_second(pil._load_image, indices, t)
                               for t in DECODE_THREADS},
            "b32_step_demand_imgs_per_s": TRAIN_BATCH / mean_step_s, "ok": True}
        if decoder == "native":
            native_px = np.stack([dataset._load_image(i) for i in indices])
            pil_px = np.stack([np.asarray(pil._load_image(i)) for i in indices])
            levels = np.abs(native_px.astype(int) - pil_px.astype(int))
            rec["decode"].update(
                native_imgs_per_s={t: per_second(dataset._load_image, indices, t)
                                   for t in DECODE_THREADS},
                max_levels_vs_pil=int(levels.max()),
                share_within_one_level=float((levels <= 1).mean()),
                share_equal=float((levels == 0).mean()))
            rec["decode"]["ok"] = (rec["decode"]["max_levels_vs_pil"] <= DECODE_MAX_LEVELS
                                   and rec["decode"]["share_within_one_level"]
                                   >= DECODE_WITHIN_ONE)
        else:
            rec["decode"]["native_imgs_per_s"] = "not measured: the native decoder is absent"
        keys = [dataset._index_key(i) for i in indices]
        readers = {"native": NativeReader(path("lmdb")), "pure": Reader(path("lmdb"))}
        rec["reader_gets_per_s"] = {name: per_second(r.get, keys * 20, 1)
                                    for name, r in readers.items()}
        for r in readers.values():
            r.close()

        # 5. the trained checkpoint to a .pt and back, then served ---------------------
        latest = path("run/checkpoints/latest.ckpt")
        export = run_module("pdae_torch.convert", latest, path("pdae.pt"), "--export")
        back = run_module("pdae_torch.convert", path("pdae.pt"), path("pdae.ckpt"))
        original, converted = load_checkpoint(latest), load_checkpoint(path("pdae.ckpt"))
        kept = sorted(converted)
        trees_equal = same_trees({k: original[k] for k in kept}, converted)
        del original, converted
        base = {"config_path": path("run/config.yml"), "max_batch": 64}
        served = {}
        for name, ckpt in (("unconverted", latest), ("converted", path("pdae.ckpt"))):
            service = PDAEService.from_config({**base, "checkpoint_path": ckpt}, device)
            out, counts = counted(lambda: service.autoencode(images, INGEST_STYLE,
                                                             INGEST_STYLE))
            served[name] = (out, counts)
            del service
        out, counts = served["converted"]
        rec["serve"] = {
            "export_s": export["s"], "convert_s": back["s"],
            "bytes": {"latest_ckpt": os.path.getsize(latest),
                      "pt": os.path.getsize(path("pdae.pt")),
                      "converted_ckpt": os.path.getsize(path("pdae.ckpt"))},
            "keys_converted": kept, "trees_bit_equal": trees_equal,
            "styles": f"{INGEST_STYLE}/{INGEST_STYLE}", "batch": BATCH, "s": counts["s"],
            "launches": counts["launches"], "launches_expected": want_request,
            "gn_variants": counts["gn_variants"],
            "bit_equal_to_unconverted": bool(np.array_equal(out, served["unconverted"][0]))}
        rec["serve"]["ok"] = bool(
            trees_equal and rec["serve"]["bit_equal_to_unconverted"]
            and out.shape == images.shape and out.dtype == np.uint8
            and counts["launches"] == want_request
            and counts["gn_variants"] == {"cluster": want_request["gn_adagn_silu"],
                                          "general": 0})
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
        drop_ingest_files()
    rec["phase_s"] = time.perf_counter() - phase_t0
    rec["ok"] = bool(backends_ok and rec["dpm_round_trip"]["leaves_bit_equal"]
                     and rec["dpm_round_trip"]["file_bytes_equal"] and rec["train"]["ok"]
                     and rec["decode"]["ok"] and rec["serve"]["ok"])
    return rec


def drop_ingest_files() -> None:
    """Delete the ingest phase's images, LMDB, checkpoints and ``.pt`` files;
    its ``metrics.jsonl`` and ``config.yml`` stay."""
    import shutil

    root = os.path.join(OUT_DIR, "ingest")
    for name in ("images", "lmdb"):
        shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    for parent, _, names in os.walk(root):
        for n in names:
            if n.endswith((".ckpt", ".pt")):
                os.unlink(os.path.join(parent, n))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    script_t0 = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2

    import pdae_torch
    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM, build_classifier, build_latent_denoise_fn
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.ops import _build, groupnorm
    from pdae_torch.data import CELEBAHQ_LABEL_TO_ID
    from pdae_torch.serving import PDAEService
    from pdae_torch.training import (TrainState, make_optimizer,
                                     make_representation_train_step,
                                     trainable_params)
    from pdae_torch.training.state import flat_params
    from pdae_torch.utils import from_uint8, to_uint8

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = pdae_torch.resolve_device()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]

    # 1. build ------------------------------------------------------------
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "Used" in ln or "spill" in ln]
                    for src, log in _build.build_logs.items()}})

    # the models of the path, and the shapes they give the kernels
    decoder, encoder, gen = build_models(args.seed, device)
    dec_counts, enc_counts = path_shapes(decoder, encoder, device)
    per_request = {k: STEPS * 2 * dec_counts[k] + enc_counts[k]
                   for k in set(dec_counts) | set(enc_counts)}
    train_dec, train_enc = path_shapes(decoder, encoder, device, train=True)
    per_step = train_dec + train_enc

    # 2. kernels against their plain versions -------------------------------
    # the forward kernels at the shapes of both paths: the request's (b8) and
    # the train step's (b32)
    both = sorted(set(per_request) | set(per_step))
    launch_floor_ms = device_ms(lambda: groupnorm.launch_empty(device))
    attn_res = {k: check_attention(k[1:], gen, device)
                for k in both if k[0] == "attention"}
    gn_res = {k: check_gn(k, gen, device) for k in both if k[0] == "gn"}
    bwd_res = {k: check_gn_bwd(k, gen, device) for k in both if k[0] == "gn_bwd"}
    edges = check_edges(gen, device)
    # the shapes of the smaller buckets (the batcher's, and the whole path's
    # b2), compared and variant-checked, not timed
    bucket_res = {}
    for b in BUCKETS:
        for k in sorted(set().union(*path_shapes(decoder, encoder, device, batch=b))):
            bucket_res[k] = (check_attention(k[1:], gen, device, timed=False)
                             if k[0] == "attention" else
                             check_gn(k, gen, device, timed=False))
    failed = [(r["shape"], k) for r in list(attn_res.values()) + list(gn_res.values())
              + list(bwd_res.values()) + list(bucket_res.values()) + edges["attention"]
              + edges["gn_adagn_silu"] + edges["gn_adagn_silu_bwd"]
              for k, v in r["err"].items() if not v["ok"]]
    if not edges["gn_misaligned"]["ok"]:
        failed.append(("gn misaligned", "model_float32"))
    failed += [("gn backward misaligned", k) for k, v in edges["gn_bwd_misaligned"].items()
               if not v["ok"]]
    # every GN shape of both paths, forward and backward, must go to the
    # cluster variant, in both dtypes
    not_cluster = [(r["shape"], name) for r in list(gn_res.values()) + list(bwd_res.values())
                   + [v for k, v in bucket_res.items() if k[0] == "gn"]
                   for name, plan in r["variant"].items() if plan["variant"] != "cluster"]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"launch_floor_ms": launch_floor_ms,
                   "attention": list(attn_res.values()),
                   "gn_adagn_silu": list(gn_res.values()),
                   "gn_adagn_silu_bwd": list(bwd_res.values()),
                   "buckets": list(bucket_res.values()),
                   "edges": edges},
                  f, indent=1)
    emit({"phase": "kernels", "tolerances": {f"{k[0]}/{str(k[1])[6:]}": v
                                             for k, v in TOL.items()},
          "launch_floor_ms": launch_floor_ms,
          **{name: [brief(r, per_request.get(k, 0), per_step.get(k, 0))
                    for k, r in results.items()]
             for name, results in (("attention", attn_res), ("gn_adagn_silu", gn_res),
                                   ("gn_adagn_silu_bwd", bwd_res))},
          "buckets": [brief(r, 0, 0) for r in bucket_res.values()],
          "edges": {**{k: [brief(r, 0, 0) for r in edges[k]]
                       for k in ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd")},
                    **{k: v for k, v in edges.items()
                       if k not in ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd")}},
          "gn_path_shapes_not_on_cluster_variant": not_cluster,
          "ok": not failed and not not_cluster})
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")
    if not_cluster:
        raise AssertionError(f"GN path shapes off the cluster variant: {not_cluster}")

    # 3. serving at full width ---------------------------------------------
    config = {"trained_ddpm_config": CELEBA64_DPM,
              "decoder_config": {"latent_dim": LATENT},
              "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
              "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
              "image_size": 64, "max_batch": 64, "latent_config": LATENT_CONFIG,
              "num_classes": NUM_CLASSES,
              "encoder_ddim_style": f"ddim{STEPS}", "decoder_ddim_style": f"ddim{STEPS}"}
    # the latent DPM, the classifier and the latent stats, made from the seed
    torch.manual_seed(args.seed + 3)
    latent = build_latent_denoise_fn(LATENT_CONFIG)
    classifier = build_classifier(NUM_CLASSES, LATENT)
    srs = np.random.RandomState(args.seed + 4)
    stats = ((0.1 * srs.randn(1, LATENT)).astype(np.float32),
             srs.uniform(0.5, 1.5, (1, LATENT)).astype(np.float32))
    service = PDAEService(config, encoder.state_dict(), decoder.state_dict(),
                          latent_state=latent.state_dict(), latent_stats=stats,
                          classifier_state=classifier.state_dict())
    latent = latent.to(device).eval()
    classifier = classifier.to(device)
    images = np.random.RandomState(args.seed).randint(0, 256, (BATCH, 64, 64, 3),
                                                      np.uint8)
    want_enc = launches_of(0, 1, dec_counts, enc_counts)
    want_ae = launches_of(2 * STEPS, 1, dec_counts, enc_counts)

    service.autoencode(images, "ddim5", "ddim5")          # warm-up, not counted
    z, enc = counted(lambda: service.encode(images))
    if z.shape != (BATCH, LATENT) or z.dtype != np.float32 or not np.isfinite(z).all():
        raise AssertionError(f"encode gave {z.shape} {z.dtype}, finite={np.isfinite(z).all()}")
    recon, ae = counted(lambda: service.autoencode(images))
    ae_launches = ae["launches"]
    if recon.shape != images.shape or recon.dtype != np.uint8:
        raise AssertionError(f"autoencode gave {recon.shape} {recon.dtype}")
    emit({"phase": "serving", "batch": BATCH, "styles": f"ddim{STEPS}/ddim{STEPS}",
          "encode_s": enc["s"], "autoencode_s": ae["s"],
          "autoencode_imgs_per_s": BATCH / ae["s"], "peak_mem_gb": ae["peak_mem_gb"],
          "encode_launches": enc["launches"], "encode_launches_expected": want_enc,
          "autoencode_launches": ae_launches, "autoencode_launches_expected": want_ae,
          "encode_gn_variants": enc["gn_variants"],
          "autoencode_gn_variants": ae["gn_variants"]})
    if enc["launches"] != want_enc or ae_launches != want_ae:
        raise AssertionError("the launch counters do not match the path's structure")
    for variants, want in ((enc["gn_variants"], want_enc), (ae["gn_variants"], want_ae)):
        if variants != {"cluster": want["gn_adagn_silu"], "general": 0}:
            raise AssertionError(f"GN launches off the cluster variant: {variants}")

    # 4. the other ops of the service ------------------------------------------
    op_records = serving_ops(service, images, dec_counts, enc_counts, args.seed)
    ops_ok = all(r["ok"] for k, r in op_records.items() if k != "steps")
    emit({"phase": "serving_ops", "batch": BATCH, **op_records, "ok": ops_ok})
    if not ops_ok:
        raise AssertionError("an op of the service failed its checks")

    # 5. the representation-learning train step at full width ----------------
    gd = GaussianDiffusion(config["diffusion_config"])
    params = trainable_params(encoder, decoder)
    optimizer = make_optimizer({"name": "Adam", "lr": 1e-4}, flat_params(params))
    state = TrainState.create(params, optimizer)
    train_step = make_representation_train_step(gd, encoder, decoder, optimizer)
    start = {g: {k: p.detach().clone() for k, p in group.items()}
             for g, group in params.items()}
    frozen_start = {k: v.detach().clone() for k, v in decoder.state_dict().items()
                    if k not in params["shift"]}
    train_gen = torch.Generator(device=device).manual_seed(args.seed)
    rs = np.random.RandomState(args.seed + 2)
    want_step = {
        "attention": sum(v for k, v in per_step.items() if k[0] == "attention"),
        "gn_adagn_silu": sum(v for k, v in per_step.items() if k[0] == "gn"),
        "gn_adagn_silu_bwd": sum(v for k, v in per_step.items() if k[0] == "gn_bwd")}

    def batch_of_images():
        u8 = rs.randint(0, 256, (TRAIN_BATCH, 64, 64, 3), np.uint8)
        return torch.from_numpy(from_uint8(u8)).to(device).permute(0, 3, 1, 2).contiguous()

    losses, step_launches, step_variants, step_bwd_variants, step_s = [], [], [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(1 + TRAIN_STEPS):                     # the first is the warm-up
        x_0 = batch_of_images()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_step(state, x_0, train_gen)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        step_launches.append(ops.launch_counts())
        step_variants.append(ops.gn_variant_counts())
        step_bwd_variants.append(ops.gn_bwd_variant_counts())
        losses.append(float(loss))
    train_launches = step_launches[-1]
    mean_step_s = sum(step_s[1:]) / TRAIN_STEPS
    stuck = [f"{g}.{k}" for g, group in params.items() for k, p in group.items()
             if torch.equal(p, start[g][k])]
    bad_grad = [f"{g}.{k}" for g, group in params.items() for k, p in group.items()
                if p.grad is None or not torch.isfinite(p.grad).all()]
    now = decoder.state_dict()
    thawed = [k for k, v in frozen_start.items() if not torch.equal(now[k], v)]
    ema_still = [f"{g}.{k}" for g, group in state.ema_params.items()
                 for k, e in group.items() if torch.equal(e, start[g][k])]
    # at decay 0.9999 a step moves the EMA by 1e-4 of the parameter's own
    # move: a tensor of ones (a GroupNorm weight) can stay inside one fp32
    # rounding step for these few steps, so most, not all, must have moved
    leaves = flat_params(params)
    ema_finite = all(bool(torch.isfinite(e).all()) for e in flat_params(state.ema_params))
    train_ok = (all(math.isfinite(v) for v in losses)
                and all(c == want_step for c in step_launches)
                and all(v == {"cluster": want_step["gn_adagn_silu"], "general": 0}
                        for v in step_variants)
                and all(v == {"cluster": want_step["gn_adagn_silu_bwd"], "general": 0}
                        for v in step_bwd_variants)
                and not stuck and not bad_grad and not thawed
                and 2 * len(ema_still) < len(leaves) and ema_finite
                and state.step == 1 + TRAIN_STEPS)
    train_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit({"phase": "train", "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
          "optimizer": "Adam lr 1e-4", "dtype": "float32, TF32 off",
          "losses": losses, "step_s": step_s[1:], "warmup_step_s": step_s[0],
          "mean_step_s": mean_step_s, "imgs_per_s": TRAIN_BATCH / mean_step_s,
          "peak_mem_gb": train_peak_gb,
          "launches_per_step": train_launches, "launches_expected": want_step,
          "gn_variants_per_step": step_variants[-1],
          "gn_bwd_variants_per_step": step_bwd_variants,
          "trainable_tensors": sum(len(g) for g in params.values()),
          "frozen_tensors": len(frozen_start),
          "params_not_moved": stuck[:5], "grads_missing_or_not_finite": bad_grad[:5],
          "frozen_changed": thawed[:5], "ema_tensors_not_moved": len(ema_still),
          "ok": train_ok})
    if not train_ok:
        raise AssertionError("the train phase failed its checks")

    # 6. whole path: kernels against plain versions on the card ---------------
    rs = np.random.RandomState(args.seed + 1)
    x = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32)).to(device)
    t = torch.tensor([10, 500], dtype=torch.int32, device=device)
    zz = torch.from_numpy(rs.randn(2, LATENT).astype(np.float32)).to(device)
    with torch.inference_mode():
        eps_k, g_k = decoder(x, t, zz)
        ops.set_use_kernels(False)
        try:
            eps_p, g_p = decoder(x, t, zz)
            small = images[:2]
            recon_p = service.autoencode(small, "ddim5", "ddim5")
        finally:
            ops.set_use_kernels(None)
        recon_k = service.autoencode(small, "ddim5", "ddim5")
    scale = float(max(eps_p.abs().max(), g_p.abs().max()))
    atol, rtol = WHOLE_PATH_TOL
    res = {"eps": compare(eps_k, eps_p, (atol * max(1.0, scale), rtol)),
           "gradient": compare(g_k, g_p, (atol * max(1.0, scale), rtol)),
           "autoencode_ddim5_max_uint8_diff": int(np.abs(
               recon_k.astype(int) - recon_p.astype(int)).max())}

    # one train step's loss and gradients, kernels against plain versions,
    # from the same state, t and noise (no update: the loss function alone)
    x_0 = torch.from_numpy(from_uint8(images[:2])).to(device).permute(0, 3, 1, 2).contiguous()
    noise = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32)).to(device)
    names = [f"{g}.{k}" for g, group in params.items() for k in group]

    def loss_and_grads():
        loss = gd.representation_learning_train_one_batch(
            None, encoder, decoder, x_0, t=t, noise=noise)["prediction_loss"]
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_k, grads_k = loss_and_grads()
    ops.set_use_kernels(False)
    try:
        loss_p, grads_p = loss_and_grads()
    finally:
        ops.set_use_kernels(None)
    sizes = {n: float(b.abs().max()) for n, b in zip(names, grads_p)}
    grad_cmp = {n: compare(a, b, (TRAIN_GRAD_TOL[0] * sizes[n], TRAIN_GRAD_TOL[1]))
                for n, a, b in zip(names, grads_k, grads_p)}
    # the worst tensor by its error beside its own largest plain gradient
    worst = max(grad_cmp, key=lambda n: grad_cmp[n]["max_abs_err"] / max(sizes[n], 1e-30))
    smallest = min(sizes, key=sizes.get)
    res["train_step"] = {
        "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
        "loss_rel_err": abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
        "grads_compared": len(grad_cmp),
        "grads_failed": [n for n, v in grad_cmp.items() if not v["ok"]][:5],
        "worst_grad": {"name": worst, "max_plain_grad": sizes[worst],
                       **grad_cmp[worst]},
        "smallest_grad": {"name": smallest, "max_plain_grad": sizes[smallest],
                          **grad_cmp[smallest]},
        "max_plain_grad": max(sizes.values())}
    train_cmp_ok = (res["train_step"]["loss_rel_err"] <= TRAIN_LOSS_RTOL
                    and not res["train_step"]["grads_failed"]
                    and sizes[smallest] > 0.0)

    # the latent DPM's sampler, manipulate, a dpm5/dpm5 autoencode and a
    # trajectory interpolation, kernels against plain versions at b2, each
    # as the service composes it, on the service's own models (the train
    # phase has moved the script's) and input tensor: within one uint8
    # level. A few-step trajectory can carry a rounding-size difference
    # further (the dpm5/dpm5 autoencode does, at these random weights), so the
    # control measures how far: the plain path against itself with every
    # decoder output moved by relative noise of the size that one forward of
    # the kernels differs by (eps above), three seeded draws. An op passes
    # within the larger of one level and the control's largest difference,
    # and its kernel path must repeat bit for bit.
    z_T = torch.from_numpy(rs.randn(2, LATENT).astype(np.float32)).to(device)
    x_T = torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32)).to(device)
    x_s, _ = service._to_model_input(images[:2])
    mean, std = (torch.from_numpy(a).to(device) for a in stats)
    weight = classifier.weight.detach().to(device)
    rho = res["eps"]["max_abs_err"] / scale

    encoder, decoder = service.encoder, service.decoder

    def perturbed(draw):
        g = torch.Generator(device=device).manual_seed(args.seed + draw)

        def dec(x, t, z):
            return tuple(o * (1.0 + rho * torch.randn(o.shape, generator=g, device=device))
                         for o in decoder(x, t, z))
        return dec

    def new_ops(dec):
        x_0 = x_s
        with torch.inference_mode():
            inferred = gd.representation_learning_ddim_encode("ddim5", encoder, dec, x_0)
            return {k: v.permute(0, 2, 3, 1).cpu().numpy() for k, v in {
                "latent_diffusion_sample_ddim5": gd.latent_diffusion_sample(
                    None, "ddim5", "ddim5", latent, dec, x_T, mean, std,
                    latent_dim=LATENT, z_T=z_T),
                "manipulate_ddim5": gd.manipulation_sample(
                    "ddim5", weight, encoder, dec, x_0, inferred, mean, std,
                    CELEBAHQ_LABEL_TO_ID["Smiling"], 0.3),
                "autoencode_dpm5": gd.representation_learning_autoencoding(
                    "dpm5", "dpm5", encoder, dec, x_0),
                "interpolation_ddim5": gd.representation_learning_ddim_trajectory_interpolation(
                    "ddim5", dec, encoder(x_0), encoder(x_0.flip(0)), x_T, 0.5),
            }.items()}

    def differ(a, b):
        levels = np.abs(to_uint8(a).astype(int) - to_uint8(b).astype(int))
        return {"max_uint8_diff": int(levels.max()), "pixels_over_1": int((levels > 1).sum()),
                "max_abs_err": float(np.abs(a - b).max())}

    kernel_out, kernel_again = new_ops(decoder), new_ops(decoder)
    ops.set_use_kernels(False)
    try:
        plain_out = new_ops(decoder)
        controls = [new_ops(perturbed(draw)) for draw in range(3)]
    finally:
        ops.set_use_kernels(None)
    res["ops"] = {k: {"kernels_vs_plain": differ(kernel_out[k], plain_out[k]),
                      "kernels_repeat_bit_equal": bool(np.array_equal(kernel_out[k],
                                                                      kernel_again[k])),
                      "control": [differ(c[k], plain_out[k]) for c in controls]}
                  for k in kernel_out}
    res["control_relative_noise"] = rho
    for v in res["ops"].values():
        v["bound_uint8"] = max(1, max(c["max_uint8_diff"] for c in v["control"]))
    ops_agree = all(v["kernels_vs_plain"]["max_uint8_diff"] <= v["bound_uint8"]
                    and v["kernels_repeat_bit_equal"] for v in res["ops"].values())
    ok = res["eps"]["ok"] and res["gradient"]["ok"] and train_cmp_ok and \
        res["autoencode_ddim5_max_uint8_diff"] <= 1 and ops_agree
    emit({"phase": "whole_path", "batch": 2, **res, "ok": ok})
    if not ok:
        raise AssertionError("the kernel path disagrees with the plain path")

    # 7. the representation-learning trainer at full width ---------------------
    trainer = trainer_phase(args.seed, device, want_step,
                            launches_of(STEPS, 1, dec_counts, enc_counts), mean_step_s)
    emit({"phase": "trainer", **trainer})
    if not trainer["ok"]:
        raise AssertionError("the trainer phase failed its checks")

    # 8. the sampler suite and the service built from the trainer's files -----
    compared = set(both) | set(bucket_res)
    samplers = samplers_phase(args.seed, device, dec_counts, enc_counts,
                              res["control_relative_noise"], compared)
    emit({"phase": "samplers", **samplers})
    if not samplers["ok"]:
        raise AssertionError("the samplers phase failed its checks")

    # 9. LPIPS, InceptionV3, FID and two ranks on one card ----------------------
    metrics = metrics_phase(args.seed, device, dec_counts, enc_counts, samplers, compared)
    emit({"phase": "metrics", **metrics})
    if not metrics["ok"]:
        raise AssertionError("the metrics phase failed its checks")

    # 10. the regular, latent and manipulation trainers -----------------------
    trainer_dir = os.path.join(OUT_DIR, "trainer")
    samplers_dir = os.path.join(OUT_DIR, "samplers")
    stages = stages_phase(args.seed, device, {"celeba64": {
        "config": os.path.join(trainer_dir, "a", "config.yml"),
        "checkpoint": os.path.join(trainer_dir, "a", "checkpoints", "latest.ckpt"),
        "stats": os.path.join(samplers_dir, "synthetic.ckpt"),
        "dpm_config": os.path.join(samplers_dir, "dpm.yml")}}, compared,
        {**attn_res, **gn_res, **bwd_res})
    emit({"phase": "stages", **stages})
    if not stages["ok"]:
        raise AssertionError("the stages phase failed its checks")

    # 11. bf16 compute and rematerialisation at full width --------------------
    precision = precision_phase(args.seed, device, compared, want_step, {
        "representation": {"mean_step_s": mean_step_s, "peak_mem_gb": train_peak_gb,
                           "of": "train phase"},
        "regular": {"mean_step_s": stages["regular"]["mean_step_s"],
                    "peak_mem_gb": stages["regular"]["peak_mem_gb"], "of": "stages phase"}})
    emit({"phase": "precision", **precision})
    if not precision["ok"]:
        raise AssertionError("the precision phase failed its checks")

    # 12. the files a user brings: images, the reference's .pt, the trainer ---
    ingest = ingest_phase(args.seed, device, want_step,
                          launches_of(2 * int(INGEST_STYLE[len("ddim"):]), 1, dec_counts,
                                      enc_counts), trainer["trainer_step_s"])
    emit({"phase": "ingest", **ingest})
    if not ingest["ok"]:
        raise AssertionError("the ingest phase failed its checks")
    emit({"script_s": time.perf_counter() - script_t0})

    per_op = {name: op_records[name]["launches"]
              for name in ("generate", "manipulate", "autoencode_dpm20")}
    per_op["trainer_step"] = trainer["launches_per_step"]
    per_op["trainer_eval"] = trainer["eval_launches"]
    per_op.update({f"sampler_{k}": v["launches"] for k, v in samplers.items()
                   if isinstance(v, dict) and "launches" in v})
    per_op.update({f"from_config_{k}": v["launches"]
                   for k, v in samplers["from_config"].items() if isinstance(v, dict)})
    per_op.update({f"metrics_{k}": metrics[k]["launches"]
                   for k in ("autoencoding_eval_lpips", "unconditional_sample_fid")})
    for stage in ("regular", "latent", "manipulation"):
        per_op[f"{stage}_step"] = stages[stage]["launches_per_step"]
        per_op[f"{stage}_eval"] = stages[stage]["eval_launches"]
        if "precomputed" in stages[stage]:
            per_op[f"{stage}_precomputed_step"] = stages[stage]["precomputed"][
                "launches_per_step"]
    per_op["ingest_step"] = ingest["train"]["launches_per_step"]
    per_op[f"ingest_autoencode_{INGEST_STYLE}"] = ingest["serve"]["launches"]
    regular_ms = stages["regular"]["kernel_ms_per_step"]
    emit({"kernels": [
        {**summarise("attention", "pdae_torch/csrc/attention.cu",
                     "pdae_tpu/ops/attention.py:40", attn_res, per_request, per_step,
                     ae_launches["attention"], train_launches["attention"]),
         "launches_per_op": {k: v["attention"] for k, v in per_op.items()},
         "regular_step": regular_ms["attention"]},
        {**summarise("gn_adagn_silu", "pdae_torch/csrc/groupnorm.cu",
                     "pdae_tpu/ops/groupnorm.py:55", gn_res, per_request, per_step,
                     ae_launches["gn_adagn_silu"], train_launches["gn_adagn_silu"]),
         "launches_per_op": {k: v["gn_adagn_silu"] for k, v in per_op.items()},
         "regular_step": regular_ms["gn_adagn_silu"]},
        {**summarise("gn_adagn_silu_bwd", "pdae_torch/csrc/groupnorm_bwd.cu",
                     "pdae_tpu/ops/groupnorm_train.py:196", bwd_res, per_step, per_step,
                     train_launches["gn_adagn_silu_bwd"],
                     train_launches["gn_adagn_silu_bwd"],
                     per=f"one b{TRAIN_BATCH} train step (sum over its launches)"),
         "launches_per_op": {k: per_op[k]["gn_adagn_silu_bwd"]
                             for k in ("trainer_step", "regular_step", "ingest_step")},
         "regular_step": regular_ms["gn_adagn_silu_bwd"]},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        # a rank of the metrics phase's two-process run: it leaves the
        # files to the phase that started it
        sys.exit(rank_worker(*sys.argv[2:4]))
    try:
        code = main()
    finally:
        drop_heavy_files()
    sys.exit(code)
