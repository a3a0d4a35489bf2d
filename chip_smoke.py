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
   small shapes. The split passes of spatial parallelism (``check_split``:
   the GN stats and apply passes, the backward's moments and dx passes, and
   the attention of a rank's query rows against every key) are held to
   their plain versions in fp32 and bf16 at every local shape the sp phase's
   runs give them, and timed in fp32 at the b32 train step's with their
   bound and a library call's time; the apply pass on the fused kernel's
   saved stats, and the ``Tq < Tk`` attention against the same rows of the
   ``Tq = Tk`` launch, are held bit for bit. The checks draw their inputs on
   the card. Every comparison in full
   goes to ``chiprun_out/chip_smoke_kernels.json``.
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
   the seed: ``generate`` b8 ddim50/ddim50, ``manipulate`` b8
   (``attribute="Smiling"``, scale 0.3) at ddim50/ddim50, ``autoencode``
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
   once at ddim5 styles, ``gap_measure`` and ``autoencoding_example``
   (whose DDPM row runs every step) under a 50-step schedule, each PNG of
   its layout's size, and ``denoise_one_step`` once more through
   ``python -m pdae_torch.sample`` (a process that runs beside them). Each run's model calls and kernel
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
   with ``fid`` (32 samples, b32, ddim10/ddim10, against the features of
   2,560 SYNTHETIC images), each run's model calls and kernel launches held
   to the structure and every new kernel shape to the plain versions
   (``chiprun_out/chip_smoke_metrics_shapes.json``); and ``AutoencodingEval``
   (with LPIPS) and ``InferLatents`` again as two ranks on the one card
   (``python3 chip_smoke.py --rank-worker``, gloo for the objects; started
   after the first ``AutoencodingEval``, beside the rest of the phase), each
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
   the eval at 6, each at ddim10: an 8-image grid, a latent sample of 8, a
   manipulation (the trainers' defaults: ddim100, ddim100/ddim100,
   ddim500/ddim200)), run B resumed from A's step-3 file to 6 and bit-equal to
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
   state, t and noise (``cudnn.deterministic``): one warm-up and 1 timed
   step, the launches against ``remat_structure``, the modes' losses and
   first gradients bit-equal (or each within REMAT_GRAD_TOL of its tensor's
   largest), seconds and peak memory printed. Every kernel key these runs
   give that no earlier phase compared is held to the plain versions in fp32
   and bf16 on the cluster variant, the 128x128 GN keys timed
   (``chiprun_out/chip_smoke_precision_shapes.json``). The kernels phase
   times every timed shape in bf16 too (``bf16_ms``, ``bf16_library_ms``,
   ``bf16_bound_ms``; bf16 attention's bound on the tensor cores' 989
   TFLOP/s), and the summary sums them over a train step.
12. ``ingest``: the files a user brings, through the port's CLIs and the
   native host code. 64 seeded JPEGs at CelebA's 178x218 (quality 95) packed
   by ``python -m pdae_torch.prepare_lmdb --key-format 'None-%07d'``; the
   trainer phase's DPM exported to a reference ``.pt`` by ``python -m
   pdae_torch.convert --export`` (beside the packing) and converted back,
   bit-equal on every leaf and byte-equal as a file; the celeba64 ``RepresentationLearningTrainer``
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
   deleted when it ends.
13. ``dispatch``: ``runner_config.steps_per_dispatch`` at each shipped
   config's own K, a chunk of steps replayed from one captured CUDA graph
   (``pdae_torch/training/dispatch.py``): the trainer phase's representation
   config in fp32 and bf16 (b32, K=4, host-loaded), the stages phase's
   ``dpm_celeba64`` (b32, K=4), ``celeba64_latent`` (b128, K=50, resident,
   ``encode``) and ``celebahq_manipulation`` (b128, K=50, resident) dicts,
   and the precision phase's FFHQ128 representation config under ``remat:
   skips`` (b32, fp32). Each is trained by an eager K=1 trainer and by graph
   trainers from the same seed: one to step 3, where it saves (off a chunk
   boundary), and one resumed from that file to 9 (K=4) or 103 (K=50); the
   bf16 step straight to 9, the FFHQ128 step to 3. Every step's loss, and at
   the end every param, EMA tensor, Adam moment and the count, must be
   bit-equal (``cudnn.deterministic``; of the FFHQ128 step, whose eager runs
   are not bit-reproducible in this process from step 3, the losses, and
   its final state is recorded); the launches a capture counted, times the
   replays, must equal the structure's per step, every GN launch on the
   cluster variant. Wall ms per step over a whole chunk, and busy ms and the
   idle share of one more step under ``torch.profiler``, graph against
   eager, and each path's peak memory
   (``chiprun_out/chip_smoke_dispatch.json``). Last, the representation
   config's first chunk (K=4) once more with ``runner_config.profile_dir``:
   the eager warm-up, the capture into the graph and three replays under
   the trainer's profiler; its losses bit-equal to the unprofiled graph
   run's, one trace written, and in it each kernel's device events (by its
   ``csrc/`` name) as many as the run launched on the card: every replay's
   exactly, the eager warm-up step's at most one short a kernel (the
   profiler sometimes leaves one of that step's kernel records out; the
   record counts it as ``lost``).
14. ``ddp``: data-parallel training (``param_sharding: replicated``). The
   trainer phase's celeba64 PDAE config at full width (b32 a rank, fp32,
   TF32 off, ``cudnn.deterministic``, Adam eps 1e-5) as two ranks on the one
   card (``python3 chip_smoke.py --ddp-worker``, both ``LOCAL_RANK`` 0: NCCL
   refuses two ranks on one device, so their tensor group is gloo and the
   run eager): 3 steps saved at 2, then a fresh pair resumed from that file
   to 3. Against it one process (b64) over the same 64 rows in the ranks'
   order, after the ranks have left the card: every loss within
   ``DDP_TOL["loss_rel"]``, the last reduced gradients, params, EMA and Adam
   moments within their ``DDP_TOL``; the ranks' states and losses bit-equal
   (digests), the resume bit-equal, only rank 0 writing, each rank's launches
   the structure's per step, wall ms per step at both world sizes and of the
   gloo all-reduce of the gradients alone. Then the
   same config at its shipped K=4 from the captured graph, 8 steps, in a
   process with an NCCL tensor group of one rank and in one with no group,
   side by side on the card:
   every loss and the final state bit-equal, the launches per replay the
   structure's; recorded: wall ms per step of each chunk, two more traced
   replays of each (busy ms, kernels, NCCL kernels, the costliest kernels)
   and the eager all-reduce's ms (``chiprun_out/chip_smoke_ddp.json``). The
   two-rank and the NCCL processes then make the fsdp phase's runs, the NCCL
   process once the other has left the card (cuDNN filters its algorithms
   by the card's free memory: a run held bit for bit against these has at
   least the memory they had).
15. ``fsdp``: ``param_sharding: fsdp`` (``pdae_torch/training/fsdp.py``) on
   the ddp phase's config, run by the ddp phase's processes after their own
   runs. Two ranks on the one card over gloo, eager, b32 a
   rank, with ``checkpoint_format: sharded``: 3 steps with the sharded save
   at 2, and a fresh pair resumed from that directory to 3. Every loss and
   the final state gathered from the ranks' blocks (params, EMA, moments and
   the reduced gradients) bit-equal to the ddp phase's two ranks, the resume
   bit-equal, the directory exactly the manifest and the two step-tagged
   shard files, each rank's launches the structure's per step, and the bytes
   a rank holds between steps (EMA, moments, the blocks of the trained
   tensors and of the frozen trunk: blocks at rest, gathered per use) within
   2% of ``pdae_tpu``'s layout. Then the same config at K=4 from the
   captured graph with an NCCL group of one rank: every loss and the final
   state bit-equal to the ddp phase's K=4 runs, the launches per replay the
   structure's, and in the trace of two replays one copy per gather the
   captured step made plus the reduce-scatter's (at world 1 NCCL runs each
   as one copy on the card), beyond the replicated step's copies.
   Recorded: each rank's bytes of state beside ``replicated``'s and the
   layout's before blocks at rest, the plan's buffers, the device memory
   between steps and the peak beside the ddp phase's ``replicated`` ranks',
   the gathers a step, the sharded write's seconds and bytes, the
   collectives' ms over gloo and NCCL, ms per step
   (``chiprun_out/chip_smoke_fsdp.json``).
16. ``tp``: tensor parallelism (``pdae_torch/parallel/tp.py``). The ddp
   phase's two processes, after their fsdp runs, train its config at tp 2
   (b32, 1 step, gloo through the host): the losses and the gathered state
   against one process over the same rows within ``DDP_TOL``, the ranks
   bit-equal, each rank's launches the structure's per step and every
   launch's input at the rank's local shape (``tp_local_keys``: the
   attention on half the heads, GN on half the channels with 16 groups;
   the kernels phase holds every such shape to the plain versions); then
   ``PDAEService(tp_size=2)``'s b8 ddim1/ddim1 autoencode against the
   one-process service within the larger of one uint8 level and the
   whole-path phase's control. Four processes of their own, started with the
   ddp phase and released when the two ranks' train run ends (they share
   the card with the service run), run ``fsdp+tp`` (tp 2 x data 2, b8 a data
   rank, 1 step) against one process over the 16 rows, and, after the ddp
   phase's graph runs and their ``fsdp+sp`` run, ``fsdp`` under
   ``mesh_layout: hier`` on a ``[2, 2]`` grid (b8 a rank, 1 step) against
   one process over the 32 rows, each rank's launches the structure's. The
   ddp phase's NCCL process runs the tp path at ``tp_size`` 1 from
   the captured graph (K=4), bit-equal to the ``replicated`` K=4 run.
   Recorded per rank: bytes of parameters (trained and frozen), EMA and
   moments beside ``replicated``'s, peak memory, ms per step
   (``chiprun_out/chip_smoke_tp.json``).
17. ``sp``: spatial parallelism (``pdae_torch/parallel/sp.py``). The ddp
   phase's two processes, after their tp runs, serve
   ``PDAEService(sp_size=2)``'s b8 and b1 ddim1/ddim1 autoencodes (while
   the four processes below hold the card) against the one-process service
   within the larger of one uint8 level and the whole-path phase's control,
   then train its config at sp 2 (every image's rows split over the two
   ranks, b32, ``SP_STEPS`` steps, gloo through the host): the losses and
   the state against the tp phase's one process over the same rows within
   ``DDP_TOL``, the ranks bit-equal, each rank's launches those of
   ``sp_local_keys`` per step (the GN chains as the stats and apply passes
   and, backward, the moments and dx passes; no launch of the fused GN
   kernels) and every launch's input at the rank's local shape (the
   attention's queries half the keys); the service's launches and inputs
   are held likewise. The
   tp phase's four processes, after the ddp phase's graph runs, run
   ``fsdp+sp`` (sp 2 x data 2, b8 a data rank, 1 step) against the tp phase's one
   process over the 16 rows. Recorded per rank: the sp collectives' count,
   bytes and ms per step, ms per step, parameter bytes and peak memory
   beside one process's (``chiprun_out/chip_smoke_sp.json``).
18. ``headline``: the reference-headline program, ``python -m
   pdae_torch.headline_eval``'s ``main`` in this process at FFHQ128 width
   (ShiftUNet ``FFHQ128_DPM`` + the 128px encoder, latent 512, bf16): 4
   train steps at b32 (the tool's 300 cut), then ``ddim1000+ddim100`` (1,099
   evaluations) and ``dpm20+dpm20`` over one b16 batch of textured SYNTHETIC
   images, one rep; the tool's JSON printed on its own line and held (its
   keys, finite losses, 0 < SSIM <= 1, the peak memory). The launches per
   evaluation, per encoder pass, per train step and per style's batch,
   each held to the models' structure (GN on the cluster variant); every
   kernel key the run gives that no earlier phase compared held to the
   plain versions in fp32 and bf16, its b16 eval keys timed
   (``chiprun_out/chip_smoke_headline_shapes.json``); the
   ``dpm20+dpm20`` roundtrip of the batch through the kernels against the
   plain versions
   within ``PRECISION_RATIO`` times the plain path's own bf16-against-fp32
   gap. Then the script's total seconds.

Then a ``{"kernels": [...]}`` summary line (the split passes each as a kernel
of its own, their times summed over one sp rank's train step; the attention's
``Tq < Tk`` launches under ``sp_train_step``), the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` prints them,
and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import os
import signal
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
OPS_STYLE = "ddim50"             # serving_ops' generate and manipulate (a depth cut)
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


FUSED_KERNELS = ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd")
NHWC_COUNTS = ("gn_adagn_silu_nhwc", "gn_adagn_silu_bwd_nhwc")   # parts of the above


def traced_saves(since_ns: int) -> list:
    """``[loop's seconds, background write's seconds or None]`` of each
    checkpoint save begun after ``since_ns`` (``time.time_ns()``): the
    ``pdae.train.save`` spans of ``pdae_torch.tracing``, each with the next
    ``pdae.train.save_write`` of its step (the script and its workers record
    spans from their start, ``tracing.enable()``)."""
    from pdae_torch import tracing
    spans = [s for s in tracing.spans() if s.start_ns >= since_ns]
    writes = [s for s in spans if s.name == "pdae.train.save_write"]
    out = []
    for s in spans:
        if s.name == "pdae.train.save":
            w = next((w for w in writes if w.key == s.key and w.start_ns >= s.start_ns), None)
            if w is not None:
                writes.remove(w)
            out.append([s.seconds, None if w is None else w.seconds])
    return out


def named_launches(counts=None) -> dict:
    """``ops.launch_counts()`` (or ``counts``, a graph's) as the checks name
    the kernels: the three fused kernels always, a split pass of the GN
    kernels where it launched. The paths before the sp phase expect the
    fused kernels alone, so a split pass launched there shows as a key they
    do not expect. The NHWC variants' counts are parts of the fused kernels'
    and are checked by variant (``gn_on``)."""
    from pdae_torch import ops

    counts = ops.launch_counts() if counts is None else counts
    return {k: n for k, n in counts.items()
            if k in FUSED_KERNELS or (n and k not in NHWC_COUNTS)}


def gn_on(n: int, nhwc: bool = False) -> dict:
    """GN launch counts by variant where all ``n`` took the variant of their
    path's layout: the cluster variant in the NCHW (fp32) models, the NHWC
    one in the channels-last (bf16) ones."""
    return {"cluster": 0 if nhwc else n, "general": 0, "nhwc": n if nhwc else 0}


_STARTED = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's record gets ``at_s``, the script's seconds
    when it ended."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _STARTED}
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
    eval mode, with seeded random weights."""
    from pdae_torch.models import CELEBA64_DPM, ShiftUNet, encoder_for_resolution

    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM)
    encoder = encoder_for_resolution(64, LATENT)
    perturb_zero_params(decoder, gen)
    perturb_zero_params(encoder, gen)
    return decoder.to(device).eval(), encoder.to(device).eval()


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
    groups = key[7] if len(key) > 7 else 32     # a tp rank's chain: its groups
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "err": {}, "variant": {}}
    if groups != 32:
        res["groups"] = groups
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


def ffhq128_bf16_models(seed, device):
    """The bf16 FFHQ128 ShiftUNet and 128px encoder (``FFHQ_DPM``, latent
    ``LATENT``) on ``device`` in train mode, with seeded random weights and no
    silent branch."""
    from pdae_torch.models import ShiftUNet, encoder_for_resolution

    torch.manual_seed(seed)
    decoder = ShiftUNet(latent_dim=LATENT, dtype=torch.bfloat16, **FFHQ_DPM)
    encoder = encoder_for_resolution(128, LATENT, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed + 23)
    for model in (decoder, encoder):
        perturb_zero_params(model, gen)
    return encoder.to(device), decoder.to(device)


def ffhq128_bf16_step(encoder, decoder, batch, device, seed):
    """One bf16 FFHQ128 representation loss and its backward at ``batch``
    (eager), the fn a caller runs, records or profiles."""
    from pdae_torch.diffusion import GaussianDiffusion

    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    gen = torch.Generator(device=device).manual_seed(seed)
    x_0 = torch.rand(batch, 3, 128, 128, device=device, generator=gen) * 2 - 1
    t = torch.randint(0, 1000, (batch,), generator=gen, device=device, dtype=torch.int32)
    noise = torch.randn(x_0.shape, generator=gen, device=device)
    leaves = [p for m in (encoder, decoder) for p in m.parameters() if p.requires_grad]

    def step():
        loss = gd.representation_learning_train_one_batch(
            None, encoder, decoder, x_0, t=t, noise=noise)["prediction_loss"]
        return torch.autograd.grad(loss, leaves)
    return step


def nhwc_gn_keys(step):
    """The GN kernel calls of ``step``: forward keys ``("gn", *shape, AdaGN,
    z)`` and backward keys ``("gn_bwd", *shape, AdaGN, z, dx)``, each with its
    count and the layouts its inputs came in."""
    from pdae_torch.ops import groupnorm, groupnorm_train

    fwd, bwd, layouts = collections.Counter(), collections.Counter(), collections.Counter()
    gn, gn_bwd = groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda

    def rec_fwd(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None, *a, **k):
        fwd[("gn", *x.shape, scale is not None, z_scale is not None)] += 1
        layouts[groupnorm.memory_layout(x)] += 1
        return gn(x, gamma, beta, scale, shift, z_scale, z_shift, *a, **k)

    def rec_bwd(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                z_shift=None, groups=32, need_dx=True):
        bwd[("gn_bwd", *x.shape, scale is not None, z_scale is not None, need_dx)] += 1
        layouts[groupnorm.memory_layout(x)] += 1
        return gn_bwd(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift, groups,
                      need_dx)

    groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda = rec_fwd, rec_bwd
    try:
        step()
        torch.cuda.synchronize()
    finally:
        groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda = gn, gn_bwd
    return fwd, bwd, layouts


def check_nhwc_gn(key, gen, device, timed=True):
    """The NHWC forward variant against the plain version at one bf16 shape
    (channels-last inputs), and its stats; timed beside its bytes bound, the
    plain version, the NCHW cluster variant on the same values and
    ``group_norm`` (``library_ms``, on the channels-last input)."""
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm

    shape, has_st, has_z = key[1:5], key[5], key[6]
    dtype = torch.bfloat16
    x, gamma, beta, *coef = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
    cl = x.contiguous(memory_format=torch.channels_last)
    before = groupnorm.variant_launches["nhwc"]
    got, mean, rstd = groupnorm.gn_cuda(cl, gamma, beta, *coef, save_stats=True)
    torch.cuda.synchronize()
    want, mean_w, rstd_w = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, return_stats=True)
    res = {"shape": list(shape), "adagn": has_st, "z": has_z,
           "plan": groupnorm.nhwc_plan_for(cl, got, 32)._asdict(),
           "served_nhwc": groupnorm.variant_launches["nhwc"] == before + 1
           and got.is_contiguous(memory_format=torch.channels_last),
           "err": {"model": compare(got, want, TOL[("gn_model", dtype)]),
                   "mean": compare(mean, mean_w, (1e-5, 1e-5)),
                   "rstd": compare(rstd, rstd_w, (1e-5, 1e-4))}}
    if timed:
        lib = (cl, gamma.to(dtype), beta.to(dtype), *coef)
        res.update(ms=device_ms(lambda: groupnorm.gn_cuda(cl, gamma, beta, *coef)),
                   nchw_ms=device_ms(lambda: groupnorm.gn_cuda(x, gamma, beta, *coef)),
                   plain_ms=device_ms(lambda: ops.gn_adagn_silu_fwd(cl, gamma, beta, *coef)),
                   library_ms=device_ms(lambda: library_gn(*lib, 32)))
        res["bytes"] = (2 * x.numel() * x.element_size() + 8 * shape[1]
                        + sum(a.numel() * a.element_size() for a in coef if a is not None))
        res["bound_ms"] = max(res["bytes"] / HBM_BYTES_PER_S,
                              15 * x.numel() / FP32_FLOPS) * 1e3
    return res


def check_nhwc_gn_bwd(key, gen, device, timed=True):
    """The NHWC backward variant against the plain version at one bf16 shape
    (dx, dA, dB), a second launch bit-equal to the first; timed beside its
    bytes bound, the plain version, the NCHW cluster variant on the same
    values and the library's backward on the NCHW values (``library_ms``)."""
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm, groupnorm_train

    shape, has_st, has_z, need_dx = key[1:5], key[5], key[6], key[7]
    dtype = torch.bfloat16
    x, gamma, beta, *coef = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
    g = torch.randn(shape, generator=gen, device=gen.device).to(device, dtype)
    cl, gcl = (t.contiguous(memory_format=torch.channels_last) for t in (x, g))
    _, mean, rstd = groupnorm.gn_cuda(x, gamma, beta, *coef, save_stats=True)
    args = (cl, gcl, mean, rstd, gamma, beta, *coef)
    before = groupnorm_train.variant_launches["nhwc"]
    got = groupnorm_train.gn_bwd_cuda(*args, need_dx=need_dx)
    again = groupnorm_train.gn_bwd_cuda(*args, need_dx=need_dx)
    torch.cuda.synchronize()
    want = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef, need_dx=need_dx)
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "dx": need_dx,
           "plan": groupnorm_train.nhwc_plan_for(cl, gcl, got[0], 32)._asdict(),
           "served_nhwc": groupnorm_train.variant_launches["nhwc"] == before + 2,
           "bit_equal_repeat": all(a is None or torch.equal(a, b) for a, b in zip(got, again)),
           "err": {what: compare(a, w, scaled(TOL[("gn_bwd", dtype)], w))
                   for what, a, w in zip(("dx", "dA", "dB"), got, want) if w is not None}}
    if timed:
        # the library's backward takes NCHW (native_group_norm refuses channels-last)
        saved = library_gn_saved(x, gamma.to(dtype), beta.to(dtype), *coef, 32)
        res.update(
            ms=device_ms(lambda: groupnorm_train.gn_bwd_cuda(*args, need_dx=need_dx)),
            nchw_ms=device_ms(lambda: groupnorm_train.gn_bwd_cuda(
                x, g, mean, rstd, gamma, beta, *coef, need_dx=need_dx)),
            plain_ms=device_ms(lambda: ops.gn_adagn_silu_bwd_plain(
                cl, gcl, mean, rstd, gamma, beta, *coef, need_dx=need_dx)),
            library_ms=device_ms(lambda: library_gn_backward(g, saved, need_dx)))
        res["bytes"] = ((3 if need_dx else 2) * x.numel() * x.element_size()
                        + 8 * shape[1] + 8 * shape[0] * 32 + 8 * shape[0] * shape[1]
                        + sum(a.numel() * a.element_size() for a in coef if a is not None))
        res["bound_ms"] = max(res["bytes"] / HBM_BYTES_PER_S,
                              30 * x.numel() / FP32_FLOPS) * 1e3
    return res


def layout_transforms(fn) -> dict:
    """cuDNN's layout transform kernels (``nchwToNhwc``, ``nhwcToNchw``) in one
    profiled call of ``fn`` (after one unprofiled), beside the call's whole
    kernel time: launches and device ms of each kind."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {"device_ms": sum(e.self_device_time_total for e in kernels) / 1e3}
    for kind in ("nchwtonhwc", "nhwctonchw"):
        hits = [e for e in kernels if kind in e.key.lower()]
        out[kind] = {"launches": sum(e.count for e in hits),
                     "ms": sum(e.self_device_time_total for e in hits) / 1e3}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:30]
    out["top"] = [[e.key[:90], e.count, e.self_device_time_total / 1e3] for e in top]
    return out


def nhwc_phase(seed, device, timed=True) -> dict:
    """The channels-last path of the bf16 models: every GN call of one bf16
    FFHQ128 representation step (b32, eager) on the NHWC variants (the
    counters), each of its shapes held against the plain versions and timed;
    no cuDNN layout transform in that step, against the same step run NCHW
    (the layout rule switched off); and a celeba64 fp32 evaluation's launches
    by variant, all on the NCHW cluster variant as before the NHWC variants.
    The table goes to ``chiprun_out/chip_smoke_nhwc.json``."""
    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM, ShiftUNet, blocks

    t0 = time.perf_counter()
    encoder, decoder = ffhq128_bf16_models(seed, device)
    step = ffhq128_bf16_step(encoder, decoder, TRAIN_BATCH, device, seed + 29)
    ops.reset_launch_counts()
    fwd, bwd, layouts = nhwc_gn_keys(step)
    counts = {"launches": ops.launch_counts(), "gn": ops.gn_variant_counts(),
              "gn_bwd": ops.gn_bwd_variant_counts(), "layouts": dict(layouts)}
    engaged = (counts["gn"] == gn_on(sum(fwd.values()), nhwc=True)
               and counts["gn_bwd"] == gn_on(sum(bwd.values()), nhwc=True)
               and set(layouts) == {"nhwc"})
    gen = torch.Generator(device=device).manual_seed(seed + 31)
    fwd_res = {k: check_nhwc_gn(k, gen, device, timed) for k in sorted(fwd)}
    bwd_res = {k: check_nhwc_gn_bwd(k, gen, device, timed) for k in sorted(bwd)}
    transforms = {"nhwc": layout_transforms(step)}
    rule = blocks.nhwc_model
    blocks.nhwc_model = lambda model: False
    try:
        transforms["nchw"] = layout_transforms(step)
    finally:
        blocks.nhwc_model = rule
    del encoder, decoder, step
    torch.cuda.empty_cache()
    celeba = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM).to(device).eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        celeba(torch.randn(16, 3, 64, 64, device=device), torch.arange(16, device=device),
               torch.randn(16, LATENT, device=device))
    torch.cuda.synchronize()
    fp32_eval = {"gn": ops.gn_variant_counts(), "launches": named_launches()}
    del celeba
    torch.cuda.empty_cache()

    def ok_of(r):
        return r["served_nhwc"] and all(e["ok"] for e in r["err"].values()) and r.get(
            "bit_equal_repeat", True)

    rec = {"phase": "nhwc", "batch": TRAIN_BATCH, "counts": counts, "engaged": engaged,
           "fwd_calls": {str(k): n for k, n in fwd.items()},
           "bwd_calls": {str(k): n for k, n in bwd.items()},
           "transforms": {k: {n: v for n, v in t.items() if n != "top"}
                          for k, t in transforms.items()},
           "fp32_eval": fp32_eval,
           "phase_s": time.perf_counter() - t0}
    if timed:
        for name, res in (("fwd", fwd_res), ("bwd", bwd_res)):
            calls = fwd if name == "fwd" else bwd
            for what in ("ms", "nchw_ms", "plain_ms", "library_ms", "bound_ms"):
                rec[f"{name}_{what}_per_step"] = sum(calls[k] * r[what] for k, r in res.items())
    # the model's entry and exit are PyTorch's copies: no cuDNN transform is left
    no_transforms = not any(transforms["nhwc"][k]["launches"]
                            for k in ("nchwtonhwc", "nhwctonchw"))
    rec["ok"] = bool(engaged and no_transforms and all(ok_of(r) for r in fwd_res.values())
                     and all(ok_of(r) for r in bwd_res.values())
                     and fp32_eval["gn"] == gn_on(92))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_nhwc.json"), "w") as f:
        json.dump({**rec, "top_kernels": {k: t["top"] for k, t in transforms.items()},
                   "fwd": {str(k): r for k, r in fwd_res.items()},
                   "bwd": {str(k): r for k, r in bwd_res.items()}}, f, indent=1)
    return rec


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
    groups = key[8] if len(key) > 8 else 32     # a tp rank's chain: its groups
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "dx": need_dx, "err": {},
           "variant": {}, "bit_equal_repeat": {}}
    if groups != 32:
        res["groups"] = groups
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


def library_stats(x, groups):
    """The stats pass's sums from ``torch.var_mean`` over each slab."""
    xg = x.float().reshape(x.shape[0], groups, -1)
    var, mean = torch.var_mean(xg, dim=2, correction=0)
    n = xg.shape[2]
    return torch.stack([mean * n, (var + mean * mean) * n], dim=2)


def check_split(key, gen, device, timed=True):
    """A split pass of spatial parallelism (``sp_local_keys``' keys) against
    its plain version at a rank's local shape, in fp32 and bf16 within
    ``TOL``: the stats pass (the sums, atol times their largest), the apply
    pass from a given mean and rstd (and, from the fused kernel's saved
    stats, bit-equal to the fused kernel), the backward's moments pass (dA,
    dB and the moments) and dx pass; or the attention of ``Tq`` query rows
    against ``Tk`` keys (and those rows of the ``Tq = Tk`` launch, recorded
    bit for bit). Timed in fp32: the pass's device ms, its plain version's,
    a library call's (``torch.var_mean`` and the sums; ``library_gn``,
    which computes the statistics too; ``library_gn_backward`` without and
    with dx; ``scaled_dot_product_attention``) and the bytes and operations
    of its bound."""
    from pdae_torch import ops
    from pdae_torch.ops import attention, groupnorm, groupnorm_train

    kind = key[0]
    res = {"kind": kind, "shape": list(key[1:]), "err": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        if kind == "attention":
            b, h, tq, tk, d = key[1:]
            scale = 1.0 / math.sqrt(math.sqrt(d))
            q, k, v = (torch.randn((b, h, tk, d), generator=gen, device=gen.device).to(
                device, dtype) for _ in range(3))
            rows = q[:, :, :tq].contiguous()
            got = attention.attention_cuda(rows, k, v)
            whole = attention.attention_cuda(q, k, v)
            torch.cuda.synchronize()
            plan = attention.attention_plan(b * h, tq, d, q.element_size(), tk)
            if attention.library_smem_bytes(plan, tk, d, q.element_size()) != plan.smem_bytes:
                raise AssertionError(f"attention {key} {name}: the plan's shared memory "
                                     "is not the built source's")
            res.setdefault("tiling", {})[name] = plan._asdict()
            res.setdefault("rows_bit_equal_whole", {})[name] = bool(
                torch.equal(got, whole[:, :, :tq]))
            res["err"][name] = compare(got, ops.reference_attention(rows, k, v, scale),
                                       TOL[("attention", dtype)])
            if dtype == torch.float32 and timed:
                res.update(
                    ms=device_ms(lambda: attention.attention_cuda(rows, k, v)),
                    plain_ms=device_ms(lambda: ops.reference_attention(rows, k, v, scale)),
                    library_ms=device_ms(lambda: F.scaled_dot_product_attention(
                        rows, k, v, scale=1.0 / math.sqrt(d))),
                    bytes=(2 * rows.numel() + 2 * k.numel()) * rows.element_size(),
                    flops=4 * b * h * tq * tk * d)
            continue
        shape = key[1:5]
        has_st, has_z = (key[5], key[6]) if len(key) > 5 else (False, False)
        args = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
        x, gamma, beta, coef = args[0], args[1], args[2], args[3:]
        n = x[0].numel() // 32
        sums_p = ops.gn_stats_plain(x, 32)
        mean, rstd = ops.moments_from_sums(sums_p, n)
        if kind == "gn_stats":
            got = groupnorm.gn_stats_cuda(x, 32)
            res["err"][name] = compare(got, sums_p, scaled(TOL[("gn_stats", dtype)], sums_p))
            kernel = lambda: groupnorm.gn_stats_cuda(x, 32)          # noqa: E731
            plain = lambda: ops.gn_stats_plain(x, 32)                # noqa: E731
            library = lambda: library_stats(x, 32)                   # noqa: E731
            nbytes, flops = x.numel() * x.element_size() + 8 * shape[0] * 32, 3 * x.numel()
        elif kind == "gn_apply":
            got = groupnorm.gn_apply_cuda(x, mean, rstd, gamma, beta, *coef, groups=32)
            res["err"][name] = compare(got, ops.gn_apply_plain(
                x, mean, rstd, gamma, beta, *coef, groups=32), TOL[("gn_model", dtype)])
            fused, m_f, r_f = groupnorm.gn_cuda(*args, groups=32, save_stats=True)
            res.setdefault("equals_fused_on_its_stats", {})[name] = bool(torch.equal(
                groupnorm.gn_apply_cuda(x, m_f, r_f, gamma, beta, *coef, groups=32), fused))
            kernel = lambda: groupnorm.gn_apply_cuda(                # noqa: E731
                x, mean, rstd, gamma, beta, *coef, groups=32)
            plain = lambda: ops.gn_apply_plain(                      # noqa: E731
                x, mean, rstd, gamma, beta, *coef, groups=32)
            library = lambda: library_gn(*args, 32)                  # noqa: E731
            nbytes = (2 * x.numel() * x.element_size() + 8 * shape[1] + 8 * shape[0] * 32
                      + sum(a.numel() * a.element_size() for a in coef if a is not None))
            flops = 15 * x.numel()
        else:
            g = torch.randn(shape, generator=gen, device=gen.device).to(device, dtype)
            m_p = groupnorm_train.gn_bwd_moments_plain(x, g, mean, rstd, gamma, beta, *coef,
                                                       groups=32)
            if kind == "gn_bwd_moments":
                got = groupnorm_train.gn_bwd_moments_cuda(x, g, mean, rstd, gamma, beta,
                                                          *coef, groups=32)
                for part, a, w in zip(("dA", "dB", "moments"), got, m_p):
                    res["err"][f"{part}_{name}"] = compare(a, w, scaled(TOL[("gn_bwd", dtype)],
                                                                        w))
                kernel = lambda: groupnorm_train.gn_bwd_moments_cuda(  # noqa: E731
                    x, g, mean, rstd, gamma, beta, *coef, groups=32)
                plain = lambda: groupnorm_train.gn_bwd_moments_plain(  # noqa: E731
                    x, g, mean, rstd, gamma, beta, *coef, groups=32)
                need_dx, rw, fl = False, 2, 25
            else:
                mom = (m_p[2] / n).contiguous()
                got = groupnorm_train.gn_bwd_dx_cuda(x, g, mean, rstd, mom, gamma, beta,
                                                     *coef, groups=32)
                want = groupnorm_train.gn_bwd_dx_plain(x, g, mean, rstd, mom, gamma, beta,
                                                       *coef, groups=32)
                res["err"][f"dx_{name}"] = compare(got, want, scaled(TOL[("gn_bwd", dtype)],
                                                                    want))
                kernel = lambda: groupnorm_train.gn_bwd_dx_cuda(  # noqa: E731
                    x, g, mean, rstd, mom, gamma, beta, *coef, groups=32)
                plain = lambda: groupnorm_train.gn_bwd_dx_plain(  # noqa: E731
                    x, g, mean, rstd, mom, gamma, beta, *coef, groups=32)
                need_dx, rw, fl = True, 3, 20
            saved = (library_gn_saved(x, gamma, beta, *coef, 32)
                     if dtype == torch.float32 and timed else None)
            library = lambda: library_gn_backward(g, saved, need_dx)  # noqa: E731
            nbytes = (rw * x.numel() * x.element_size() + 8 * shape[1] + 16 * shape[0] * 32
                      + 8 * shape[0] * shape[1] * (not need_dx)
                      + sum(a.numel() * a.element_size() for a in coef if a is not None))
            flops = fl * x.numel()
        torch.cuda.synchronize()
        if dtype == torch.float32 and timed:
            res.update(ms=device_ms(kernel), plain_ms=device_ms(plain),
                       library_ms=device_ms(library), bytes=nbytes, flops=flops)
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
    if took != {"cluster": 1, "general": 1, "nhwc": 0} or off.data_ptr() % 16 == 0:
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
    g = torch.randn(shape, generator=gen, device=gen.device).to(device)
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
        if took != {"cluster": 1, "general": 1, "nhwc": 0}:
            raise AssertionError(f"misaligned GN backward {what}: variants took {took}")
        for part, a, b in zip(("dx", "dA", "dB"), off, aligned):
            bwd_misaligned[f"{what}_{part}"] = compare(
                a, b, scaled(TOL[("gn_bwd", torch.float32)], b))

    # a cluster launch of the backward (4 blocks per slab) inside a CUDA graph
    shape = (8, 256, 64, 64)
    args = gn_coefficients(shape, False, False, gen, device, torch.float32)
    g = torch.randn(shape, generator=gen, device=gen.device).to(device)
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
    return out, {"s": seconds, "launches": named_launches(),
                 "gn_variants": ops.gn_variant_counts(),
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def serving_ops(service, images, dec_counts, enc_counts, seed) -> dict:
    """``generate``, ``manipulate`` and a dpm20/dpm20 ``autoencode`` at b8,
    then 8 one-image ``autoencode`` requests through a ``CoalescingBatcher``;
    each op's record, with the launches its structure predicts."""
    from pdae_torch.serving import CoalescingBatcher

    gd = service.gd
    ddim = gd.ddim_schedule(OPS_STYLE).num_steps
    dpm_encode = gd.solver_tables("dpm20", direction="encode").num_steps
    dpm_decode = gd.solver_tables("dpm20").num_steps
    # the first calls build the latent DPM and the classifier: not counted
    service.generate(BATCH, seed, "ddim2", "ddim2")
    service.manipulate(images, attribute="Smiling", encode_style="ddim2",
                       decode_style="ddim2")
    style = OPS_STYLE
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
    records = {"steps": {OPS_STYLE: ddim, "dpm20_encode": dpm_encode,
                         "dpm20_decode": dpm_decode}}
    outs = {}
    for name, (fn, want) in runs.items():
        out, rec = counted(fn)
        outs[name] = out
        rec.update(imgs_per_s=BATCH / rec["s"], launches_expected=want,
                   shape=list(out.shape), dtype=str(out.dtype))
        rec["ok"] = (out.shape == images.shape and out.dtype == np.uint8
                     and rec["launches"] == want
                     and rec["gn_variants"] == gn_on(want["gn_adagn_silu"]))
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
                 and rec["gn_variants"] == gn_on(want["gn_adagn_silu"]))
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

    phase_t0, since = time.perf_counter(), time.time_ns()
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
            records["launches"].append(named_launches())
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
            eval_rec["run"] = {"s": time.perf_counter() - s0, "launches": named_launches(),
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
        saves = traced_saves(since)
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
        and all(v == gn_on(want_step["gn_adagn_silu"])
                for v in records["gn"])
        and all(v == gn_on(want_step["gn_adagn_silu_bwd"])
                for v in records["gn_bwd"])
        and eval_rec["run"]["launches"] == want_eval
        and eval_rec["run"]["gn_variants"] == gn_on(want_eval["gn_adagn_silu"])
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
                 and rec["gn_variants"] == gn_on(want["gn_adagn_silu"]))
    return out, rec


def compare_new_shapes(seen, compared, seed, device, table) -> dict:
    """Every kernel input shape in ``seen`` that is not in ``compared`` held
    to the plain versions in fp32 and bf16 (compared, not timed), each GN
    shape on the cluster variant; the full table goes to ``table`` under
    ``chiprun_out/``, and ``compared`` takes the new shapes."""
    shape_gen = torch.Generator(device=device).manual_seed(seed)
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


SAMPLER_STYLE = "ddim5"          # the later samplers' styles (a depth cut)


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
    short = {"timesteps": 50, "betas_type": "linear"}      # the depth cut
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
                            "step) under a 50-step linear schedule; every other sampler on "
                            f"the run's 1000 steps; styles {SAMPLER_STYLE} (AutoencodingEval "
                            "and the file-built service dpm20); interpolation at 3 alphas"}

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

    # one sampler end to end through the CLI, in a process of its own: started
    # here, beside the runs of 4., and collected after them
    cli_cfg = path("denoise_one_step_cli.yml")
    save_yaml(dict(base, image_index=1), cli_cfg)
    cli_out = path("denoise_one_step_cli.png")
    cli_t0 = time.perf_counter()
    cli = start_child([sys.executable, "-m", "pdae_torch.sample", "--sampler",
                       "denoise_one_step", "--config", cli_cfg, "--set",
                       f"output_path={cli_out}"], cwd=ROOT)

    # 4. every other sampler once ------------------------------------------------
    alphas = [0.0, 0.5, 1.0]
    scales = [-0.3, -0.1, 0.1, 0.3]
    style = SAMPLER_STYLE
    evals = steps(style)
    others = {
        "test_dpms": ({"config_path": path("dpm.yml"),
                       "checkpoint_path": os.path.join(trainer, "dpm.ckpt"),
                       "image_size": 64, "image_channel": 3, "num_samples": 9,
                       "ddim_style": style},
                      {"UNet": evals}, grid_hw(9, 3)),
        "autoencoding_example": (dict(base, image_index=0, encoder_ddim_style=style,
                                      decoder_ddim_style=style, diffusion_config=short),
                                 {"ShiftUNet": 3 * steps(style, gd_short)
                                  + short["timesteps"], "SemanticEncoder": 3},
                                 grid_hw(12, 12)),
        "denoise_one_step": (dict(base, image_index=0),
                             {"ShiftUNet": 1, "SemanticEncoder": 1}, rows_hw(6, 6)),
        "interpolation": (dict(base, image_index_1=0, image_index_2=1, ddim_style=style,
                               alphas=alphas),
                          {"ShiftUNet": evals + 3 * evals * len(alphas),
                           "SemanticEncoder": 1},
                          rows_hw(len(alphas) + 2, len(alphas) + 2)),
        "manipulation": (dict(base, image_index=0, encode_ddim_style=style,
                              decode_ddim_style=style, scale_list=scales),
                         {"ShiftUNet": evals * (1 + len(scales)),
                          "SemanticEncoder": 1 + len(scales)},
                         grid_hw(len(scales) + 1, len(scales) + 1)),
        "unconditional_sample": (dict(base, num_samples=8, latent_ddim_style=style,
                                      decoder_ddim_style=style),
                                 {"ShiftUNet": evals}, grid_hw(8)),
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

    proc = finish_child(cli, 600)
    records["cli_denoise_one_step"] = {
        "s": time.perf_counter() - cli_t0, "returncode": proc.returncode,
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
FID_SAMPLES = 32                 # UnconditionalSample's generated set
FID_BATCH = 32
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


_PORTS = set()


def free_port() -> int:
    """A free localhost port that no earlier call handed out."""
    import socket
    while True:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        if port not in _PORTS:
            _PORTS.add(port)
            return port


# every process the script starts, each the leader of a session of its own,
# so that ending its process group ends whatever it started too
_CHILDREN = []


def spawn(cmd, **kw) -> subprocess.Popen:
    """``subprocess.Popen(cmd, **kw)`` in a session of its own, kept for
    ``stop_children``."""
    p = subprocess.Popen(cmd, start_new_session=True, **kw)
    _CHILDREN.append(p)
    return p


def end_group(p) -> None:
    """Kill ``p``'s process group (``p`` and every process it started that
    is still running) and reap ``p``."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    p.wait()


def start_child(cmd, **kw) -> tuple:
    """``cmd`` started through ``spawn``, its output captured as text;
    ``finish_child`` waits for it."""
    return cmd, spawn(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def finish_child(started, timeout) -> subprocess.CompletedProcess:
    """What ``subprocess.run(cmd, capture_output=True, text=True)`` returns
    for a ``start_child`` command: what the command started ends with it."""
    cmd, p = started
    try:
        out, err = p.communicate(timeout=timeout)
    finally:
        end_group(p)
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def run_child(cmd, timeout, **kw) -> subprocess.CompletedProcess:
    """``subprocess.run(cmd, capture_output=True, text=True)`` through
    ``spawn``."""
    return finish_child(start_child(cmd, **kw), timeout)


def descendants(pid) -> list:
    """``(pid, command line)`` of every process under ``pid``, from Linux's
    ``/proc``."""
    children = collections.defaultdict(list)
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                args = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
            ppid = int(stat[stat.rindex(")") + 2:].split()[1])
        except (OSError, ValueError):
            continue
        children[ppid].append((int(entry), args or stat.split()[1]))
    out, todo = [], [pid]
    while todo:
        for child in children.get(todo.pop(), []):
            out.append(child)
            todo.append(child[0])
    return out


def adopt_orphans() -> None:
    """Make this process the child subreaper of everything under it (Linux
    ``prctl(PR_SET_CHILD_SUBREAPER)``): a process whose parent ends comes
    under this one instead of under init, which may not reap it, and
    ``stop_children`` ends and reaps it."""
    import ctypes

    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:          # PR_SET_CHILD_SUBREAPER
        print(f"chip_smoke: prctl(PR_SET_CHILD_SUBREAPER) failed: "
              f"{os.strerror(ctypes.get_errno())}", file=sys.stderr)


def stop_children() -> list:
    """End every process the script started, with what each started, and
    every other process under this one (orphans too, after
    ``adopt_orphans``); reap them. Returns the command lines of the
    processes that were still there, ended or not yet reaped."""
    left = [" ".join(map(str, p.args)) for p in _CHILDREN if p.poll() is None]
    for p in _CHILDREN:
        end_group(p)
    seen = set()
    for _ in range(100):
        under = descendants(os.getpid())
        if not under:
            break
        for pid, args in under:
            if pid not in seen:
                seen.add(pid)
                left.append(args)
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        time.sleep(0.05)
        # reap what has ended: this process's children, and the orphans
        # that came under it
        while True:
            try:
                if os.waitpid(-1, os.WNOHANG)[0] == 0:
                    break
            except ChildProcessError:
                break
    return left


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


def start_world2(spec, root) -> tuple:
    """The spec's samplers started as two ranks on the one card (both
    ``LOCAL_RANK`` 0, as two hosts of one card each would be), gloo carrying
    the objects; ``finish_world2`` waits for them."""
    spec_path = os.path.join(root, "world2_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = str(free_port())
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0",
                   MASTER_ADDR="localhost", MASTER_PORT=port)
        procs.append(spawn(
            [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--rank-worker",
             spec_path, os.path.join(root, f"rank{rank}.json")],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return t0, root, procs


def finish_world2(started) -> dict:
    """Each rank's output of a ``start_world2`` run, and the run's wall
    seconds. A rank that fails fails the phase."""
    t0, root, procs = started
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            end_group(p)
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

    # 4.'s two ranks start here: they run beside the FID run, the new shapes'
    # comparison and 4.'s one-process control
    w2_cfg = {"autoencoding_eval": eval_cfg,
              "infer_latents": dict(base, batch_size=32,
                                    output_path=os.path.join(root, "latents_w2.ckpt"))}
    w2_started = start_world2(w2_cfg, root)

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
    w2 = finish_world2(w2_started)
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
STAGE_EVAL = "ddim10"           # every stage's eval style (the trainers' are ddim100-500)
STAGE_EVAL_KWARGS = {"regular": {"ddim_style": STAGE_EVAL},
                     "latent": {"latent_ddim_style": STAGE_EVAL,
                                "decoder_ddim_style": STAGE_EVAL},
                     "manipulation": {"encode_style": STAGE_EVAL,
                                      "decode_style": STAGE_EVAL}}
LATENT_LOSS_RTOL = 1e-5          # precomputed z against the encoder in the step


def stage_runner():
    """The shipped configs' runner_config with the cadences of a 6-step run:
    a line a step, saves at 3 and 6, the eval at 6. ``steps_per_dispatch``
    is 1 (3 is no multiple of 4 or 50): the dispatch phase runs their K."""
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
        rec["launches"].append(named_launches())
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
        rec["eval"] = {"s": time.perf_counter() - s0, "launches": named_launches(),
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


def trained_state(trainer) -> dict:
    """{name: (param, EMA, exp_avg, exp_avg_sq, count)} of ``trainer``'s
    trained tensors, the live ones."""
    out = {}
    for g, named in trainer.state.params.items():
        for k, p in named.items():
            opt = trainer.optimizer.state[p]
            out[k if g == "model" else f"{g}.{k}"] = (
                p, trainer.state.ema_params[g][k], opt["exp_avg"], opt["exp_avg_sq"], opt["step"])
    return out


def state_rel_err(a, b) -> float:
    """The largest difference of ``b``'s trained tensors from ``a``'s (a
    ``trained_state`` or a trainer each), relative to the largest magnitude
    of ``a``'s tensor."""
    a, b = (x if isinstance(x, dict) else trained_state(x) for x in (a, b))
    return max(float((x.double() - y.double()).abs().max())
               / max(float(x.double().abs().max()), 1e-30)
               for k, ts in a.items() for x, y in zip(ts, b[k]))


def same_state(a, b) -> list:
    """The names of ``a``'s trained tensors whose params, EMA or Adam moments
    differ from ``b``'s in any bit; each is a trainer or a ``trained_state``."""
    a, b = (x if isinstance(x, dict) else trained_state(x) for x in (a, b))
    return [k for k, ts in a.items() if not all(torch.equal(x, y) for x, y in zip(ts, b[k]))]


def celebahq_files(root) -> dict:
    """The paths ``write_celebahq_pdae`` writes under ``root``."""
    return {k: os.path.join(root, name) for k, name in (
        ("config", "pdae128.yml"), ("checkpoint", "pdae128.ckpt"),
        ("stats", "latents128.ckpt"), ("dpm_config", "dpm128.yml"))}


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
    files = celebahq_files(root)
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
        "cuts": f"6 steps each; evals at {STAGE_EVAL} (the trainers' ddim100, "
                "ddim100/ddim100 and ddim500/ddim200); steps_per_dispatch 1 (the "
                "dispatch phase runs K)",
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
            since = time.time_ns()
            a, build_s = build(stage, "a")
            if stage == "regular":
                per = per_call(a.model, torch.zeros(1, 3, 64, 64, device=device),
                               torch.zeros(1, dtype=torch.int32, device=device))
                want_step = {**per, "gn_adagn_silu_bwd": per["gn_adagn_silu"]}
                want_eval = {k: v * a.gd.ddim_schedule(STAGE_EVAL).num_steps
                             for k, v in per.items()}
            else:
                size = cfg["train_dataset_config"]["image_size"]
                x = torch.zeros(1, 3, size, size, device=device)
                enc = per_call(a.encoder, x)
                dec = per_call(a.decoder, x, torch.zeros(1, dtype=torch.int32, device=device),
                               torch.zeros(1, LATENT, device=device))
                want_step = enc
                n_dec = a.gd.ddim_schedule(STAGE_EVAL).num_steps * (
                    1 if stage == "latent" else 2)
                n_enc = 0 if stage == "latent" else 2
                want_eval = {k: n_dec * dec[k] + n_enc * enc[k] for k in dec}
            step3 = os.path.join(root, stage, "step3.ckpt")
            run_a = drive_stage(a, keys, f"{stage}_a", STAGE_EVAL_KWARGS[stage],
                                keep_step3=step3)
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
            saves = traced_saves(since)
            rec = {"build_s": build_s, "resume_build_s": resume_s, "start_step_b": b.start_step,
                   "losses": run_a["loss"], "step_s": run_a["s"],
                   "mean_step_s": sum(run_a["s"][1:]) / (len(run_a["s"]) - 1),
                   "launches_per_step": run_a["launches"][-1],
                   "launches_expected": want_step, "gn_variants_per_step": run_a["gn"][-1],
                   "gn_bwd_variants_per_step": run_a["gn_bwd"][-1],
                   "peak_mem_gb": run_a["peak_mem_gb"], "loop_s": run_a["loop_s"],
                   "save_wait_s": [r[0] for r in saves], "save_write_s": [r[1] for r in saves],
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
            ok = ok and all(v == gn_on(want_step["gn_adagn_silu"])
                            for r in runs for v in r["gn"])
            ok = ok and all(v == gn_on(want_step["gn_adagn_silu_bwd"])
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
FFHQ_STEPS = 1                   # timed per (dtype, remat), after one warm-up
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
        and all(v == gn_on(want["gn_adagn_silu"], nhwc=True) for v in run["gn"])
        and all(v == gn_on(want["gn_adagn_silu_bwd"], nhwc=True)
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
        records["ffhq128"] = ffhq       # the trunk file stays for the dispatch phase
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
    finally:
        keys.handle.remove()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags

    # 4. every new kernel key against the plain versions, fp32 and bf16 -------
    # (the 128x128 GN slabs timed)
    records["kernel_shapes"] = compare_keys(
        keys.runs_of(), compared, seed + 15, device, "chip_smoke_precision_shapes.json",
        lambda key: key[0] != "attention" and key[3] == 128)
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


def compare_keys(runs_of, compared, seed, device, table, timed) -> dict:
    """Every kernel key of ``runs_of`` ({key: the runs that gave it}, as
    ``KernelKeys`` keys them) that is not in ``compared`` held to the plain
    versions in fp32 and bf16, each GN key on the cluster variant, the keys
    ``timed(key)`` picks timed (device ms, bound, plain and library ms, in
    bf16 too); the full table goes to ``table`` under ``chiprun_out/``, and
    ``compared`` takes the new keys."""
    check_gen = torch.Generator(device=device).manual_seed(seed)
    checks = {"attention": check_attention, "gn": check_gn, "gn_bwd": check_gn_bwd}
    results = {}
    for key in sorted(k for k in runs_of if k not in compared):
        arg = key[1:] if key[0] == "attention" else key
        results[key] = dict(checks[key[0]](arg, check_gen, device, timed=timed(key)),
                            runs=runs_of[key], timed=timed(key))
    compared.update(results)
    with open(os.path.join(OUT_DIR, table), "w") as f:
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
            row = timed_rows[json.dumps(list(k))]
            row["bound_ms"] = max(r["bytes"] / HBM_BYTES_PER_S, r["flops"] / FP32_FLOPS) * 1e3
            row["plan_fp32"] = r["variant"]["float32"] if "variant" in r else r["tiling"]
    return {"shapes": len(runs_of), "compared_here": len(results),
            "max_abs_err_fp32": max((v["max_abs_err"] for r in results.values()
                                     for e, v in r["err"].items() if "float32" in e),
                                    default=0.0),
            "timed": timed_rows, "off_cluster": off_cluster, "disagree": disagree,
            "ok": not disagree and not off_cluster}


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
            rec["launches"].append(named_launches())
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
                       and all(v == gn_on(w["gn_adagn_silu"], dtype == "bfloat16")
                               for v in rec["gn"])
                       and all(v == gn_on(w["gn_adagn_silu_bwd"], dtype == "bfloat16")
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


INGEST_IMAGES = 64               # synthetic JPEGs at CelebA's geometry, packed by the CLI
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


def start_module(*args) -> tuple:
    """``python -m ARGS`` started from the checkout's root, as a user runs the
    port's CLIs; ``finish_module`` waits for it."""
    return time.perf_counter(), args, start_child([sys.executable, "-m", *args], cwd=ROOT)


def finish_module(started) -> dict:
    """A ``start_module`` run's seconds from its start and the last line it
    printed. Fails on a non-zero exit."""
    t0, args, child = started
    proc = finish_child(child, 900)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return {"s": time.perf_counter() - t0, "said": lines[-1] if lines else ""}


def run_module(*args) -> dict:
    """``python -m ARGS`` run to its end (``start_module``, ``finish_module``)."""
    return finish_module(start_module(*args))


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
        # 1. the user's images, packed, while 2. the DPM goes to a reference
        # .pt and back (two CLI processes side by side) --------------------------------
        dpm = os.path.join(OUT_DIR, "trainer", "dpm.ckpt")
        exporting = start_module("pdae_torch.convert", dpm, path("dpm.pt"), "--export")
        t0 = time.perf_counter()
        os.makedirs(path("images"))
        for i, img in enumerate(synthetic_photos(seed + 20, INGEST_IMAGES)):
            Image.fromarray(img).save(path(f"images/{i:06d}.jpg"), quality=INGEST_QUALITY)
        write_s = time.perf_counter() - t0
        packing = start_module("pdae_torch.prepare_lmdb", path("images"), path("lmdb"),
                               "--key-format", CELEBA64.key_fmt)
        export = finish_module(exporting)
        back = run_module("pdae_torch.convert", path("dpm.pt"), path("dpm.ckpt"))
        packed = finish_module(packing)
        rec["pack"] = {"write_jpegs_s": write_s, "prepare_lmdb_s": packed["s"],
                       "said": packed["said"],
                       "lmdb_bytes": os.path.getsize(path("lmdb/data.mdb"))}
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
            steps["launches"].append(named_launches())
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
            and all(v == gn_on(want_step["gn_adagn_silu"])
                    for v in steps["gn"])
            and all(v == gn_on(want_step["gn_adagn_silu_bwd"])
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
            and counts["gn_variants"] == gn_on(want_request["gn_adagn_silu"]))
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


DISPATCH_CUT = 3                 # the step of the checkpoint off a chunk boundary
DISPATCH_END = {4: 9, 50: 103}   # from the cut: a realigning chunk, a whole one, a tail
DISPATCH_TIMED_CHUNKS = 1        # timed chunks per path, then one profiled
DISPATCH_PROFILED = 1            # at most this many steps of the profiled chunk


def dispatch_runner(k) -> dict:
    """A runner_config whose cadences are multiples of ``k``: a loss line
    every chunk, no save and no eval inside the run."""
    far = k * 10 ** 5
    return {"display_steps": k, "evaluate_every_steps": far, "save_latest_every_steps": far,
            "save_checkpoint_every_steps": far, "num_iterations": 1, "ema_every": 1,
            "ema_decay": 0.9999, "steps_per_dispatch": k}


def dispatch_configs(files, ffhq) -> dict:
    """{name: (config, K, steps, resume)} of the phase: the shipped configs
    at their own K and widths on the earlier phases' SYNTHETIC data and
    files, each with the resume at DISPATCH_CUT; the bf16 representation
    step straight to the end; the FFHQ128 representation step under
    ``remat: skips``, 3 steps."""
    rep = trainer_config(os.path.join(OUT_DIR, "trainer", "dpm.ckpt"))
    stages = stage_configs(files)
    out = {"representation": (rep, 4, DISPATCH_END[4]),
           "representation_bf16": (rep, 4, DISPATCH_END[4]),
           "regular": (stages["regular"], 4, DISPATCH_END[4]),
           "latent": (stages["latent"], 50, DISPATCH_END[50]),
           "manipulation": (stages["manipulation"], 50, DISPATCH_END[50]),
           "ffhq128_remat_skips": (ffhq_config(*ffhq, "float32"), 4, DISPATCH_CUT)}
    for name, (cfg, k, end) in out.items():
        rc = {**dispatch_runner(k),
              "compute_dtype": cfg["runner_config"].get("compute_dtype", "float32")}
        if name == "representation_bf16":
            rc["compute_dtype"] = "bfloat16"
        if name.startswith("ffhq128"):
            rc["remat"] = "skips"
        out[name] = ({**cfg, "runner_config": rc}, k, end,
                     name not in ("representation_bf16", "ffhq128_remat_skips"))
    return out


def step_structure(name, trainer, device) -> dict:
    """The kernel launches of one train step of ``trainer``, from its models."""
    if name.startswith(("representation", "ffhq128")):
        mode = trainer.runner_config.get("remat") or "none"
        return remat_structure(trainer.encoder, trainer.decoder)[mode]
    ds = trainer.config["train_dataset_config"]
    size = int(ds["image_size"])
    x = torch.zeros(1, int(ds.get("image_channel", 3)), size, size, device=device)
    if name == "regular":
        t = torch.zeros(1, dtype=torch.int32, device=device)
        per = per_call(trainer.model, x, t, t if hasattr(trainer.model, "label_emb") else None)
        return {**per, "gn_adagn_silu_bwd": per["gn_adagn_silu"]}
    return per_call(trainer.encoder, x)


def recording(trainer) -> list:
    """The per-step losses ``trainer``'s loop takes from now on, in order
    (device tensors), kept by wrapping its chunk runner."""
    seen, inner = [], trainer._chunk_runner

    def runner(*args):
        run = inner(*args)

        def wrapped(c):
            out, load = run(c)
            seen.extend(next(iter(m.values())) for m in out)
            return out, load
        return wrapped

    trainer._chunk_runner = runner
    return seen


def drop_graphs(trainer) -> None:
    """Free ``trainer``'s captured graphs now, so that their private pool
    goes back to the card with the trainer and not at a later collection."""
    if trainer._dispatch is not None:
        for g in trainer._dispatch.graphs.values():
            g.graph.reset()
        trainer._dispatch = None


def path_launches(counted, dispatch) -> dict:
    """The launches a graph run made on the card: what the wrappers counted
    (the eager warm-up step and each capture, once) with each captured
    launch counted once per replay."""
    per = dispatch.launches
    return {k: counted[k] + per.get(k, 0) * (dispatch.replays - len(dispatch.graphs))
            for k in counted}


def chunk_times(trainer, k) -> dict:
    """Wall ms per step of ``trainer``'s loop over whole chunks of ``k``
    steps (DISPATCH_TIMED_CHUNKS, unprofiled, after the steps up to a
    multiple of ``k``), and the device's busy ms per step and idle share
    over one more chunk, cut to DISPATCH_PROFILED steps, under
    ``torch.profiler`` (idle against the unprofiled wall)."""
    def chunk(steps=k):
        trainer.train(max_steps=trainer.step + steps, save_on_exit=False)
        torch.cuda.synchronize()

    if trainer.step % k:
        chunk(k - trainer.step % k)
    t0 = time.perf_counter()
    for _ in range(DISPATCH_TIMED_CHUNKS):
        chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (DISPATCH_TIMED_CHUNKS * k)
    n = min(k, DISPATCH_PROFILED)
    prof = idle_share(lambda: chunk(n), reps=1)
    busy = prof["device_busy_ms"]
    return {"wall_ms": wall_ms, "busy_ms": None if busy is None else busy / n,
            "idle_share": None if busy is None else 1.0 - busy / n / wall_ms,
            "profiled_wall_ms": prof["wall_ms"] / n,
            "profiled_idle_share": prof["device_idle_share"],
            "kernels_per_step": prof["device_kernels_per_call"] / n,
            "timing_s": time.perf_counter() - t0}


# the port's kernels by their csrc/ names, as a profiler trace names them
CSRC_KERNELS = {"attention_fwd_kernel": "attention",
                "attention_fwd_bf16_mma_kernel": "attention",
                "gn_adagn_silu_kernel": "gn_adagn_silu",
                "gn_adagn_silu_cluster_kernel": "gn_adagn_silu",
                "gn_adagn_silu_bwd_kernel": "gn_adagn_silu_bwd",
                "gn_adagn_silu_bwd_cluster_kernel": "gn_adagn_silu_bwd"}


def traced_kernels(trace_dir) -> tuple:
    """(the trace files ``torch.profiler.tensorboard_trace_handler`` wrote
    under ``trace_dir``, their MB, the device events of every kernel, and
    the events of the port's kernels as {stream: {kernel: events}} with the
    stream of the earliest of them first). A kernel is known by its
    ``csrc/`` name in the event's name."""
    files = sorted(os.listdir(trace_dir))
    mb, every, ours = 0.0, 0, []
    for name in files:
        path = os.path.join(trace_dir, name)
        mb += os.path.getsize(path) / 2 ** 20
        with open(path) as f:
            trace = json.load(f)
        for e in trace["traceEvents"]:
            if e.get("cat") != "kernel":
                continue
            every += 1
            found = [k for c, k in CSRC_KERNELS.items() if c in e.get("name", "")]
            if len(found) == 1:
                ours.append((e["ts"], str(e.get("args", {}).get("stream")), found[0]))
    by_stream = {}
    for _, stream, kernel in sorted(ours):
        counts = by_stream.setdefault(stream, {k: 0 for k in FUSED_KERNELS})
        counts[kernel] += 1
    return files, mb, every, by_stream


def profiled_chunk(trainer, k, want_losses, trace_dir) -> dict:
    """One chunk of ``k`` steps of ``trainer`` (``steps_per_dispatch`` k,
    ``runner_config.profile_dir`` = ``trace_dir``): the eager warm-up step
    on the dispatch's side stream, then the capture under the profiler and
    the replays. Its losses must equal ``want_losses`` (the same steps
    without the profiler) bit for bit, the loop must have written one
    trace, and the trace must hold the device events of each kernel of the
    replays (every stream but the warm-up's, the first to run one of the
    port's kernels) as many as the capture launched times the replays, and
    of the warm-up step as many as it launched: the profiler sometimes
    leaves one kernel record of that step out of the trace (PERF.md, PR
    18), which ``lost`` counts, and at most one a kernel passes."""
    import shutil

    from pdae_torch import ops

    losses = recording(trainer)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train(max_steps=k, save_on_exit=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    d = trainer._dispatch
    launched = path_launches(named_launches(), d)
    per_replay = {n: d.launches.get(n, 0) for n in FUSED_KERNELS}
    files, mb, every, by_stream = traced_kernels(trace_dir)
    shutil.rmtree(trace_dir)             # tens of MB: not brought back
    streams = list(by_stream)
    warm = by_stream[streams[0]] if streams else {n: 0 for n in FUSED_KERNELS}
    replayed = {n: sum(by_stream[s][n] for s in streams[1:]) for n in FUSED_KERNELS}
    warm_launched = {n: launched[n] - per_replay[n] * d.replays for n in FUSED_KERNELS}
    rec = {"s": seconds, "steps": len(losses), "replays": d.replays,
           "losses": [float(v) for v in losses],
           "losses_bit_equal": len(losses) == k and all(
               torch.equal(a, b) for a, b in zip(losses, want_losses[:k])),
           "trace_files": files, "trace_mb": mb, "trace_kernel_events_all": every,
           "trace_kernel_events_by_stream": by_stream, "launches_on_path": launched,
           "replay_events": replayed,
           "replay_launches": {n: per_replay[n] * d.replays for n in FUSED_KERNELS},
           "warm_up_events": warm, "warm_up_launches": warm_launched,
           "lost": {n: warm_launched[n] - warm[n] for n in FUSED_KERNELS}}
    rec["ok"] = bool(rec["losses_bit_equal"] and len(files) == 1
                     and replayed == rec["replay_launches"]
                     and all(per_replay[n] and warm[n] for n in FUSED_KERNELS)
                     and all(0 <= n <= 1 for n in rec["lost"].values()))
    return rec


def dispatch_phase(seed, device, files, ffhq) -> dict:
    """``steps_per_dispatch`` on the card: each config of ``dispatch_configs``
    trained eagerly at K=1 (E) and from the captured graph at its K: G1 to
    DISPATCH_CUT (a chunk whose first step is the eager warm-up, then a
    capture and replays; saved there, off a chunk boundary), G2 resumed from
    G1's file to the end (a realigning chunk, whole chunks, a tail). Every
    step's loss, and at the end every param, EMA tensor, Adam moment and the
    count, must equal E's bit for bit (``cudnn.deterministic``); each graph
    run's launches, a capture counted once per replay, must equal the
    structure's per step, every GN launch on the cluster variant. Wall ms
    per step, busy ms and the idle share of whole chunks, graph against
    eager, each path timed after its run. E is released before the graph
    trainers are built, and each trainer's graphs with it. The bf16
    representation step runs straight to the end (G1 alone); the FFHQ128
    step (fp32, ``remat: skips``) 3 steps, untimed, its losses held bit for
    bit and its final state compared and recorded: its eager runs are not
    bit-reproducible in this process from step 3 (two eager trainers
    differed there beside a captured graph, and agree in a fresh process;
    PERF.md, section 7)."""
    import gc
    import shutil

    from pdae_torch import ops
    from pdae_torch.train import pick_trainer

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "dispatch")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    records = {"config": {
        "runs": "E: K=1 eager; G1: the config's K to step 3, saved there; G2: resumed "
                "from G1's file to the end (K=4: 9 steps, chunks 1+4+1; K=50: 103 steps, "
                "chunks 47+50+3); bf16: G1 straight to 9; FFHQ128 remat skips: E and G1 "
                "to 3; E released before G1 is built",
        "configs": "the trainer phase's celeba64 PDAE (b32; fp32 and bf16), the stages "
                   "phase's dpm_celeba64 (b32), celeba64_latent (b128, resident, encode) "
                   "and celebahq_manipulation (b128, resident) dicts, the precision "
                   "phase's FFHQ128 representation config (b32, fp32, remat skips)",
        "numerics": "fp32 with TF32 off unless bf16, cudnn.deterministic"}}
    configs = dispatch_configs(files, ffhq)
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def build(name, run, k, resume=None, **runner):
        cfg = configs[name][0]
        cfg = {**cfg, "runner_config": {**cfg["runner_config"], "steps_per_dispatch": k,
                                        **runner}}
        trainer = pick_trainer(cfg)(config=cfg, run_path=os.path.join(root, name, run),
                                    resume=resume, seed=seed)
        if name == "regular":
            trainer.train_dataset.augmentation = True     # as the stages phase runs it
        return trainer

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def graph_run(trainer, end, want, save=True):
        losses = recording(trainer)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train(max_steps=end, save_on_exit=save)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        d = trainer._dispatch
        counted, gn = named_launches(), ops.gn_variant_counts()
        bwd = ops.gn_bwd_variant_counts()
        captures = len(d.graphs)
        launches = path_launches(counted, d)
        steps = d.replays + 1
        per_replay = named_launches(d.launches)
        nhwc = trainer._compute_dtype() == torch.bfloat16
        ok = (per_replay == want and launches == {k: v * steps for k, v in want.items()}
              and gn == gn_on(want["gn_adagn_silu"] * (1 + captures), nhwc)
              and bwd == gn_on(want["gn_adagn_silu_bwd"] * (1 + captures), nhwc))
        return losses, {"s": s, "steps": steps, "replays": d.replays, "captures": captures,
                        "launches_counted": counted, "launches_per_replay": per_replay,
                        "launches_on_path": launches, "launches_ok": bool(ok)}

    try:
        for name, (cfg, k, end, resumed) in configs.items():
            timed = not name.startswith("ffhq128")      # the remat step: bit-equality alone
            t0 = time.perf_counter()
            base = torch.cuda.memory_allocated()
            free_gb = torch.cuda.mem_get_info()[0] / 1e9
            eager = build(name, "eager", 1)
            build_s = time.perf_counter() - t0
            want = step_structure(name, eager, device)
            want_losses = recording(eager)
            ops.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            eager.train(max_steps=end, save_on_exit=False)
            eager_launches = named_launches()
            rec = {"k": k, "steps": end, "build_s": build_s, "structure": want,
                   "start_allocated_gb": base / 1e9, "start_free_gb": free_gb,
                   "eager_peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                   "eager_launches_ok": eager_launches == {
                       kk: v * end for kk, v in want.items()}}
            # E's state at the end, then its times; E is gone before the
            # graph trainers are built, so that no run shares the card
            want_state = {n: tuple(t.clone() for t in ts)
                          for n, ts in trained_state(eager).items()}
            want_losses = list(want_losses)
            if timed:
                rec["eager"] = chunk_times(eager, k)
            eager._resident_cache = None
            del eager
            release()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            g1 = build(name, "graph", k)
            got_losses, rec["g1"] = graph_run(g1, DISPATCH_CUT if resumed else end, want,
                                              save=resumed)
            last = g1
            if resumed:
                g1._join_save()
                drop_graphs(g1)
                del g1, last
                release()
                last = build(name, "graph", k, resume="latest")
                rec["g2_start_step"] = last.start_step
                more, rec["g2"] = graph_run(last, end, want)
                got_losses += more
            want_l = [float(v) for v in want_losses]
            got_l = [float(v) for v in got_losses]
            rec["losses_eager"], rec["losses_graph"] = want_l[:6], got_l[:6]
            rec["losses_bit_equal"] = len(got_losses) == len(want_losses) == end and all(
                torch.equal(a, b) for a, b in zip(got_losses, want_losses))
            rec["state_mismatched"] = same_state(want_state, last)[:5]
            rec["state_worst_rel_err"] = state_rel_err(want_state, last)
            rec["step"] = last.step
            rec["graph_peak_mem_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
            if timed:
                rec["graph"] = chunk_times(last, k)
            # the shipped configs' state bit for bit; the FFHQ128 step's is
            # recorded, not held: its eager runs are not bit-reproducible in
            # this process from step 3 (PERF.md, section 7)
            state_ok = not rec["state_mismatched"] or not timed
            rec["ok"] = bool(rec["losses_bit_equal"] and state_ok
                             and rec["step"] == end and rec["eager_launches_ok"]
                             and all(rec[r]["launches_ok"] for r in ("g1", "g2") if r in rec)
                             and rec.get("g2_start_step", DISPATCH_CUT) == DISPATCH_CUT
                             and ("g2" in rec) == resumed
                             and all(math.isfinite(v) for v in got_l))
            drop_graphs(last)
            last._resident_cache = None
            del last
            release()
            if name == "representation":
                # the same graph run's first chunk with runner_config.profile_dir
                trace_dir = os.path.join(root, name, "trace")
                traced = build(name, "profiled", k, profile_dir=trace_dir)
                rec["profile_dir"] = profiled_chunk(traced, k, got_losses, trace_dir)
                rec["ok"] = rec["ok"] and rec["profile_dir"]["ok"]
                drop_graphs(traced)
                del traced
                release()
            rec["config_s"] = time.perf_counter() - t0
            records[name] = rec
            del want_losses, got_losses, want_state
            torch.cuda.reset_peak_memory_stats()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
        for parent, _, names in os.walk(root):
            for n in names:
                if n.endswith(".ckpt"):
                    os.unlink(os.path.join(parent, n))
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


def summarise_split(kind, results, weights, per) -> dict:
    """A split pass's (or the ``Tq < Tk`` attention's) times summed over
    ``weights``' launches (one sp rank's train step) at its local shapes
    (fp32), with its bound and largest fp32 error."""
    compared = {k: r for k, r in results.items() if k[0] == kind}
    timed = {k: r for k, r in compared.items() if k in weights}

    def total(field):
        return sum(weights[k] * r[field] for k, r in timed.items())

    t_bytes = total("bytes") / HBM_BYTES_PER_S * 1e3
    t_ops = total("flops") / FP32_FLOPS * 1e3
    return {"max_abs_err": max(v["max_abs_err"] for r in compared.values()
                               for key, v in r["err"].items() if key.endswith("float32")),
            "ms": total("ms"), "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "library_ms": total("library_ms"), "per": per}


DDP_RANKS = 2                    # two ranks on the one card, b32 each
WORKER_STACKS_S = 420            # a ddp-phase process's stacks to its log this often
DDP_STEPS = 3                    # a save at DDP_CUT, resumed there
DDP_CUT = 2
DDP_GRAPH_STEPS = 8              # the world-1 NCCL run: chunks 4+4 at K=4
TRACED_STEPS = 2                 # replays of a traced chunk
DDP_TOL = {"loss_rel": 1e-5,     # world 2 against one process over the 64 rows
           "grad_rel": 1e-3,     # each tensor's error over its own largest value,
           "mu_rel": 1e-3,       # floored at 1e-4 of the category's largest
           "nu_rel": 2e-3,
           "param_abs": 1e-6,    # lr 1e-4, Adam eps 1e-5, 3-4 steps
           "ema_abs": 1e-6}


def ddp_config(dpm_path, k=1) -> dict:
    """The trainer phase's celeba64 PDAE run for the ddp phase: b32 a rank,
    Adam eps 1e-5 (a gradient that is rounding noise would be a whole Adam
    step at 1e-8), a loss line every step, no eval and no save inside the
    run; ``k``: ``steps_per_dispatch``."""
    cfg = trainer_config(dpm_path)
    cfg["optimizer_config"] = {**cfg["optimizer_config"], "adam_eps": 1e-5}
    cfg["runner_config"] = {**dispatch_runner(k), "display_steps": k}
    return cfg


def ddp_state(trainer, grads=True) -> dict:
    """{name: [param, EMA, exp_avg, exp_avg_sq(, grad)]} of ``trainer``'s
    trained tensors, copied to the host."""
    out = {}
    for name, ts in trained_state(trainer).items():
        g, k = name.split(".", 1)
        keep = list(ts[:4]) + ([trainer.state.params[g][k].grad] if grads else [])
        out[name] = [t.detach().cpu().clone() for t in keep]
    return out


def state_digest(state) -> str:
    import hashlib
    h = hashlib.sha256()
    for name in sorted(state):
        for t in state[name]:
            h.update(t.numpy().tobytes())
    return h.hexdigest()


def files_under(path) -> list:
    return sorted(os.path.relpath(os.path.join(p, n), path)
                  for p, _, names in os.walk(path) for n in names) if os.path.isdir(path) else []


def timed_losses(trainer) -> tuple:
    """(losses, wall ms) of each chunk ``trainer``'s loop runs from now on,
    the card synchronised after each."""
    losses, ms, inner = [], [], trainer._chunk_runner

    def runner(*args):
        run = inner(*args)

        def wrapped(c):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, load = run(c)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / c)
            losses.extend(float(next(iter(m.values()))) for m in out)
            return out, load
        return wrapped

    trainer._chunk_runner = runner
    return losses, ms


def wait_for_file(path, limit: float = 1200) -> float:
    """Seconds until ``path`` exists (a go another process gives); raises
    after ``limit`` seconds."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > limit:
            raise TimeoutError(f"no {path}")
        time.sleep(0.2)
    return time.perf_counter() - t0


def ddp_worker(spec_path, out_path) -> int:
    """One process of the ddp phase (``python3 chip_smoke.py --ddp-worker SPEC
    OUT``): ``two_ranks``, a rank of the gloo run (A: 3 steps saved at 2, B:
    resumed from that file), or ``nccl1``/``nogroup``, the K=4 graph run with
    an NCCL group of one rank or with none. A ``two_ranks`` or ``nccl1``
    process whose spec holds ``fsdp`` then runs the fsdp phase's run of its
    kind in the same process group (``fsdp_run``): a process start and a
    first build fewer than a process of its own."""
    import gc
    import shutil

    import torch.distributed as dist

    from pdae_torch import ops, parallel, tracing
    from pdae_torch.train import pick_trainer

    import faulthandler

    with open(spec_path) as f:
        spec = json.load(f)
    # a process stuck in a collective shows where: every thread's stack
    # goes to its log every WORKER_STACKS_S seconds (the runs end sooner)
    faulthandler.dump_traceback_later(WORKER_STACKS_S, repeat=True)
    tracing.enable()             # the save times are its spans (traced_saves)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    role, root = spec["role"], spec["root"]
    if "wait_for" in spec:
        # the four-rank processes start with the ddp phase and wait for the
        # two-rank processes to end their tp train run (they share the card
        # with their tp service run); the graph runs' processes start then
        # too and wait for their turn
        t0 = time.perf_counter()
        while not os.path.exists(spec["wait_for"]):
            if time.perf_counter() - t0 > 1200:
                raise TimeoutError(f"no {spec['wait_for']}")
            time.sleep(0.2)
    if role in ("two_ranks", "four_ranks"):
        parallel.init_distributed(backend="gloo")
    elif role == "nccl1":
        # one rank: its own store, on a port free now that its turn came
        os.environ["MASTER_PORT"] = str(free_port())
        parallel.init_distributed(backend="nccl")
    rank = parallel.process_index()
    out = {"role": role, "rank": rank, "world": parallel.process_count(),
           "tensor_backend": parallel.tensor_backend()}
    try:
        if role == "two_ranks":
            cfg = spec["config"]
            run_a = os.path.join(root, "a", f"rank{rank}")
            torch.cuda.reset_peak_memory_stats()
            t0, since = time.perf_counter(), time.time_ns()
            a = pick_trainer(cfg)(config=cfg, run_path=run_a, seed=spec["seed"])
            out["build_s"] = time.perf_counter() - t0
            losses, ms = timed_losses(a)
            ops.reset_launch_counts()
            a.train(max_steps=DDP_CUT)               # the final save, at DDP_CUT
            a._join_save()
            if parallel.is_primary():
                shutil.copyfile(os.path.join(run_a, "checkpoints", "latest.ckpt"),
                                spec["cut_file"])
            parallel.sync_global_devices("copied")
            a.train(max_steps=DDP_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
            out["launches"] = named_launches()
            out.update(losses=losses, step_ms=ms, step=a.step, files=files_under(run_a),
                       save_s=traced_saves(since), memory=step_memory())
            state = ddp_state(a)
            out["digest"] = state_digest(state)
            if parallel.is_primary():
                torch.save(state, spec["state_file"])
            del a
            gc.collect()
            torch.cuda.empty_cache()
            run_b = os.path.join(root, "b", f"rank{rank}")
            b = pick_trainer(cfg)(config=cfg, run_path=run_b, resume=spec["cut_file"],
                                 seed=spec["seed"])
            out["resume_start"] = b.start_step
            resumed, _ = timed_losses(b)
            b.train(max_steps=DDP_STEPS, save_on_exit=False)
            got = ddp_state(b)
            out["resume_losses"] = resumed
            out["resume_mismatched"] = [k for k, ts in state.items()
                                        if not all(torch.equal(x, y)
                                                   for x, y in zip(ts, got[k]))][:5]
            out["resume_files"] = files_under(run_b)
            out["all_reduce_ms"] = all_reduce_ms(b)
            del b
            gc.collect()
            torch.cuda.empty_cache()
            if "fsdp" in spec:
                out["fsdp"] = fsdp_run(spec["fsdp"], "two_ranks")
            if "tp" in spec:
                out["tp"] = tp_run(spec["tp"], "two_ranks")
            if "sp" in spec:
                out["sp"] = sp_run(spec["sp"], "two_ranks")
        elif role == "four_ranks":
            out["tp"] = tp_run(spec["tp"], "four_ranks")
            # the tp run has left the card: the two ranks' sp run may start
            parallel.sync_global_devices("sp_go")
            if rank == 0:
                with open(spec["sp"]["go"], "w"):
                    pass
            # the card is the ddp phase's graph runs' next: they are held bit
            # for bit against each other, and cuDNN picks its algorithms by
            # the card's free memory; the sp and hier runs follow them
            wait_for_file(spec["after_graphs"])
            out["sp"] = sp_run({k: v for k, v in spec["sp"].items() if k != "go"},
                               "four_ranks")
            out["hier"] = hier_run(spec["hier"])
        else:
            cfg = ddp_config(spec["dpm"], k=4)
            out["card_free_gb"] = torch.cuda.mem_get_info()[0] / 1e9
            tr = pick_trainer(cfg)(config=cfg, run_path=os.path.join(root, role),
                                   seed=spec["seed"])
            losses, ms = timed_losses(tr)
            ops.reset_launch_counts()
            tr.train(max_steps=DDP_GRAPH_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
            d = tr._dispatch
            out.update(losses=list(losses), chunk_step_ms=list(ms), step=tr.step,
                       replays=d.replays,
                       captures=len(d.graphs), launches_per_replay=named_launches(d.launches),
                       launches_on_path=path_launches(named_launches(), d),
                       digest=state_digest(ddp_state(tr, grads=False)))
            out["trace"] = traced_chunk(tr, TRACED_STEPS)
            if role == "nogroup":
                drop_graphs(tr)
                del tr
                gc.collect()
                torch.cuda.empty_cache()
                with open(spec["done"], "w"):
                    pass
            if role == "nccl1":
                out["all_reduce_ms"] = all_reduce_ms(tr)
                drop_graphs(tr)
                del tr
                gc.collect()
                torch.cuda.empty_cache()
                # cuDNN filters its algorithms by the card's free memory: the
                # runs held bit for bit against this one wait until the
                # process beside it has left the card
                out["waited_s"] = wait_for_file(spec["after"])
                if "fsdp" in spec:
                    out["fsdp"] = fsdp_run(spec["fsdp"], "nccl1")
                if "tp" in spec:
                    out["tp"] = tp_run(spec["tp"], "nccl1")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def traced_chunk(trainer, k) -> dict:
    """One more chunk of ``k`` replays of ``trainer`` under ``torch.profiler``:
    the card's busy ms and kernels per step, the kernels whose name holds
    ``nccl`` (a one-rank all-reduce may be a copy or nothing), and the eight
    kernels that took most of the time, ms per step."""
    from pdae_torch.tools.profile_autoencode import _busy_us
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train(max_steps=trainer.step + k, save_on_exit=False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if getattr(e.device_type, "name", str(e.device_type)) == "CUDA"]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / k
    return {"busy_ms_per_step": _busy_us([(e.time_range.start, e.time_range.end)
                                          for e in kernels]) / 1e3 / k,
            "kernels_per_step": len(kernels) / k,
            "nccl_kernels": sum(1 for e in kernels if "nccl" in e.name.lower()),
            "events": dict(collections.Counter(e.name for e in kernels)),
            "top_ms_per_step": by_name.most_common(8)}


def all_reduce_ms(trainer, reps: int = 3) -> float:
    """Wall ms of the step's collective alone: a mean all-reduce of
    ``trainer``'s gradients and a loss through a reducer of its own, after
    one untimed. Collective: every rank calls it."""
    from pdae_torch import parallel

    tensors = [torch.zeros((), device=trainer.device)] + [
        p.grad for named in trainer.state.params.values() for p in named.values()]
    reduce = parallel.mean_all_reducer(sum(t.numel() for t in tensors), trainer.device)
    reduce(tensors)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        reduce(tensors)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def start_workers(kind, specs, root) -> tuple:
    """Start one ``chip_smoke.py --ddp-worker`` process per (spec, env) of
    ``specs`` at once; ``finish_workers`` waits for them."""
    procs, outs = [], []
    t0 = time.perf_counter()
    try:
        for i, (spec, env) in enumerate(specs):
            path = os.path.join(root, f"{kind}{i}_spec.json")
            with open(path, "w") as f:
                json.dump(spec, f)
            outs.append(os.path.join(root, f"{kind}{i}.json"))
            # the log goes to a file: a process may run while nobody reads it
            with open(outs[-1] + ".log", "w") as log:
                procs.append(spawn(
                    [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--ddp-worker",
                     path, outs[-1]], cwd=ROOT, env=dict(os.environ, **env), stdout=log,
                    stderr=subprocess.STDOUT))
    except BaseException:
        stop_workers((kind, procs, outs, t0))
        raise
    return kind, procs, outs, t0


def stop_workers(started) -> None:
    """End ``start_workers``' processes that still run, and whatever any of
    them started."""
    for p in started[1]:
        end_group(p)


def finish_workers(started) -> tuple:
    """The outputs of ``start_workers``' processes and the wall seconds since
    their start. A process that fails fails the phase at once: the others,
    waiting for it in a collective, are stopped, and the error names the
    first that failed."""
    kind, procs, outs, t0 = started
    deadline = time.perf_counter() + 900
    try:
        while (any(p.poll() is None for p in procs) and time.perf_counter() < deadline
               and not any(p.returncode not in (None, 0) for p in procs)):
            time.sleep(0.2)
    finally:
        stop_workers(started)
    wall = time.perf_counter() - t0
    failed = [i for i, p in enumerate(procs) if p.returncode != 0]
    if failed:
        i = next((i for i in failed if procs[i].returncode != -signal.SIGKILL), failed[0])
        with open(outs[i] + ".log") as f:
            log = f.read()
        raise AssertionError(f"{kind} process {i} exited {procs[i].returncode}:\n{log[-3000:]}")
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results, wall


def run_workers(kind, specs, root) -> tuple:
    """``start_workers`` then ``finish_workers``: the outputs and the wall
    seconds."""
    return finish_workers(start_workers(kind, specs, root))


def ddp_rel_errors(got, want) -> dict:
    """The largest error of ``got``'s tensors from ``want``'s by category:
    params and EMA absolute, moments and gradients over each tensor's own
    largest value (floored at 1e-4 of the category's largest: a gradient
    that is zero in exact arithmetic is rounding noise in both runs), with
    the tensor that gave it."""
    names = ("param", "ema", "mu", "nu", "grad")
    largest = [max(float(ts[i].abs().max()) for ts in want.values()) for i in range(5)]
    out = {}
    for i, cat in enumerate(names):
        worst, at = 0.0, None
        for k, ts in want.items():
            err = float((got[k][i].double() - ts[i].double()).abs().max())
            if i >= 2:
                err /= max(float(ts[i].abs().max()), 1e-4 * largest[i])
            if err >= worst:
                worst, at = err, k
        key = f"{cat}_abs" if i < 2 else f"{cat}_rel"
        out[key] = {"max": worst, "tensor": at, "tol": DDP_TOL[key],
                    "ok": worst <= DDP_TOL[key]}
    return out


def ddp_phase(seed, device, want_step) -> tuple:
    """Data-parallel training (``param_sharding: replicated``) on the card,
    and the fsdp phase's runs in the same processes (``fsdp_run``): returns
    (the phase's records, those runs' outputs).
    (a) The trainer phase's celeba64 PDAE config at full width as two ranks
    on the one card (both ``LOCAL_RANK`` 0; NCCL refuses two ranks on one
    device, so the tensor group is gloo and the run eager), b32 a rank, fp32
    with TF32 off, ``cudnn.deterministic``: A trains 3 steps saved at 2, B
    resumes from that file to 3. Against it one process (b64) over the same
    64 rows in the ranks' order: the losses, and the largest errors of the
    last reduced gradients, params, EMA and moments, each beside its
    tolerance; the ranks' states bit-equal, B bit-equal to A, only rank 0
    writing, wall ms per step at both world sizes. (b) The same config at
    its shipped K=4 from the captured graph in a process with an NCCL group
    of one rank and in one with no group, side by side: every loss and the
    final state bit-equal, the launches per replay, and the NCCL kernels a
    traced chunk of replays ran. Wall seconds leave out the fsdp runs."""
    import gc
    import shutil

    from pdae_torch.data import Loader
    from pdae_torch.data.pipeline import batch_to_device
    from pdae_torch.train import pick_trainer

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "ddp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    dpm = os.path.join(OUT_DIR, "trainer", "dpm.ckpt")
    cfg = ddp_config(dpm)
    records = {"config": {
        "two_ranks": f"celeba64 PDAE, b{TRAIN_BATCH} a rank x {DDP_RANKS} ranks on one card, "
                     f"gloo tensor group, K=1, {DDP_STEPS} steps saved at {DDP_CUT} and "
                     "resumed there; control: one process at b64 over the ranks' rows",
        "nccl1": f"the same config at K=4 from the captured graph, {DDP_GRAPH_STEPS} steps, "
                 "an NCCL group of one rank against no group",
        "numerics": "fp32, TF32 off, cudnn.deterministic, Adam eps 1e-5",
        "tolerances": DDP_TOL}}
    port = str(free_port())
    env = {"WORLD_SIZE": str(DDP_RANKS), "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": port}
    # the fsdp phase's runs, made by these processes after their own
    fsdp_root = os.path.join(OUT_DIR, "fsdp")
    shutil.rmtree(fsdp_root, ignore_errors=True)
    os.makedirs(fsdp_root)
    fsdp = {"root": fsdp_root, "seed": seed, "cut_dir": os.path.join(fsdp_root, "cut.sharded")}
    spec = {"role": "two_ranks", "root": root, "config": cfg, "seed": seed,
            "cut_file": os.path.join(root, "cut.ckpt"),
            "state_file": os.path.join(root, "rank0_state.pt"),
            "fsdp": {**fsdp, "config": fsdp_config(dpm, 1)},
            "tp": {"root": os.path.join(OUT_DIR, "tp"), "seed": seed,
                   "config": tp_config(dpm), "serve_images": TP_SERVE_IMAGES,
                   "go": os.path.join(OUT_DIR, "tp", "go")},
            "sp": {"root": os.path.join(OUT_DIR, "sp"), "seed": seed,
                   "config": sp_config(dpm), "serve_images": SP_SERVE_IMAGES,
                   "wait_for": os.path.join(OUT_DIR, "sp", "go")}}
    tp_root, sp_root = spec["tp"]["root"], spec["sp"]["root"]
    for d in (tp_root, sp_root):
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
    # the workers share the card with this process: hand back what its
    # earlier phases left cached (cuBLAS's workspaces too)
    gc.collect()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()
    torch.cuda.empty_cache()
    records["main_reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    records["main_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
    fsdp_runs, tp_runs = {}, {}
    # the tp phase's fsdp+tp run: four processes that wait for the two-rank
    # processes' tp train run to end and share the card with their tp
    # service run (tp_phase collects them)
    four = {"role": "four_ranks", "root": tp_root, "seed": seed,
            "wait_for": spec["tp"]["go"], "tp": {
                "root": tp_root, "seed": seed,
                "config": tp_config(dpm, mode="fsdp+tp", batch=TP4_BATCH)},
            "sp": {"root": sp_root, "seed": seed, "go": spec["sp"]["wait_for"],
                   "config": sp_config(dpm, mode="fsdp+sp", batch=SP4_BATCH)},
            "hier": {"root": tp_root, "seed": seed, "config": hier_config(dpm)},
            "after_graphs": os.path.join(tp_root, "graphs_done")}
    env4 = {"WORLD_SIZE": "4", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
            "MASTER_PORT": str(free_port())}
    tp_runs["four_ranks"] = start_workers(
        "tp4_", [(four, {**env4, "RANK": str(r)}) for r in range(4)], tp_root)
    # (b)'s two processes start now too and wait for their turn: their
    # starts overlap the two ranks' runs
    graph_spec = {"root": root, "dpm": dpm, "seed": seed}
    graph_runs = {
        "nccl1": start_workers("nccl", [(
            {**graph_spec, "role": "nccl1", "wait_for": os.path.join(root, "go_nccl1"),
             "after": os.path.join(root, "nogroup_done"),
             "fsdp": {**fsdp, "config": fsdp_config(dpm, 4)},
             "tp": {"root": os.path.join(OUT_DIR, "tp"), "seed": seed,
                    "config": tp_config(dpm, k=4, tp_size=1)}},
            {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
             "MASTER_ADDR": "localhost"})], root),
        "nogroup": start_workers("nogroup", [(
            {**graph_spec, "role": "nogroup", "wait_for": os.path.join(root, "go_nogroup"),
             "done": os.path.join(root, "nogroup_done")},
            {"WORLD_SIZE": "1", "LOCAL_RANK": "0"})], root)}

    def graph_runs_together():
        """Both graph runs' outputs and wall seconds from their go: released
        at once, beside each other (each holds a b32 step), while the four
        processes wait: cuDNN filters its algorithms by the card's free
        memory, so the runs held bit for bit against each other run with the
        same processes beside them."""
        t0 = time.perf_counter()
        for role in graph_runs:
            with open(os.path.join(root, f"go_{role}"), "w"):
                pass
        (nccl,), _ = finish_workers(graph_runs["nccl1"])
        wall = time.perf_counter() - t0
        (alone,), _ = finish_workers(graph_runs["nogroup"])
        return nccl, wall, alone, time.perf_counter() - t0

    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        ranks, wall = run_workers("rank", [(spec, {**env, "RANK": str(r)})
                                           for r in range(DDP_RANKS)], root)
        fsdp_runs["two_ranks"] = [r.pop("fsdp") for r in ranks]
        tp_runs["two_ranks"] = [r.pop("tp") for r in ranks]
        tp_runs["sp_two_ranks"] = [r.pop("sp") for r in ranks]
        r0, r1 = ranks
        rec = {"wall_s": wall - max(r["s"] for r in fsdp_runs["two_ranks"])
               - max(r["s"] for r in tp_runs["two_ranks"])
               - max(r["s"] for r in tp_runs["sp_two_ranks"]),
               "build_s": [r["build_s"] for r in ranks],
               "losses": r0["losses"], "resume_losses": r0["resume_losses"],
               "digest": r0["digest"],
               "ranks_bit_equal": r0["digest"] == r1["digest"]
               and r0["losses"] == r1["losses"],
               "resume_bit_equal": not r0["resume_mismatched"] and not r1["resume_mismatched"]
               and r0["resume_losses"] == r0["losses"][DDP_CUT:]
               and r0["resume_start"] == DDP_CUT,
               "files": {f"rank{r['rank']}": r["files"] for r in ranks},
               "resume_files": {f"rank{r['rank']}": r["resume_files"] for r in ranks},
               "launches_per_rank": {f"rank{r['rank']}": r["launches"] for r in ranks},
               "world2_step_ms": r0["step_ms"], "save_s": r0["save_s"],
               "memory": [r["memory"] for r in ranks],
               "gloo_all_reduce_ms": [r["all_reduce_ms"] for r in ranks]}
        rec["launches_ok"] = all(r["launches"] == {k: v * DDP_STEPS for k, v in want_step.items()}
                                 for r in ranks)
        rec["only_primary_wrote"] = (r1["files"] == [] and r1["resume_files"] == []
                                     and "checkpoints/latest.ckpt" in r0["files"]
                                     and "metrics.jsonl" in r0["files"])
        # one process over the same 64 rows, after the ranks have left the card
        control = pick_trainer(cfg)(
            config={**cfg, "dataloader_config": {
                **cfg["dataloader_config"],
                "train": {**cfg["dataloader_config"]["train"],
                          "batch_size": DDP_RANKS * TRAIN_BATCH}}},
            run_path=os.path.join(root, "control"), seed=seed)
        loaders = [Loader(control.train_dataset, TRAIN_BATCH, shuffle=True, seed=seed,
                          num_workers=4, process_index=r, process_count=DDP_RANKS).infinite()
                   for r in range(DDP_RANKS)]

        def global_batches(start):
            while True:
                parts = [next(it)["x_0"] for it in loaders]
                yield batch_to_device({"x_0": np.concatenate(parts)}, device)

        control._batch_iterator = global_batches
        want_losses, want_ms = timed_losses(control)
        control.train(max_steps=DDP_STEPS, save_on_exit=False)
        want = ddp_state(control)
        got = torch.load(spec["state_file"])
        rec["control_losses"] = want_losses
        rec["world1_b64_step_ms"] = want_ms
        rec["loss_rel"] = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], want_losses))
        rec["errors"] = ddp_rel_errors(got, want)
        del control, got, want
        gc.collect()
        torch.cuda.empty_cache()
        rec["ok"] = bool(rec["ranks_bit_equal"] and rec["resume_bit_equal"]
                         and rec["only_primary_wrote"] and rec["launches_ok"]
                         and rec["loss_rel"] <= DDP_TOL["loss_rel"]
                         and all(v["ok"] for v in rec["errors"].values())
                         and all(math.isfinite(v) for v in r0["losses"]))
        records["two_ranks"] = rec

        # (b) the all-reduce in the captured graph: NCCL at world 1 and the
        # same run with no group, side by side on the card
        nccl, wall, alone, wall_alone = graph_runs_together()
        # the four processes' sp and hier runs take the card once the graph
        # runs, held bit for bit, have left it
        with open(four["after_graphs"], "w"):
            pass
        fsdp_runs["nccl1"] = nccl.pop("fsdp")
        tp_runs["nccl1"] = nccl.pop("tp")
        wall -= fsdp_runs["nccl1"]["s"] + tp_runs["nccl1"]["s"] + nccl["waited_s"]
        rec = {"wall_s": [wall, wall_alone], "tensor_backend": nccl["tensor_backend"],
               "nccl1_waited_s": nccl["waited_s"],
               "card_free_gb": [nccl["card_free_gb"], alone["card_free_gb"]],
               "losses": nccl["losses"], "replays": nccl["replays"],
               "captures": nccl["captures"], "launches_per_replay": nccl["launches_per_replay"],
               "launches_on_path": nccl["launches_on_path"],
               "chunk_step_ms": {"nccl1": nccl["chunk_step_ms"],
                                 "nogroup": alone["chunk_step_ms"]},
               "trace": {"nccl1": nccl["trace"], "nogroup": alone["trace"]},
               "nccl1_all_reduce_ms": nccl["all_reduce_ms"],
               "digest": {"nccl1": nccl["digest"], "nogroup": alone["digest"]},
               "losses_bit_equal": nccl["losses"] == alone["losses"]
               and len(nccl["losses"]) == DDP_GRAPH_STEPS,
               "state_bit_equal": nccl["digest"] == alone["digest"]}
        rec["ok"] = bool(rec["losses_bit_equal"] and rec["state_bit_equal"]
                         and nccl["tensor_backend"] == "nccl"
                         and alone["tensor_backend"] is None
                         and nccl["replays"] == DDP_GRAPH_STEPS - 1
                         and nccl["launches_per_replay"] == want_step
                         and alone["launches_per_replay"] == want_step
                         and nccl["launches_on_path"] == {k: v * DDP_GRAPH_STEPS
                                                  for k, v in want_step.items()})
        records["nccl1_graph"] = rec
    except BaseException:
        for started in (tp_runs["four_ranks"], *graph_runs.values()):
            stop_workers(started)
        raise
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
        for parent, _, names in list(os.walk(root)) + list(os.walk(fsdp_root)):
            for n in names:
                if n.endswith((".ckpt", ".pt", ".msgpack")):
                    os.unlink(os.path.join(parent, n))
    records["phase_s"] = time.perf_counter() - phase_t0
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records, fsdp_runs, tp_runs


def fsdp_config(dpm_path, k) -> dict:
    """``ddp_config`` under ``param_sharding: fsdp`` (``fsdp_min_size``
    2**15, the default) and ``checkpoint_format: sharded``."""
    cfg = ddp_config(dpm_path, k)
    cfg["runner_config"] = {**cfg["runner_config"], "param_sharding": "fsdp",
                            "checkpoint_format": "sharded"}
    return cfg


def gathered_state(trainer, grads=True) -> dict:
    """``ddp_state`` of an FSDP trainer: each trained tensor's param, EMA,
    moments (and reduced gradient) whole, gathered from the ranks' blocks on
    the card (collective), copied to the host."""
    snap = trainer.snapshot_state(full=True)
    masters = trainer.state.masters
    names = [(g, k) for g in masters for k in masters[g]]
    whole = trainer.plan.gather([masters[g][k].grad for g, k in names]) if grads else None
    out = {}
    for i, (g, k) in enumerate(names):
        ts = [snap[c][g][k].clone() for c in ("params", "ema", "mu", "nu")]
        out[f"{g}.{k}"] = ts + ([whole[i].detach().cpu()] if grads else [])
    return out


def step_memory() -> dict:
    """This process's device memory now, between steps (the bytes of its
    live tensors: the state, the resident data, the plan's buffers), and its
    peak since the last reset, in GB."""
    torch.cuda.synchronize()
    return {"between_steps_gb": torch.cuda.memory_allocated() / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def held_bytes(trainer) -> dict:
    """Bytes of state this rank holds between steps under FSDP: EMA, Adam
    moments, the plan's parameters (its blocks of the trained and frozen
    tensors and the tensors it keeps whole) and, apart, the step's flat
    buffers by name; beside them what ``replicated`` holds (every tensor
    whole) and what the layout before blocks at rest held (the whole trained
    and frozen tensors beside the blocks), both reckoned from the shapes."""
    state, opt, plan = trainer.state, trainer.optimizer.state, trainer.plan
    masters = [m for named in state.masters.values() for m in named.values()]
    trained = sum(p.numel() * 4 for named in state.params.values() for p in named.values())
    frozen = sum(p.numel() * 4 for named in plan.frozen.values() for p in named.values())
    out = {"ema": param_nbytes(t for named in state.ema_params.values()
                               for t in named.values()),
           "moments": sum(opt[m][s].numel() * opt[m][s].element_size() for m in masters
                          for s in ("exp_avg", "exp_avg_sq")),
           **plan.held_bytes()}
    out["total"] = sum(out.values())
    out["buffers"] = plan.buffer_bytes()
    out["replicated"] = {"params": trained, "ema": trained, "moments": 2 * trained,
                         "frozen": frozen, "total": 4 * trained + frozen}
    out["pdae_tpu_layout"] = (4 * trained + frozen) / 2
    out["before_blocks_at_rest"] = (out["ema"] + out["moments"] + out["trained_blocks"]
                                    + trained + frozen)
    return out


def collective_ms(trainer, reps: int = 1) -> dict:
    """Wall ms of an FSDP step's collectives alone, after one untimed each:
    the gradients' reduce-scatter with the whole tensors' all-reduce
    (``reduce_grads``, on zero gradients) and one gather of every tensor the
    plan holds (a forward's per-use all-gathers of them, one by one).
    Collective."""
    plan = trainer.plan
    zeros = [torch.zeros_like(p) for named in trainer.state.params.values()
             for p in named.values()]
    loss = torch.zeros((), device=trainer.device)
    keys = [key for _, _, _, key in plan.held]
    out = {"held_tensors": len(keys)}
    for name, fn in (("reduce_grads_ms", lambda: plan.reduce_grads(loss, zeros)),
                     ("gather_each_held_ms", lambda: [plan._whole(k) for k in keys])):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def fsdp_run(spec, kind) -> dict:
    """The fsdp phase's run of ``kind`` in a ddp worker's process group:
    ``two_ranks``, a rank of the gloo run under ``param_sharding: fsdp``
    with ``checkpoint_format: sharded`` (A: 3 steps, its sharded save at 2
    copied aside, B: resumed from that directory), or ``nccl1``, the K=4
    graph run with the NCCL group of one rank. The run directories, which
    both ranks share, are deleted at the end."""
    import gc
    import shutil

    from pdae_torch import ops, parallel
    from pdae_torch.train import pick_trainer

    t0 = time.perf_counter()
    rank, root, cfg = parallel.process_index(), spec["root"], spec["config"]
    out = {"rank": rank, "tensor_backend": parallel.tensor_backend()}
    runs = [os.path.join(root, kind)]
    torch.cuda.reset_peak_memory_stats()
    try:
        if kind == "two_ranks":
            run_a, run_b = runs[0] + "_a", runs[0] + "_b"
            runs = [run_a, run_b, spec["cut_dir"]]
            b0, since = time.perf_counter(), time.time_ns()
            a = pick_trainer(cfg)(config=cfg, run_path=run_a, seed=spec["seed"])
            out["build_s"] = time.perf_counter() - b0
            out["sharded_tensors"] = len(a.plan.sharded)
            out["exceptions"] = a.plan.exceptions
            losses, ms = timed_losses(a)
            ops.reset_launch_counts()
            gathers = a.plan.gathers
            a.train(max_steps=DDP_CUT)               # the final save: sharded, at DDP_CUT
            latest = os.path.join(run_a, "checkpoints", "latest.ckpt")
            shard = os.path.join(latest, f"shard-{DDP_CUT}-{rank:05d}-of-{DDP_RANKS:05d}.msgpack")
            out["shard_bytes"] = os.path.getsize(shard)
            out["save_s"] = traced_saves(since)
            if parallel.is_primary():
                shutil.copytree(latest, spec["cut_dir"])
            parallel.sync_global_devices("copied")
            out["cut_files"] = sorted(os.listdir(spec["cut_dir"]))
            a.train(max_steps=DDP_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
            out["launches"] = named_launches()
            out.update(losses=losses, step_ms=ms, step=a.step, held=held_bytes(a),
                       memory=step_memory(), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       gathers_per_step=(a.plan.gathers - gathers) / DDP_STEPS)
            state = gathered_state(a)
            out["digest"] = state_digest(state)
            out["collectives"] = collective_ms(a)
            del a
            gc.collect()
            torch.cuda.empty_cache()
            b = pick_trainer(cfg)(config=cfg, run_path=run_b, resume=spec["cut_dir"],
                                 seed=spec["seed"])
            out["resume_start"] = b.start_step
            resumed, _ = timed_losses(b)
            b.train(max_steps=DDP_STEPS, save_on_exit=False)
            got = gathered_state(b)
            out["resume_losses"] = resumed
            out["resume_mismatched"] = [k for k, ts in state.items()
                                        if not all(torch.equal(x, y)
                                                   for x, y in zip(ts, got[k]))][:5]
            del b
        else:
            out["card_free_gb"] = torch.cuda.mem_get_info()[0] / 1e9
            tr = pick_trainer(cfg)(config=cfg, run_path=runs[0], seed=spec["seed"])
            losses, ms = timed_losses(tr)
            ops.reset_launch_counts()
            gathers = tr.plan.gathers
            tr.train(max_steps=DDP_GRAPH_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
            d = tr._dispatch
            # the eager warm-up step and each capture gathered once apiece
            per_step = (tr.plan.gathers - gathers) / (1 + len(d.graphs))
            out.update(losses=list(losses), chunk_step_ms=list(ms), step=tr.step,
                       replays=d.replays, captures=len(d.graphs),
                       launches_per_replay=named_launches(d.launches),
                       launches_on_path=path_launches(named_launches(), d),
                       sharded_tensors=len(tr.plan.sharded), held=held_bytes(tr),
                       memory=step_memory(), gathers_per_step=per_step,
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       digest=state_digest(gathered_state(tr, grads=False)))
            out["trace"] = traced_chunk(tr, TRACED_STEPS)
            out["collectives"] = collective_ms(tr)
            drop_graphs(tr)
    except BaseException:
        # a rank that failed leaves at once: a barrier here would wait for
        # the ranks that wait for it in a collective
        raise
    else:
        parallel.sync_global_devices("fsdp_done")
    finally:
        if parallel.is_primary():
            for path in runs:
                shutil.rmtree(path, ignore_errors=True)
    out["s"] = time.perf_counter() - t0
    return out


def fsdp_phase(want_step, ddp, runs) -> dict:
    """FSDP (``param_sharding: fsdp``) on the card, held to the ddp phase's
    ``replicated`` runs of the same config (``ddp``); ``runs`` are the fsdp
    runs the ddp phase's processes made (``fsdp_run``). (a) Two ranks on the
    one card over gloo, eager, b32 a rank, ``checkpoint_format: sharded``: A
    trains 3 steps with its sharded save at 2, B resumes from that directory
    to 3. Every loss and the gathered final state (with the reduced
    gradients) bit-equal to the ddp phase's two ranks (its digest), B
    bit-equal to A, the step-2 directory exactly the manifest and the two
    step-tagged shard files, each rank's launches the structure's per step,
    its bytes of state between steps (EMA, moments, the blocks of the trained
    tensors and of the frozen trunk: blocks at rest) within 2% of
    ``pdae_tpu``'s layout; recorded: those bytes beside ``replicated``'s and
    the layout's before blocks at rest (reckoned), the plan's buffers, the
    device memory between steps and the peak beside the ddp phase's
    ``replicated`` ranks', the per-use gathers a step, the sharded write's
    seconds and bytes beside the ddp phase's full write, the collectives'
    ms. (b) The same config at K=4 from the captured graph with an NCCL group
    of one rank: every loss and the final state bit-equal to the ddp phase's
    K=4 runs (NCCL at world 1 and no group, ``replicated``: without a group
    ``fsdp`` is that same one-process path), the launches per replay the
    structure's, the per-use all-gathers and the reduce-scatter in the trace
    of a chunk of replays; recorded: ms per step beside the ddp phase's K=4
    runs."""
    import shutil

    records = {"config": {
        "two_ranks": f"the ddp phase's celeba64 PDAE run under param_sharding fsdp "
                     f"(fsdp_min_size 2**15) and checkpoint_format sharded, b{TRAIN_BATCH} "
                     f"a rank x {DDP_RANKS} ranks on one card, gloo tensor group, K=1, "
                     f"{DDP_STEPS} steps saved at {DDP_CUT} and resumed there",
        "nccl1": f"the same at K=4 from the captured graph, {DDP_GRAPH_STEPS} steps, an NCCL "
                 "group of one rank",
        "numerics": "fp32, TF32 off, cudnn.deterministic, Adam eps 1e-5",
        "processes": "the ddp phase's, after their own runs"}}
    want_files = ["manifest.msgpack"] + [
        f"shard-{DDP_CUT}-{r:05d}-of-{DDP_RANKS:05d}.msgpack" for r in range(DDP_RANKS)]
    try:
        ranks = runs["two_ranks"]
        r0, r1 = ranks
        want = ddp["two_ranks"]
        rec = {"run_s": [r["s"] for r in ranks], "build_s": [r["build_s"] for r in ranks],
               "sharded_tensors": r0["sharded_tensors"], "exceptions": r0["exceptions"],
               "losses": r0["losses"], "resume_losses": r0["resume_losses"],
               "losses_equal_ddp": r0["losses"] == want["losses"] == r1["losses"],
               "state_equal_ddp": r0["digest"] == want["digest"] == r1["digest"],
               "resume_bit_equal": not r0["resume_mismatched"] and not r1["resume_mismatched"]
               and r0["resume_losses"] == r0["losses"][DDP_CUT:]
               and r0["resume_start"] == DDP_CUT,
               "cut_files": r0["cut_files"],
               "launches_per_rank": {f"rank{r['rank']}": r["launches"] for r in ranks},
               "held_bytes": {f"rank{r['rank']}": r["held"] for r in ranks},
               "peak_gb": [r["peak_gb"] for r in ranks],
               "memory": {"replicated": want["memory"], "fsdp": [r["memory"] for r in ranks]},
               "gathers_per_step": [r["gathers_per_step"] for r in ranks],
               "world2_step_ms": r0["step_ms"], "ddp_world2_step_ms": want["world2_step_ms"],
               "sharded_save_s": {f"rank{r['rank']}": r["save_s"] for r in ranks},
               "shard_bytes": {f"rank{r['rank']}": r["shard_bytes"] for r in ranks},
               "ddp_full_save_s": want["save_s"],
               "collectives_gloo": {f"rank{r['rank']}": r["collectives"] for r in ranks}}
        rec["launches_ok"] = all(r["launches"] == {k: v * DDP_STEPS
                                                   for k, v in want_step.items()}
                                 for r in ranks)
        # a rank holds the blocks of the trained state and of the frozen
        # trunk: pdae_tpu's layout, within 2% (the leaves kept whole)
        rec["held_of_pdae_tpu_layout"] = [r["held"]["total"] / r["held"]["pdae_tpu_layout"]
                                          for r in ranks]
        rec["held_ok"] = all(abs(v - 1) <= 0.02 for v in rec["held_of_pdae_tpu_layout"])
        rec["ok"] = bool(rec["losses_equal_ddp"] and rec["state_equal_ddp"]
                         and rec["resume_bit_equal"] and rec["launches_ok"] and rec["held_ok"]
                         and r0["cut_files"] == want_files and r0["sharded_tensors"] > 0
                         and all(r["gathers_per_step"] > 0 for r in ranks)
                         and all(math.isfinite(v) for v in r0["losses"]))
        records["two_ranks"] = rec

        nccl, graph = runs["nccl1"], ddp["nccl1_graph"]
        trace, replicated = nccl["trace"], graph["trace"]["nccl1"]
        rec = {"run_s": nccl["s"], "tensor_backend": nccl["tensor_backend"],
               "sharded_tensors": nccl["sharded_tensors"], "losses": nccl["losses"],
               "replays": nccl["replays"], "captures": nccl["captures"],
               "launches_per_replay": nccl["launches_per_replay"],
               "launches_on_path": nccl["launches_on_path"],
               "chunk_step_ms": nccl["chunk_step_ms"],
               "ddp_chunk_step_ms": graph["chunk_step_ms"], "held_bytes": nccl["held"],
               "peak_gb": nccl["peak_gb"], "memory": nccl["memory"], "trace": trace,
               "gathers_per_step": nccl["gathers_per_step"],
               "card_free_gb": {"fsdp": nccl["card_free_gb"],
                                "ddp": graph.get("card_free_gb")},
               "ddp_nccl1_kernels_per_step": replicated["kernels_per_step"],
               "collectives_nccl": nccl["collectives"],
               "losses_equal_ddp": nccl["losses"] == graph["losses"]
               and len(nccl["losses"]) == DDP_GRAPH_STEPS,
               "state_equal_ddp": nccl["digest"] == graph["digest"]["nccl1"]
               == graph["digest"]["nogroup"]}
        # the per-use all-gathers and the reduce-scatter replayed in the
        # step's graph: at world 1 NCCL runs each as one copy on the card, so
        # a replayed step holds, beyond the replicated step's device-to-device
        # copies, one for each gather the captured step made and one more
        def copies(counts):
            return sum(c for name, c in counts.items() if "memcpy" in name.lower()
                       and "htod" not in name.lower() and "dtoh" not in name.lower())

        added = (copies(trace["events"]) - copies(replicated["events"])) / TRACED_STEPS
        rec["copies_added_per_step"] = added
        rec["collectives_in_trace"] = added >= nccl["gathers_per_step"] + 1
        rec["ok"] = bool(rec["losses_equal_ddp"] and rec["state_equal_ddp"]
                         and nccl["tensor_backend"] == "nccl" and nccl["sharded_tensors"] > 0
                         and nccl["gathers_per_step"] > 0
                         and nccl["replays"] == DDP_GRAPH_STEPS - 1
                         and nccl["launches_per_replay"] == want_step
                         and nccl["launches_on_path"] == {k: v * DDP_GRAPH_STEPS
                                                          for k, v in want_step.items()}
                         and rec["collectives_in_trace"])
        records["nccl1_graph"] = rec
        # the seconds its runs took in the ddp phase's processes
        records["phase_s"] = max(rec_s for rec_s in records["two_ranks"]["run_s"]) + nccl["s"]
    finally:
        shutil.rmtree(os.path.join(OUT_DIR, "fsdp"), ignore_errors=True)
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


TP_SIZE = 2                      # two model ranks on the one card, over gloo
TP_STEPS = 1                     # b32 steps of the tp run, then its control's
TP4_BATCH = 8                    # a data rank's batch under fsdp+tp at world 4
TP4_STEPS = 1
TP_SERVE_IMAGES = 8              # the tp service's b8 autoencode
TP_SERVE_STYLE = "ddim1"


def tp_config(dpm_path, k=1, mode="tp", tp_size=TP_SIZE, batch=TRAIN_BATCH) -> dict:
    """``ddp_config`` under ``param_sharding`` ``mode`` (``tp`` or
    ``fsdp+tp``) with ``tp_size`` model ranks, ``batch`` a data rank."""
    cfg = ddp_config(dpm_path, k)
    cfg["runner_config"] = {**cfg["runner_config"], "param_sharding": mode,
                            "tp_size": tp_size}
    cfg["dataloader_config"] = {**cfg["dataloader_config"], "train": {
        **cfg["dataloader_config"]["train"], "batch_size": batch}}
    return cfg


def tp_local_keys(counts, tp=TP_SIZE, batch=None) -> collections.Counter:
    """A path's kernel inputs (``path_shapes``' keys) as one of ``tp`` model
    ranks gives them (``parallel/tp.py``): an attention of heads that divide
    by ``tp`` on the rank's heads, a GN chain whose groups divide on the
    rank's channels with its share of the groups (the groups end every GN
    key); ``batch`` replaces the keys' batch."""
    from pdae_torch.models.blocks import num_groups

    out = collections.Counter()
    for k, n in counts.items():
        if batch is not None:
            k = (k[0], batch) + k[2:]
        if k[0] == "attention":
            _, b, h, t, d = k
            out[("attention", b, h // tp, t, d) if h % tp == 0 else k] += n
            continue
        c, g = k[2], num_groups(k[2])
        out[(k[0], k[1], c // tp) + k[3:] + (g // tp,) if g % tp == 0 else k + (g,)] += n
    return out


@contextlib.contextmanager
def recorded_kernel_inputs(seen: collections.Counter):
    """Every launch of the three kernel wrappers while the block runs, keyed
    as ``tp_local_keys`` keys them, counted into ``seen``."""
    from pdae_torch.ops import attention, groupnorm, groupnorm_train

    fwd, bwd, attn = groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda, attention.attention_cuda

    def gn(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None, groups=32,
           **kw):
        seen[("gn",) + tuple(x.shape) + (scale is not None, z_scale is not None,
                                          groups)] += 1
        return fwd(x, gamma, beta, scale, shift, z_scale, z_shift, groups, **kw)

    def gn_bwd(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
               z_shift=None, groups=32, need_dx=True):
        seen[("gn_bwd",) + tuple(x.shape) + (scale is not None, z_scale is not None,
                                              need_dx, groups)] += 1
        return bwd(x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                   groups=groups, need_dx=need_dx)

    def att(q, k, v):
        seen[("attention",) + tuple(q.shape)] += 1
        return attn(q, k, v)

    groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda, attention.attention_cuda = gn, gn_bwd, att
    try:
        yield seen
    finally:
        groupnorm.gn_cuda, groupnorm_train.gn_bwd_cuda = fwd, bwd
        attention.attention_cuda = attn


@contextlib.contextmanager
def timed_tp_collectives(record: dict, targets=None):
    """The wall ms and the count of the model group's collectives
    (``parallel/tp.py``'s all-gather, all-reduce and reduce-scatter; or
    ``targets``, ``(module, name)`` pairs) while the block runs, into
    ``record``: the card is synchronised on entry to each (gloo's host copy
    waits for it anyway), so the time is the collective's own; the bytes
    are those of the first argument (a tensor or a list of them)."""
    if targets is None:
        from pdae_torch.parallel import tp
        targets = [(tp, name) for name in ("_all_gather", "_all_reduce", "_reduce_scatter")]
    originals = [(module, name, getattr(module, name)) for module, name in targets]
    record.update(ms=0.0, count=0, bytes=0)

    def timed(fn):
        def wrapped(x, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *args)
            torch.cuda.synchronize()
            record["ms"] += (time.perf_counter() - t0) * 1e3
            record["count"] += 1
            record["bytes"] += param_nbytes(x if isinstance(x, (list, tuple)) else [x])
            return out
        return wrapped

    for module, name, fn in originals:
        setattr(module, name, timed(fn))
    try:
        yield record
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def tp_all_gather_ms(groups, device, reps: int = 5) -> dict:
    """Wall ms of the model group's all-gather alone (``parallel/tp.py``),
    after one untimed, of a tiny block (an AdaGN ``[32, 2C]`` half) and of
    a 64x64-level activation block (``[32, 64, 64, 64]``, 32 MiB): the
    latency and the rate of the transport under the tp step. Collective."""
    from pdae_torch.parallel import tp

    out = {}
    for name, shape in (("tiny_32x128", (32, 128)), ("block_32MiB", (32, 64, 64, 64))):
        x = torch.ones(shape, device=device)
        tp._all_gather(x, groups, 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            tp._all_gather(x, groups, 1)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3 / reps
    return out


def tp_state(trainer) -> dict:
    """``ddp_state`` of a tensor-parallel trainer: each trained tensor's
    param, EMA, moments and reduced gradient whole, gathered from the ranks'
    blocks on the card (collective), copied to the host."""
    snap = trainer.snapshot_state(full=True)
    masters, params = trainer.state.masters, trainer.state.params
    names = [(g, k) for g in masters for k in masters[g]]
    grads = [masters[g][k].grad for g, k in names]
    if trainer.plan is not None:
        grads = trainer.plan.gather(grads)
    grads = trainer.tp_layout.gather(grads, [params[g][k] for g, k in names])
    return {f"{g}.{k}": [snap[c][g][k].clone() for c in ("params", "ema", "mu", "nu")]
            + [grads[i].detach().cpu()] for i, (g, k) in enumerate(names)}


def param_nbytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


def tp_held_bytes(trainer) -> dict:
    """Bytes this rank holds: every parameter of its modules (the trained
    ones and the frozen trunk, each its block where sharded), the EMA and
    the Adam moments, beside the bytes each would take whole."""
    modules = [trainer.encoder, trainer.decoder]
    state, opt, plan = trainer.state, trainer.optimizer.state, trainer.plan
    masters = [m for named in state.masters.values() for m in named.values()]
    trained = [p for named in state.params.values() for p in named.values()]
    frozen = [p for m in modules for p in m.parameters() if not p.requires_grad]
    whole = sum(int(np.prod(trainer.tp_layout.whole_shape(p))) * 4 for p in trained)
    held = {"trained_params": param_nbytes(trained), "frozen_params": param_nbytes(frozen)}
    if plan is not None:
        # fsdp+tp: a tensor the plan holds has its block alone, its
        # parameter is a placeholder
        b = plan.held_bytes()
        held = {"trained_params": b["trained_blocks"] + b["trained_whole"],
                "frozen_params": b["frozen_blocks"] + b["frozen_whole"]}
    return {**held,
            "ema": param_nbytes(t for named in state.ema_params.values()
                                for t in named.values()),
            "moments": sum(opt[m][s].numel() * opt[m][s].element_size() for m in masters
                           for s in ("exp_avg", "exp_avg_sq")),
            "trained_elements": sum(int(np.prod(trainer.tp_layout.whole_shape(p)))
                                    for p in trained),
            "replicated": {"trained_params": whole, "ema": whole, "moments": 2 * whole,
                           "frozen_params": sum(
                               int(np.prod(trainer.tp_layout.whole_shape(p))) * 4
                               for p in frozen)}}


def tp_run(spec, kind) -> dict:
    """The tp phase's run of ``kind`` in a ddp worker's process group:
    ``two_ranks``, a rank of the gloo run at tp 2 (``TP_STEPS`` b32 steps,
    the kernels' inputs recorded, then ``PDAEService(tp_size=2)``'s b8
    autoencode); ``four_ranks``, a rank of ``fsdp+tp`` at tp 2 x data 2
    (``TP4_STEPS`` steps at b8 a data rank); ``nccl1``, the tp path at
    ``tp_size`` 1 from the captured graph with the NCCL group of one rank.
    The run directories, which the ranks share, are deleted at the end."""
    import gc
    import shutil

    from pdae_torch import ops, parallel
    from pdae_torch.train import pick_trainer

    t0 = time.perf_counter()
    rank, root, cfg = parallel.process_index(), spec["root"], spec["config"]
    run = os.path.join(root, kind)
    out = {"rank": rank, "tensor_backend": parallel.tensor_backend()}
    gc.collect()
    torch.cuda.empty_cache()          # what the process's earlier runs left cached
    torch.cuda.reset_peak_memory_stats()
    try:
        b0 = time.perf_counter()
        tr = pick_trainer(cfg)(config=cfg, run_path=run, seed=spec["seed"])
        out["build_s"] = time.perf_counter() - b0
        g = tr.tp_layout.groups
        out.update(model_index=g.model_index, data_index=g.data_index,
                   sharded=sum(1 for i in tr.tp_layout.infos.values() if i.role == "block"))
        losses, ms = timed_losses(tr)
        ops.reset_launch_counts()
        if kind == "nccl1":
            tr.train(max_steps=DDP_GRAPH_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
            d = tr._dispatch
            out.update(losses=list(losses), chunk_step_ms=list(ms), step=tr.step,
                       replays=d.replays, launches_per_replay=named_launches(d.launches),
                       launches_on_path=path_launches(named_launches(), d),
                       digest=state_digest(ddp_state(tr, grads=False)))
            drop_graphs(tr)
            return out
        seen, comm = collections.Counter(), {}
        steps = TP_STEPS if kind == "two_ranks" else TP4_STEPS
        with recorded_kernel_inputs(seen), timed_tp_collectives(comm):
            tr.train(max_steps=steps, save_on_exit=False)
            torch.cuda.synchronize()
        out["collectives_per_step"] = {k: v / steps for k, v in comm.items()}
        out.update(losses=losses, step_ms=ms, step=tr.step, launches=named_launches(),
                   kernel_inputs=[[list(k), n] for k, n in sorted(seen.items(), key=str)],
                   held=tp_held_bytes(tr), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        if kind == "two_ranks":
            out["all_gather_ms"] = tp_all_gather_ms(tr.tp_layout.groups, tr.device)
        state = tp_state(tr)
        out["digest"] = state_digest(state)
        if rank == 0:
            torch.save(state, os.path.join(root, f"{kind}_state.pt"))
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
        if kind == "two_ranks":
            # the card's memory is back: the fsdp+tp processes may start
            parallel.sync_global_devices("tp_trained")
            if rank == 0:
                with open(spec["go"], "w"):
                    pass
            out["service"] = tp_service(spec)
    except BaseException:
        # a rank that failed leaves at once: a barrier here would wait for
        # the ranks that wait for it in a collective
        raise
    else:
        parallel.sync_global_devices("tp_done")
    finally:
        if parallel.is_primary():
            shutil.rmtree(run, ignore_errors=True)
        out["s"] = time.perf_counter() - t0
    return out


def tp_service(spec) -> dict:
    """``PDAEService(tp_size=2)`` on the main path's seeded models: one b8
    ``TP_SERVE_STYLE`` autoencode (its seconds hold the first call's
    set-up), its launches, the bytes of parameters this rank holds and its
    result."""
    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM
    from pdae_torch.serving import PDAEService

    decoder, encoder = build_models(spec["seed"], torch.device("cpu"))
    config = {"trained_ddpm_config": CELEBA64_DPM, "decoder_config": {"latent_dim": LATENT},
              "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
              "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
              "image_size": 64, "max_batch": 64, "tp_size": TP_SIZE}
    torch.cuda.reset_peak_memory_stats()
    service = PDAEService(config, encoder.state_dict(), decoder.state_dict())
    del decoder, encoder
    images = np.random.RandomState(spec["seed"]).randint(
        0, 256, (spec["serve_images"], 64, 64, 3), np.uint8)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon = service.autoencode(images, TP_SERVE_STYLE, TP_SERVE_STYLE)
    torch.cuda.synchronize()
    return {"s": time.perf_counter() - t0, "launches": named_launches(),
            "params_bytes": param_nbytes(p for m in (service.encoder, service.decoder)
                                         for p in m.parameters()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "recon": recon.tolist()}


HIER_SHAPE = [2, 2]              # fsdp over two "hosts" of two ranks, on the one card


def hier_config(dpm_path) -> dict:
    """``ddp_config`` under ``param_sharding: fsdp`` with ``mesh_layout:
    hier`` on the ``HIER_SHAPE`` grid, ``TP4_BATCH`` a rank."""
    cfg = tp_config(dpm_path, batch=TP4_BATCH)
    rc = {k: v for k, v in cfg["runner_config"].items() if k != "tp_size"}
    cfg["runner_config"] = {**rc, "param_sharding": "fsdp", "mesh_layout": "hier",
                            "hier_shape": HIER_SHAPE}
    return cfg


def hier_run(spec) -> dict:
    """The tp phase's ``hier`` run, made by the four-rank processes after
    their sp run: a rank of ``fsdp`` on the ``HIER_SHAPE`` host grid
    (blocks over a row of two, averaged over a column of two),
    ``TP4_STEPS`` steps at b``TP4_BATCH``, the kernels' inputs and the plan's
    collectives recorded. The run directory is deleted at the end."""
    import gc
    import shutil

    from pdae_torch import ops, parallel
    from pdae_torch.parallel import dist as pdist
    from pdae_torch.train import pick_trainer

    t0 = time.perf_counter()
    rank, root, cfg = parallel.process_index(), spec["root"], spec["config"]
    run = os.path.join(root, "hier")
    out = {"rank": rank, "tensor_backend": parallel.tensor_backend()}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        b0 = time.perf_counter()
        tr = pick_trainer(cfg)(config=cfg, run_path=run, seed=spec["seed"])
        out["build_s"] = time.perf_counter() - b0
        g = tr.hier_groups
        out.update(layout=tr.mesh_layout, place=[g.row, g.col],
                   sharded=len(tr.plan.sharded) + len(tr.plan.frozen_sharded))
        losses, ms = timed_losses(tr)
        ops.reset_launch_counts()
        seen, comm = collections.Counter(), {}
        plan_collectives = [(pdist, "all_gather_dim"), (pdist, "all_reduce_mean_"),
                            (parallel, "reduce_scatter_mean_")]
        with recorded_kernel_inputs(seen), timed_tp_collectives(comm, plan_collectives):
            tr.train(max_steps=TP4_STEPS, save_on_exit=False)
            torch.cuda.synchronize()
        out["collectives_per_step"] = {k: v / TP4_STEPS for k, v in comm.items()}
        out.update(losses=losses, step_ms=ms, step=tr.step, launches=named_launches(),
                   kernel_inputs=[[list(k), n] for k, n in sorted(seen.items(), key=str)],
                   held=held_bytes(tr), memory=step_memory(),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        state = gathered_state(tr)
        out["digest"] = state_digest(state)
        if rank == 0:
            torch.save(state, os.path.join(root, "hier_state.pt"))
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        # a rank that failed leaves at once: a barrier here would wait for
        # the ranks that wait for it in a collective
        raise
    else:
        parallel.sync_global_devices("hier_done")
    finally:
        if parallel.is_primary():
            shutil.rmtree(run, ignore_errors=True)
        out["s"] = time.perf_counter() - t0
    return out


def tp_phase(seed, device, want_step, per_step, ddp, runs, service, images, bound,
             controls=None) -> dict:
    """Tensor parallelism (``param_sharding: tp``/``fsdp+tp``, the service's
    ``tp_size``) on the card. (a) The ddp phase's celeba64 PDAE config at tp
    2 as two ranks on the one card over gloo, b32, fp32, TF32 off,
    ``cudnn.deterministic``: ``TP_STEPS`` steps against one process over the
    same rows (``DDP_TOL``), the ranks bit-equal, each rank's launches the
    structure's per step, every launch's input at the rank's local shape
    (``tp_local_keys``); recorded: bytes of parameters, EMA and moments and
    the peak memory per rank beside ``replicated``'s, ms per step beside the
    ddp phase's. (b) ``PDAEService(tp_size=2)``'s b8 ``TP_SERVE_STYLE``
    autoencode against the one-process service, within the larger of one
    uint8 level and ``bound`` (the whole-path phase's control). (c)
    ``fsdp+tp`` at world 4 (tp 2 x data 2), b8 a data rank, ``TP4_STEPS``
    steps against one process over the 16 rows. (d) The tp path at
    ``tp_size`` 1 with an NCCL group of one rank, from the captured graph at
    K=4: bit-equal to the ddp phase's ``replicated`` K=4 run. (e) ``fsdp``
    under ``mesh_layout: hier`` on the ``HIER_SHAPE`` grid, the four
    processes' last run: b``TP4_BATCH`` a rank, ``TP4_STEPS`` steps against
    one process over the 32 rows, each rank's launches the structure's. The
    one-process runs and the service's result go into ``controls``, and
    the four processes' sp runs into ``runs["sp_four_ranks"]``, for the sp
    phase."""
    import gc
    import shutil

    from pdae_torch.data import Loader
    from pdae_torch.data.pipeline import batch_to_device
    from pdae_torch.train import pick_trainer

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "tp")
    dpm = os.path.join(OUT_DIR, "trainer", "dpm.ckpt")
    records = {"config": {
        "two_ranks": f"celeba64 PDAE at tp {TP_SIZE}, b{TRAIN_BATCH}, {TP_SIZE} ranks on one "
                     f"card, gloo tensor group, K=1, {TP_STEPS} steps; control: one process",
        "service": f"PDAEService(tp_size={TP_SIZE}), b{TP_SERVE_IMAGES} "
                   f"{TP_SERVE_STYLE}/{TP_SERVE_STYLE} autoencode; control: one process",
        "four_ranks": f"fsdp+tp, tp {TP_SIZE} x data 2 on one card, b{TP4_BATCH} a data "
                      f"rank, {TP4_STEPS} steps; control: one process at b{2 * TP4_BATCH}",
        "nccl1": f"the tp path at tp_size 1, K=4 from the captured graph, {DDP_GRAPH_STEPS} "
                 "steps, an NCCL group of one rank; against the ddp phase's replicated run",
        "hier": f"fsdp under mesh_layout hier, hier_shape {HIER_SHAPE} on one card, "
                f"b{TP4_BATCH} a rank, {TP4_STEPS} steps; control: one process at "
                f"b{4 * TP4_BATCH}",
        "numerics": "fp32, TF32 off, cudnn.deterministic, Adam eps 1e-5",
        "tolerances": DDP_TOL}}
    saved_flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        def control(cfg, ranks, batch, steps):
            """One process over the ``ranks`` data ranks' rows at ``batch``
            each, ``steps`` steps: its losses and state."""
            tr = pick_trainer(cfg)(config={**cfg, "runner_config": {
                **cfg["runner_config"], "param_sharding": "replicated"},
                "dataloader_config": {**cfg["dataloader_config"], "train": {
                    **cfg["dataloader_config"]["train"], "batch_size": ranks * batch}}},
                run_path=os.path.join(root, "control"), seed=seed)
            loaders = [Loader(tr.train_dataset, batch, shuffle=True, seed=seed,
                              num_workers=4, process_index=r, process_count=ranks).infinite()
                       for r in range(ranks)]
            tr._batch_iterator = lambda start: (batch_to_device(
                {"x_0": np.concatenate([next(it)["x_0"] for it in loaders])}, device)
                for _ in iter(int, 1))
            losses, ms = timed_losses(tr)
            tr.train(max_steps=steps, save_on_exit=False)
            state = ddp_state(tr)
            del tr
            gc.collect()
            torch.cuda.empty_cache()
            shutil.rmtree(os.path.join(root, "control"), ignore_errors=True)
            return losses, ms, state

        # the one-process runs the tp runs are held to, and the one-process
        # service's autoencode, beside the four processes' sp and hier runs
        made = {"two_ranks": control(tp_config(dpm), 1, TRAIN_BATCH, TP_STEPS),
                "four_ranks": control(tp_config(dpm, batch=TP4_BATCH), 2, TP4_BATCH,
                                      TP4_STEPS),
                "hier": control(tp_config(dpm, batch=TP4_BATCH), 4, TP4_BATCH, TP4_STEPS),
                "service": service.autoencode(images[:TP_SERVE_IMAGES], TP_SERVE_STYLE,
                                              TP_SERVE_STYLE)}
        if controls is not None:
            controls.update(made)
        # (c) ran in four processes of their own beside the two ranks' tp run
        four, wall4 = finish_workers(runs["four_ranks"])
        runs["sp_four_ranks"] = [r.pop("sp") for r in four]
        hier = [r.pop("hier") for r in four]
        four = [r["tp"] for r in four]

        def held_to(run, kind, ranks, batch, steps, want_launches, tp=TP_SIZE):
            r0 = run[0]
            want_losses, want_ms, want = made[kind]
            got = torch.load(os.path.join(root, f"{kind}_state.pt"))
            rec = {"run_s": [r["s"] for r in run], "build_s": [r["build_s"] for r in run],
                   "sharded_tensors": r0["sharded"], "losses": r0["losses"],
                   "control_losses": want_losses, "step_ms": r0["step_ms"],
                   "control_step_ms": want_ms,
                   "loss_rel": max(abs(a - b) / abs(b)
                                   for a, b in zip(r0["losses"], want_losses)),
                   "errors": ddp_rel_errors(got, want),
                   "ranks_bit_equal": all(r["digest"] == r0["digest"]
                                          and r["losses"] == r0["losses"] for r in run),
                   "launches_per_rank": {f"rank{r['rank']}": r["launches"] for r in run},
                   "collectives_per_step": [r["collectives_per_step"] for r in run],
                   "all_gather_ms": [r.get("all_gather_ms") for r in run],
                   "collective_share": [r["collectives_per_step"]["ms"] / (
                       sum(r["step_ms"]) / len(r["step_ms"])) for r in run],
                   "held_bytes": {f"rank{r['rank']}": r["held"] for r in run},
                   "peak_gb": [r["peak_gb"] for r in run]}
            rec["launches_ok"] = all(r["launches"] == {k: v * steps for k, v in
                                                       want_launches.items()} for r in run)
            local = {str(list(k)): n * steps for k, n in tp_local_keys(
                per_step, tp=tp, batch=batch).items()}
            rec["kernel_inputs_local"] = all(
                {str(k): n for k, n in r["kernel_inputs"]} == local for r in run)
            rec["ok"] = bool(rec["loss_rel"] <= DDP_TOL["loss_rel"]
                             and all(v["ok"] for v in rec["errors"].values())
                             and rec["ranks_bit_equal"] and rec["launches_ok"]
                             and rec["kernel_inputs_local"] and r0["sharded"] > 0
                             and all(math.isfinite(v) for v in r0["losses"]))
            os.unlink(os.path.join(root, f"{kind}_state.pt"))
            return rec

        # (a) two ranks at tp 2 (their runs came from the ddp phase's processes)
        two = runs["two_ranks"]
        rec = held_to(two, "two_ranks", 1, TRAIN_BATCH, TP_STEPS, want_step)
        rec["ddp_world2_step_ms"] = ddp["two_ranks"]["world2_step_ms"]
        records["two_ranks"] = rec
        rec = held_to(four, "four_ranks", 2, TP4_BATCH, TP4_STEPS, want_step)
        records["four_ranks"] = rec
        # (e) fsdp on the [2, 2] host grid, held to one process over its 32 rows
        rec = held_to(hier, "hier", 4, TP4_BATCH, TP4_STEPS, want_step, tp=1)
        rec.update(places=[r["place"] for r in hier], memory=[r["memory"] for r in hier],
                   layout=[r["layout"] for r in hier])
        rec["ok"] = bool(rec["ok"] and rec["layout"] == ["hier"] * 4
                         and rec["places"] == [[0, 0], [0, 1], [1, 0], [1, 1]])
        records["hier"] = rec
        # (b) the service
        got = [np.asarray(r["service"]["recon"], np.uint8) for r in two]
        want = made["service"]
        diff = max(int(np.abs(g.astype(int) - want.astype(int)).max()) for g in got)
        srv = [r["service"] for r in two]
        records["service"] = {
            "s": [r["s"] for r in srv], "peak_gb": [r["peak_gb"] for r in srv],
            "params_bytes": [r["params_bytes"] for r in srv],
            "launches_per_rank": {f"rank{r['rank']}": r["service"]["launches"] for r in two},
            "max_uint8_diff": diff, "bound_uint8": max(1, bound),
            "ranks_equal": all(np.array_equal(g, got[0]) for g in got),
            "ok": diff <= max(1, bound) and all(np.array_equal(g, got[0]) for g in got)
            and all(r["launches"]["attention"] > 0 and r["launches"]["gn_adagn_silu"] > 0
                    for r in srv)}
        # (d) tp_size 1 from the graph against the replicated K=4 run
        n1 = runs["nccl1"]
        rec = {"losses": n1["losses"], "chunk_step_ms": n1["chunk_step_ms"],
               "launches_on_path": n1["launches_on_path"],
               "tensor_backend": n1["tensor_backend"],
               "digest": n1["digest"], "replicated_digest": ddp["nccl1_graph"]["digest"]["nccl1"],
               "losses_equal_replicated": n1["losses"] == ddp["nccl1_graph"]["losses"],
               "state_equal_replicated": n1["digest"] == ddp["nccl1_graph"]["digest"]["nccl1"]}
        rec["ok"] = bool(rec["losses_equal_replicated"] and rec["state_equal_replicated"]
                         and n1["tensor_backend"] == "nccl" and n1["sharded"] == 0
                         and n1["replays"] == DDP_GRAPH_STEPS - 1
                         and n1["launches_per_replay"] == want_step
                         and n1["launches_on_path"] == {k: v * DDP_GRAPH_STEPS
                                                        for k, v in want_step.items()})
        records["nccl1_graph"] = rec
        records["shapes"] = {"two_ranks": two[0]["kernel_inputs"],
                             "four_ranks": four[0]["kernel_inputs"]}
        records["run_s"] = {"two_ranks": max(r["s"] for r in two),
                            "four_ranks": max(r["s"] for r in four), "nccl1": n1["s"],
                            "hier": max(r["s"] for r in hier),
                            "four_ranks_wall_from_ddp_start": wall4}
    finally:
        stop_workers(runs["four_ranks"])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_flags
        shutil.rmtree(root, ignore_errors=True)
    records["phase_s"] = time.perf_counter() - phase_t0 + records.get("run_s", {}).get(
        "two_ranks", 0.0) + records.get("run_s", {}).get("nccl1", 0.0)
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


SP_SIZE = 2                      # two ranks share every image's rows on the one card
SP_STEPS = TP_STEPS              # b32 steps of the sp run: the tp run's control serves it
SP4_BATCH, SP4_STEPS = TP4_BATCH, TP4_STEPS   # fsdp+sp at world 4: the fsdp+tp run's control
SP_SERVE_IMAGES = (8, 1)         # the sp service's autoencode requests
SP_SERVE_STYLE = TP_SERVE_STYLE  # the tp phase's one-process b8 result serves as control
SP_PASSES = ("gn_stats", "gn_apply", "gn_bwd_moments", "gn_bwd_dx")


def sp_config(dpm_path, mode="sp", batch=TRAIN_BATCH) -> dict:
    """``ddp_config`` under ``param_sharding`` ``mode`` (``sp`` or
    ``fsdp+sp``) with ``SP_SIZE`` ranks per image, ``batch`` a data rank."""
    cfg = ddp_config(dpm_path)
    cfg["runner_config"] = {**cfg["runner_config"], "param_sharding": mode,
                            "sp_size": SP_SIZE}
    cfg["dataloader_config"] = {**cfg["dataloader_config"], "train": {
        **cfg["dataloader_config"]["train"], "batch_size": batch}}
    return cfg


def sp_local_keys(counts, sp=SP_SIZE, batch=None) -> collections.Counter:
    """A path's kernel inputs (``path_shapes``' keys) as one of ``sp`` ranks
    gives them (``parallel/sp.py``): a map whose height divides by ``sp`` on
    the rank's rows, its GN chain as the stats and apply passes (a backward
    as the moments pass, and the dx pass where the chain's input needs one),
    its attention as ``("attention", B, H, Tq, Tk, D)`` with the rank's
    queries against every key; a map that does not divide stays whole, on
    the fused kernels. ``batch`` replaces the keys' batch."""
    out = collections.Counter()
    for k, n in counts.items():
        if batch is not None:
            k = (k[0], batch) + k[2:]
        if k[0] == "attention":
            _, b, h, t, d = k
            q = t // sp if math.isqrt(t) % sp == 0 else t
            out[("attention", b, h, q, t, d)] += n
            continue
        if k[3] % sp:
            out[k] += n
            continue
        local = (k[1], k[2], k[3] // sp, k[4])
        if k[0] == "gn":
            out[("gn_stats",) + local] += n
            out[("gn_apply",) + local + k[5:7]] += n
        else:
            out[("gn_bwd_moments",) + local + k[5:7]] += n
            if k[7]:
                out[("gn_bwd_dx",) + local + k[5:7]] += n
    return out


def sp_launches(local) -> dict:
    """The launch counts of ``sp_local_keys``' keys, as ``ops.launch_counts``
    names them (the fused GN kernels' launches too: none where every map
    splits)."""
    out = {"attention": 0, "gn_adagn_silu": 0, "gn_adagn_silu_bwd": 0}
    for k, n in local.items():
        name = {"gn": "gn_adagn_silu", "gn_bwd": "gn_adagn_silu_bwd"}.get(k[0], k[0])
        out[name] = out.get(name, 0) + n
    return out


@contextlib.contextmanager
def recorded_split_inputs(seen: collections.Counter):
    """Every launch of the kernel wrappers while the block runs, keyed as
    ``sp_local_keys`` keys them, counted into ``seen``."""
    from pdae_torch.ops import attention, groupnorm, groupnorm_train

    orig = {"stats": groupnorm.gn_stats_cuda, "apply": groupnorm.gn_apply_cuda,
            "moments": groupnorm_train.gn_bwd_moments_cuda,
            "dx": groupnorm_train.gn_bwd_dx_cuda, "attn": attention.attention_cuda,
            "gn": groupnorm.gn_cuda, "bwd": groupnorm_train.gn_bwd_cuda}

    def stats(x, groups):
        seen[("gn_stats",) + tuple(x.shape)] += 1
        return orig["stats"](x, groups)

    def apply(x, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
              z_shift=None, groups=32):
        seen[("gn_apply",) + tuple(x.shape) + (scale is not None, z_scale is not None)] += 1
        return orig["apply"](x, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                             groups)

    def moments(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                z_shift=None, groups=32):
        seen[("gn_bwd_moments",) + tuple(x.shape) + (scale is not None,
                                                     z_scale is not None)] += 1
        return orig["moments"](x, g, mean, rstd, gamma, beta, scale, shift, z_scale,
                               z_shift, groups)

    def dx(x, g, mean, rstd, m, gamma, beta, scale=None, shift=None, z_scale=None,
           z_shift=None, groups=32):
        seen[("gn_bwd_dx",) + tuple(x.shape) + (scale is not None, z_scale is not None)] += 1
        return orig["dx"](x, g, mean, rstd, m, gamma, beta, scale, shift, z_scale, z_shift,
                          groups)

    def attn(q, k, v):
        seen[("attention",) + tuple(q.shape[:3]) + (k.shape[2], q.shape[3])] += 1
        return orig["attn"](q, k, v)

    def fused(x, gamma, beta, scale=None, shift=None, z_scale=None, z_shift=None,
              groups=32, **kw):
        seen[("gn",) + tuple(x.shape) + (scale is not None, z_scale is not None)] += 1
        return orig["gn"](x, gamma, beta, scale, shift, z_scale, z_shift, groups, **kw)

    def fused_bwd(x, g, mean, rstd, gamma, beta, scale=None, shift=None, z_scale=None,
                  z_shift=None, groups=32, need_dx=True):
        seen[("gn_bwd",) + tuple(x.shape) + (scale is not None, z_scale is not None,
                                              need_dx)] += 1
        return orig["bwd"](x, g, mean, rstd, gamma, beta, scale, shift, z_scale, z_shift,
                           groups=groups, need_dx=need_dx)

    groupnorm.gn_stats_cuda, groupnorm.gn_apply_cuda = stats, apply
    groupnorm_train.gn_bwd_moments_cuda, groupnorm_train.gn_bwd_dx_cuda = moments, dx
    attention.attention_cuda, groupnorm.gn_cuda = attn, fused
    groupnorm_train.gn_bwd_cuda = fused_bwd
    try:
        yield seen
    finally:
        groupnorm.gn_stats_cuda, groupnorm.gn_apply_cuda = orig["stats"], orig["apply"]
        groupnorm_train.gn_bwd_moments_cuda = orig["moments"]
        groupnorm_train.gn_bwd_dx_cuda = orig["dx"]
        attention.attention_cuda, groupnorm.gn_cuda = orig["attn"], orig["gn"]
        groupnorm_train.gn_bwd_cuda = orig["bwd"]


@contextlib.contextmanager
def timed_sp_collectives(record: dict):
    """The wall ms, the count and the bytes of the sp group's collectives
    (``parallel/sp.py``'s all-gather, all-reduce and reduce-scatter) while
    the block runs, into ``record``, the card synchronised on entry to each
    (as ``timed_tp_collectives``)."""
    from pdae_torch.parallel import sp

    originals = {name: getattr(sp, name) for name in ("_all_gather", "all_reduce",
                                                      "_reduce_scatter")}
    record.update(ms=0.0, count=0, bytes=0)

    def timed(fn):
        def wrapped(x, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x, *args)
            torch.cuda.synchronize()
            record["ms"] += (time.perf_counter() - t0) * 1e3
            record["count"] += 1
            record["bytes"] += x.numel() * x.element_size()
            return out
        return wrapped

    for name, fn in originals.items():
        setattr(sp, name, timed(fn))
    try:
        yield record
    finally:
        for name, fn in originals.items():
            setattr(sp, name, fn)


def sp_state(trainer) -> dict:
    """``ddp_state`` of a spatial-parallel trainer: each trained tensor's
    param, EMA, moments and reduced gradient whole (gathered from the data
    group's blocks under ``fsdp+sp``: collective), copied to the host."""
    snap = trainer.snapshot_state(full=True)
    masters = trainer.state.masters
    names = [(g, k) for g in masters for k in masters[g]]
    grads = [masters[g][k].grad for g, k in names]
    if trainer.plan is not None:
        grads = trainer.plan.gather(grads)
    return {f"{g}.{k}": [snap[c][g][k].clone() for c in ("params", "ema", "mu", "nu")]
            + [grads[i].detach().cpu()] for i, (g, k) in enumerate(names)}


def sp_run(spec, kind) -> dict:
    """The sp phase's run of ``kind`` in a ddp worker's process group:
    ``two_ranks``, a rank of ``PDAEService(sp_size=2)``'s requests, then of
    the gloo run at sp 2 (``SP_STEPS`` b32 steps, the kernels' inputs and
    the collectives recorded); ``four_ranks``, a rank of
    ``fsdp+sp`` at sp 2 x data 2 (``SP4_STEPS`` steps at b8 a data rank).
    The run directories, which the ranks share, are deleted at the end."""
    import gc
    import shutil

    from pdae_torch import ops, parallel
    from pdae_torch.train import pick_trainer

    t0 = time.perf_counter()
    rank, root, cfg = parallel.process_index(), spec["root"], spec["config"]
    run = os.path.join(root, kind)
    out = {"rank": rank, "tensor_backend": parallel.tensor_backend()}
    if "go" in spec:
        # the four-rank processes' tp run has left the card: the two ranks'
        # sp run may take its memory (``wait_for``)
        parallel.sync_global_devices("sp_go")
        if rank == 0:
            with open(spec["go"], "w"):
                pass
    if kind == "two_ranks":
        # the service first, while the four-rank processes' tp run holds the
        # card (the tp service ran beside it too): off the path to their go
        out["service"] = sp_service(spec)
    if "wait_for" in spec:
        w0 = time.perf_counter()
        while not os.path.exists(spec["wait_for"]):
            if time.perf_counter() - w0 > 600:
                raise TimeoutError(f"no {spec['wait_for']}")
            time.sleep(0.2)
        out["waited_s"] = time.perf_counter() - w0
    gc.collect()
    torch.cuda.empty_cache()          # what the process's earlier runs left cached
    torch.cuda.reset_peak_memory_stats()
    try:
        b0 = time.perf_counter()
        tr = pick_trainer(cfg)(config=cfg, run_path=run, seed=spec["seed"])
        out["build_s"] = time.perf_counter() - b0
        g = tr.sp_groups
        out.update(sp_index=g.sp_index, data_index=g.data_index,
                   split_modules=sum(1 for m in (tr.encoder, tr.decoder)
                                     if getattr(m, "sp", None) is g))
        losses, ms = timed_losses(tr)
        seen, comm = collections.Counter(), {}
        steps = SP_STEPS if kind == "two_ranks" else SP4_STEPS
        ops.reset_launch_counts()
        with recorded_split_inputs(seen), timed_sp_collectives(comm):
            tr.train(max_steps=steps, save_on_exit=False)
            torch.cuda.synchronize()
        out["collectives_per_step"] = {k: v / steps for k, v in comm.items()}
        out.update(losses=losses, step_ms=ms, step=tr.step, launches=named_launches(),
                   kernel_inputs=[[list(k), n] for k, n in sorted(seen.items(), key=str)],
                   params_bytes=(param_nbytes(p for m in (tr.encoder, tr.decoder)
                                              for p in m.parameters()) if tr.plan is None
                                 else sum(tr.plan.held_bytes().values())),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        state = sp_state(tr)
        out["digest"] = state_digest(state)
        if rank == 0:
            torch.save(state, os.path.join(root, f"{kind}_state.pt"))
        del tr, state
        gc.collect()
        torch.cuda.empty_cache()
    except BaseException:
        # a rank that failed leaves at once: a barrier here would wait for
        # the ranks that wait for it in a collective
        raise
    else:
        parallel.sync_global_devices("sp_done")
    finally:
        if parallel.is_primary():
            shutil.rmtree(run, ignore_errors=True)
        out["s"] = time.perf_counter() - t0
    return out


def sp_service(spec) -> dict:
    """``PDAEService(sp_size=2)`` on the main path's seeded models: a
    ``SP_SERVE_STYLE`` autoencode of each of ``SP_SERVE_IMAGES`` (the
    first call's seconds hold its set-up), with its launches, its kernels'
    inputs and its result; the service's peak memory."""
    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM
    from pdae_torch.serving import PDAEService

    decoder, encoder = build_models(spec["seed"], torch.device("cpu"))
    config = {"trained_ddpm_config": CELEBA64_DPM, "decoder_config": {"latent_dim": LATENT},
              "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
              "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
              "image_size": 64, "max_batch": 64, "sp_size": SP_SIZE}
    torch.cuda.reset_peak_memory_stats()
    service = PDAEService(config, encoder.state_dict(), decoder.state_dict())
    del decoder, encoder
    images = np.random.RandomState(spec["seed"]).randint(
        0, 256, (max(spec["serve_images"]), 64, 64, 3), np.uint8)
    out = {}
    for n in spec["serve_images"]:
        seen = collections.Counter()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with recorded_split_inputs(seen):
            recon = service.autoencode(images[:n], SP_SERVE_STYLE, SP_SERVE_STYLE)
        torch.cuda.synchronize()
        out[f"b{n}"] = {"s": time.perf_counter() - t0, "launches": named_launches(),
                        "kernel_inputs": [[list(k), c] for k, c in
                                          sorted(seen.items(), key=str)],
                        "recon": recon.tolist()}
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sp_phase(device, per_step, serve_counts, runs, controls, service, images, bound,
             one_process_peak_gb) -> dict:
    """Spatial parallelism (``param_sharding: sp``/``fsdp+sp``, the service's
    ``sp_size``) on the card. (a) The ddp phase's celeba64 PDAE config at sp
    2 as two ranks on the one card over gloo (run by the ddp phase's two
    processes after their tp runs), b32, fp32, TF32 off,
    ``cudnn.deterministic``: ``SP_STEPS`` steps against the tp phase's one
    process over the same rows (``DDP_TOL``), the ranks bit-equal, each
    rank's launches those of ``sp_local_keys`` per step (the split passes,
    no fused GN launch) and every launch's input at the rank's local shape;
    recorded: the collectives' count, bytes and ms per step, ms per step,
    the parameter bytes and the peak memory per rank beside one process's.
    (b) ``PDAEService(sp_size=2)``: a b8 and a b1 ``SP_SERVE_STYLE``
    autoencode against the one-process service within the larger of one
    uint8 level and ``bound``, the ranks equal, the launches and inputs
    ``sp_local_keys``' (``serve_counts``: one request's path keys at each
    batch). (c) ``fsdp+sp`` at world 4 (sp 2 x data 2, the tp phase's four
    processes), b8 a data rank, ``SP4_STEPS`` steps against the tp phase's
    one process over the 16 rows."""
    import shutil

    phase_t0 = time.perf_counter()
    root = os.path.join(OUT_DIR, "sp")
    records = {"config": {
        "two_ranks": f"celeba64 PDAE at sp {SP_SIZE}, b{TRAIN_BATCH}, {SP_SIZE} ranks on one "
                     f"card, gloo tensor group, K=1, {SP_STEPS} steps; control: one process "
                     "(the tp phase's)",
        "service": f"PDAEService(sp_size={SP_SIZE}), b{SP_SERVE_IMAGES[0]} and "
                   f"b{SP_SERVE_IMAGES[1]} {SP_SERVE_STYLE}/{SP_SERVE_STYLE} autoencode; "
                   "control: one process",
        "four_ranks": f"fsdp+sp, sp {SP_SIZE} x data 2 on one card, b{SP4_BATCH} a data "
                      f"rank, {SP4_STEPS} steps; control: one process at b{2 * SP4_BATCH} "
                      "(the tp phase's)",
        "numerics": "fp32, TF32 off, cudnn.deterministic, Adam eps 1e-5",
        "tolerances": DDP_TOL}}
    try:
        def held_to(run, kind, batch, steps):
            r0 = run[0]
            want_losses, want_ms, want = controls[kind]
            got = torch.load(os.path.join(root, f"{kind}_state.pt"))
            local = sp_local_keys(per_step, batch=batch)
            want_launches = {k: v * steps for k, v in sp_launches(local).items()}
            rec = {"run_s": [r["s"] for r in run], "build_s": [r["build_s"] for r in run],
                   "losses": r0["losses"], "control_losses": want_losses,
                   "step_ms": r0["step_ms"], "control_step_ms": want_ms,
                   "loss_rel": max(abs(a - b) / abs(b)
                                   for a, b in zip(r0["losses"], want_losses)),
                   "errors": ddp_rel_errors(got, want),
                   "ranks_bit_equal": all(r["digest"] == r0["digest"]
                                          and r["losses"] == r0["losses"] for r in run),
                   "grid": [[r["sp_index"], r["data_index"]] for r in run],
                   "launches_per_rank": {f"rank{r['rank']}": r["launches"] for r in run},
                   "launches_expected": want_launches,
                   "collectives_per_step": [r["collectives_per_step"] for r in run],
                   "collective_share": [r["collectives_per_step"]["ms"] / (
                       sum(r["step_ms"]) / len(r["step_ms"])) for r in run],
                   "params_bytes": [r["params_bytes"] for r in run],
                   "peak_gb": [r["peak_gb"] for r in run]}
            rec["launches_ok"] = all(r["launches"] == want_launches for r in run)
            want_inputs = {str(list(k)): n * steps for k, n in local.items()}
            rec["kernel_inputs_local"] = all(
                {str(k): n for k, n in r["kernel_inputs"]} == want_inputs for r in run)
            rec["ok"] = bool(rec["loss_rel"] <= DDP_TOL["loss_rel"]
                             and all(v["ok"] for v in rec["errors"].values())
                             and rec["ranks_bit_equal"] and rec["launches_ok"]
                             and rec["kernel_inputs_local"]
                             and all(r["split_modules"] == 2 for r in run)
                             and all(math.isfinite(v) for v in r0["losses"]))
            return rec

        two = runs["sp_two_ranks"]
        rec = held_to(two, "two_ranks", TRAIN_BATCH, SP_STEPS)
        rec["one_process_peak_gb"] = one_process_peak_gb
        records["two_ranks"] = rec
        records["four_ranks"] = held_to(runs["sp_four_ranks"], "four_ranks", SP4_BATCH,
                                        SP4_STEPS)
        srv = {}
        for n in SP_SERVE_IMAGES:
            got = [np.asarray(r["service"][f"b{n}"]["recon"], np.uint8) for r in two]
            want = (controls["service"][:n] if n == TP_SERVE_IMAGES else
                    service.autoencode(images[:n], SP_SERVE_STYLE, SP_SERVE_STYLE))
            diff = max(int(np.abs(g.astype(int) - want.astype(int)).max()) for g in got)
            local = sp_local_keys(serve_counts[n])
            want_inputs = {str(list(k)): c for k, c in local.items()}
            runs_n = [r["service"][f"b{n}"] for r in two]
            srv[f"b{n}"] = {
                "s": [r["s"] for r in runs_n], "max_uint8_diff": diff,
                "bound_uint8": max(1, bound),
                "ranks_equal": all(np.array_equal(g, got[0]) for g in got),
                "launches_per_rank": {f"rank{r['rank']}": r["service"][f"b{n}"]["launches"]
                                      for r in two},
                "launches_expected": sp_launches(local),
                "kernel_inputs_local": all({str(k): c for k, c in r["kernel_inputs"]}
                                           == want_inputs for r in runs_n)}
            srv[f"b{n}"]["ok"] = bool(
                diff <= max(1, bound) and srv[f"b{n}"]["ranks_equal"]
                and srv[f"b{n}"]["kernel_inputs_local"]
                and all(r["launches"] == sp_launches(local) for r in runs_n))
        srv["peak_gb"] = [r["service"]["peak_gb"] for r in two]
        srv["ok"] = all(v["ok"] for k, v in srv.items() if k.startswith("b"))
        records["service"] = srv
        records["shapes"] = {"two_ranks": two[0]["kernel_inputs"],
                             "four_ranks": runs["sp_four_ranks"][0]["kernel_inputs"]}
        records["run_s"] = {"two_ranks": max(r["s"] for r in two),
                            "four_ranks": max(r["s"] for r in runs["sp_four_ranks"])}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    records["phase_s"] = time.perf_counter() - phase_t0 + records.get("run_s", {}).get(
        "two_ranks", 0.0)
    records["ok"] = all(v["ok"] for v in records.values() if isinstance(v, dict) and "ok" in v)
    return records


# the reference-headline program (python -m pdae_torch.headline_eval) as the
# phase runs it: FFHQ128 at full width, the reference's eval batch of 16,
# one batch and one rep of both style pairs, bf16; the tool's 300 train
# steps cut to the script's time limit
HEADLINE_TRAIN_STEPS = 4
HEADLINE_EVAL_BATCH = 16
HEADLINE_TEXTURE = 0.15
HEADLINE_ARGS = ["--size", "128", "--train_steps", str(HEADLINE_TRAIN_STEPS),
                 "--train_batch", str(TRAIN_BATCH), "--eval_batch", str(HEADLINE_EVAL_BATCH),
                 "--eval_n", str(HEADLINE_EVAL_BATCH), "--reps", "1",
                 "--styles", "ddim1000+ddim100,dpm20+dpm20", "--dtype", "bfloat16",
                 "--texture", str(HEADLINE_TEXTURE)]
HEADLINE_KEYS = {"size", "device", "dtype", "train_steps", "train_batch", "train_wall_s",
                 "loss_first", "loss_last", "eval_batch", "eval_n", "texture", "styles",
                 "fast_eval_trade"}


def style_evals(gd, style: str, direction: str) -> int:
    """ShiftUNet evaluations of one ``ddimN`` or ``dpmN`` loop (``ddim1000``
    is 999 on 1000 timesteps)."""
    if style.startswith("dpm"):
        return gd.solver_tables(style, direction=direction).num_steps
    return gd.ddim_schedule(style).num_steps


def headline_phase(seed, device, compared) -> dict:
    """The reference-headline program in this process, as a user runs it:
    ``pdae_torch.headline_eval.main(HEADLINE_ARGS)`` (FFHQ128 ShiftUNet and
    128px encoder, latent 512, a brief bf16 training at b32, then
    ``ddim1000+ddim100`` and ``dpm20+dpm20`` over one b16 batch of textured
    SYNTHETIC images), its functions wrapped to count: the training's
    launches against ``remat_structure`` per step, each roundtrip's model
    calls and launches against the styles' evaluations times the launches
    of one evaluation (``per_call``) plus an encoder pass, each warm-up's
    one evaluation and encoder pass, every GN launch on the cluster
    variant. The kernel keys are read in the training and the warm-ups
    (at the roundtrips' shapes): a global module hook in the roundtrips
    would make the host pace their 1,139 evaluations. Then every kernel key
    the run gave that no earlier phase compared is held to the plain
    versions in fp32 and bf16, the b16 eval keys among them timed
    (``chiprun_out/chip_smoke_headline_shapes.json``); and the
    ``dpm20+dpm20`` roundtrip of the batch on the trained models through
    the kernels, against the plain versions, within PRECISION_RATIO times the plain path's own
    bf16-against-fp32 gap (fp32 twins of the models)."""
    import gc

    from pdae_torch import headline_eval, ops
    from pdae_torch.data import SYNTHETIC

    phase_t0 = time.perf_counter()
    keys = KernelKeys()
    keys.name = "headline"
    calls = collections.Counter()
    built, runs = {}, []
    real = {n: getattr(headline_eval, n) for n in ("build", "train", "evaluate", "autoencode")}

    def snapshot():
        torch.cuda.synchronize()
        return (ops.launch_counts(), ops.gn_variant_counts(), ops.gn_bwd_variant_counts(),
                calls.copy())

    def counting(name):
        def wrapped(*args):
            before = snapshot()
            if name == "autoencode":
                keys.handle.remove()
            try:
                out = real[name](*args)
            finally:
                if name == "autoencode":
                    keys.handle = torch.nn.modules.module.register_module_forward_pre_hook(
                        keys.hook)
            after = snapshot()
            diff = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, before)]
            runs.append({"fn": name, "arg": args[4] if name == "train" else args[1],
                         "launches": named_launches(diff[0]), "gn_variants": diff[1],
                         "gn_bwd_variants": diff[2], "calls": diff[3]})
            return out
        return wrapped

    def build(*args):
        built["models"] = real["build"](*args)
        for model in built["models"][1:]:
            model.register_forward_pre_hook(
                lambda mod, args: calls.update([type(mod).__name__]))
        return built["models"]

    for name in ("train", "evaluate", "autoencode"):
        setattr(headline_eval, name, counting(name))
    headline_eval.build = build
    try:
        t0 = time.perf_counter()
        out = headline_eval.main(HEADLINE_ARGS)
        main_s = time.perf_counter() - t0
    finally:
        for name, fn in real.items():
            setattr(headline_eval, name, fn)
        keys.handle.remove()
    gd, encoder, decoder = built["models"]
    x1 = torch.zeros(1, 3, 128, 128, device=device)
    per_eval = per_call(decoder, x1, torch.zeros(1, dtype=torch.int32, device=device),
                        torch.zeros(1, LATENT, device=device))
    per_enc = per_call(encoder, x1)
    per_step = remat_structure(encoder, decoder)["none"]

    def times(counts, n):
        return {k: n * v for k, v in counts.items()}

    def plus(a, b):
        return {k: a[k] + b[k] for k in a}

    def on_cluster(run, want):     # bf16 models: the NHWC variants
        return (run["gn_variants"] == gn_on(want["gn_adagn_silu"], nhwc=True)
                and run["gn_bwd_variants"] == gn_on(want["gn_adagn_silu_bwd"], nhwc=True))

    launches, launches_ok = {"per_eval": per_eval, "per_encoder_pass": per_enc,
                             "per_train_step": per_step}, True
    for run in runs:
        if run["fn"] == "train":
            want = times(per_step, run["arg"])
            want_calls = {}              # the step's forward calls the models' modules
        elif run["fn"] == "autoencode":
            enc_style, dec_style = run["arg"].split("+")
            evals = style_evals(gd, enc_style, "encode") + style_evals(gd, dec_style, "decode")
            want = plus(times(per_eval, evals), per_enc)
            want_calls = {"ShiftUNet": evals, "SemanticEncoder": 1}
        else:                            # evaluate: its warm-up and its roundtrips
            mine = [r for r in runs if r["fn"] == "autoencode" and r["arg"] == run["arg"]]
            run["warm_up"] = {k: v - sum(r["launches"][k] for r in mine)
                              for k, v in run["launches"].items()}
            want = plus(per_eval, per_enc)
            run["ok"] = bool(run["warm_up"] == want and mine)
            launches_ok &= run["ok"]
            continue
        run["launches_expected"] = want
        run["ok"] = bool(run["launches"] == want and on_cluster(run, want)
                         and (run["fn"] == "train" or run["calls"] == want_calls))
        launches_ok &= run["ok"]
    launches["runs"] = runs

    styles = out.get("styles", {})
    finite = [out["loss_first"], out["loss_last"], out["train_wall_s"]] + [
        v for r in styles.values() for k, v in r.items() if k != "peak_mb"]
    tool_ok = bool(set(out) == HEADLINE_KEYS and len(styles) == 2
                   and all(v is not None and math.isfinite(v) for v in finite)
                   and all(0.0 < r["ssim"] <= 1.0 and r["mse"] >= 0.0
                           and r["imgs_per_sec"] > 0 and r["peak_mb"] > 0
                           for r in styles.values())
                   and out["device"] == torch.cuda.get_device_name(device))

    # every new kernel key against the plain versions, the eval keys (b16) timed
    t0 = time.perf_counter()
    kernel_shapes = compare_keys(
        keys.runs_of(), compared, seed + 18, device, "chip_smoke_headline_shapes.json",
        lambda key: key[0] != "gn_bwd" and key[1] == HEADLINE_EVAL_BATCH)
    kernel_shapes["s"] = time.perf_counter() - t0

    # the fast roundtrip of the batch through the kernels against the plain
    # versions
    t0 = time.perf_counter()
    ds = SYNTHETIC({"image_size": 128, "image_channel": 3, "length": headline_eval.CORPUS})
    idxs = np.arange(headline_eval.EVAL_START, headline_eval.EVAL_START + HEADLINE_EVAL_BATCH)
    x = headline_eval.to_device(headline_eval.synthetic_batch(ds, idxs, HEADLINE_TEXTURE),
                                device)
    pair = headline_eval.FAST_PAIR
    kernel = [headline_eval.autoencode(gd, pair, encoder, decoder, x)]
    _, enc32, dec32 = headline_eval.build(128, torch.float32, device)
    enc32.load_state_dict(encoder.state_dict(), strict=True)
    dec32.load_state_dict(decoder.state_dict(), strict=True)
    ops.set_use_kernels(False)
    try:
        plain = [headline_eval.autoencode(gd, pair, encoder, decoder, x)]
        plain32 = [headline_eval.autoencode(gd, pair, enc32.eval(), dec32.eval(), x)]
    finally:
        ops.set_use_kernels(None)
    whole = within_control(kernel, plain, plain32)
    whole["finite"] = bool(torch.isfinite(kernel[0]).all())
    whole["ok"] = whole["ok"] and whole["finite"]
    whole["s"] = time.perf_counter() - t0
    del built, gd, encoder, decoder, enc32, dec32, kernel, plain, plain32, x
    gc.collect()
    torch.cuda.empty_cache()
    return {"args": " ".join(HEADLINE_ARGS), "tool": out, "tool_ok": tool_ok,
            "main_s": main_s, "launches": launches, "launches_ok": bool(launches_ok),
            "kernel_shapes": kernel_shapes, f"{pair}_kernels_vs_plain": whole,
            "phase_s": time.perf_counter() - phase_t0,
            "ok": bool(tool_ok and launches_ok and kernel_shapes["ok"] and whole["ok"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=("nhwc",), default=None,
                    help="build, then the nhwc phase alone")
    args = ap.parse_args(argv)
    script_t0 = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2

    import pdae_torch
    from pdae_torch import ops, tracing
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
    tracing.enable()             # the phases' save times are its spans (traced_saves)
    device = pdae_torch.resolve_device()
    smi = run_child(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    60)
    smi.check_returncode()
    smi = smi.stdout.strip().splitlines()[0]

    # 1. build ------------------------------------------------------------
    seconds = _build.build()
    emit({"phase": "build", "seconds": seconds, "sources": list(_build.SOURCES),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "ptxas": {src: [ln.strip() for ln in log.splitlines()
                          if "Used" in ln or "spill" in ln]
                    for src, log in _build.build_logs.items()}})

    if args.only == "nhwc":
        rec = nhwc_phase(args.seed, device)
        emit(rec)
        print(smi, flush=True)
        return 0 if rec["ok"] else 1

    # the models of the path, and the shapes they give the kernels
    decoder, encoder = build_models(args.seed, device)
    dec_counts, enc_counts = path_shapes(decoder, encoder, device)
    per_request = {k: STEPS * 2 * dec_counts[k] + enc_counts[k]
                   for k in set(dec_counts) | set(enc_counts)}
    train_dec, train_enc = path_shapes(decoder, encoder, device, train=True)
    per_step = train_dec + train_enc

    # 2. kernels against their plain versions -------------------------------
    # the forward kernels at the shapes of both paths: the request's (b8) and
    # the train step's (b32)
    both = sorted(set(per_request) | set(per_step))
    # the checks draw their inputs on the card, as the stage and precision
    # phases' do: a host draw of the large slabs takes longer than the checks
    check_gen = torch.Generator(device=device).manual_seed(args.seed + 17)
    launch_floor_ms = device_ms(lambda: groupnorm.launch_empty(device))
    attn_res = {k: check_attention(k[1:], check_gen, device)
                for k in both if k[0] == "attention"}
    gn_res = {k: check_gn(k, check_gen, device) for k in both if k[0] == "gn"}
    bwd_res = {k: check_gn_bwd(k, check_gen, device) for k in both if k[0] == "gn_bwd"}
    edges = check_edges(check_gen, device)
    # the shapes of the smaller buckets (the batcher's, and the whole path's
    # b2), compared and variant-checked, not timed
    bucket_res = {}
    for b in BUCKETS:
        for k in sorted(set().union(*path_shapes(decoder, encoder, device, batch=b))):
            bucket_res[k] = (check_attention(k[1:], check_gen, device, timed=False)
                             if k[0] == "attention" else
                             check_gn(k, check_gen, device, timed=False))
    # the shapes a tp rank gives the kernels (the tp phase's runs: the b32
    # step and the b8 request at tp 2, the b8 step of fsdp+tp), compared,
    # not timed
    tp_keys = sorted(set(tp_local_keys(per_step)) | set(tp_local_keys(per_request))
                     | set(tp_local_keys(per_step, batch=TP4_BATCH)))
    tp_res = {k: (check_attention(k[1:], check_gen, device, timed=False)
                  if k[0] == "attention" else
                  check_gn(k, check_gen, device, timed=False) if k[0] == "gn"
                  else check_gn_bwd(k, check_gen, device, timed=False)) for k in tp_keys}
    # the split passes an sp rank launches: timed at the train step's local
    # shapes (b32), compared at those of the fsdp+sp run (b8) and of the sp
    # service's requests; every map of these paths splits, so no fused key
    serve_counts = {}
    for n in SP_SERVE_IMAGES:
        dec_n, enc_n = ((dec_counts, enc_counts) if n == BATCH
                        else path_shapes(decoder, encoder, device, batch=n))
        serve_counts[n] = collections.Counter(
            {k: 2 * int(SP_SERVE_STYLE[len("ddim"):]) * dec_n[k] + enc_n[k]
             for k in set(dec_n) | set(enc_n)})
    sp_step = sp_local_keys(per_step)
    sp_other = set(sp_local_keys(per_step, batch=SP4_BATCH)).union(
        *(sp_local_keys(c) for c in serve_counts.values()))
    sp_res = {k: check_split(k, check_gen, device) for k in sorted(sp_step, key=str)}
    sp_res.update({k: check_split(k, check_gen, device, timed=False)
                   for k in sorted(sp_other - set(sp_res), key=str)})
    failed = [(r["shape"], k) for r in list(attn_res.values()) + list(gn_res.values())
              + list(bwd_res.values()) + list(bucket_res.values()) + list(tp_res.values())
              + list(sp_res.values())
              + edges["attention"]
              + edges["gn_adagn_silu"] + edges["gn_adagn_silu_bwd"]
              for k, v in r["err"].items() if not v["ok"]]
    # a Tq < Tk launch gives those rows of the Tq = Tk launch, and the apply
    # pass on the fused kernel's saved stats gives its output, bit for bit
    failed += [(r["shape"], f"{check}_{name}") for r in sp_res.values()
               for check in ("rows_bit_equal_whole", "equals_fused_on_its_stats")
               for name, same in r.get(check, {}).items() if not same]
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
                   "tp_local": list(tp_res.values()),
                   "sp_local": list(sp_res.values()),
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
          "tp_local": [brief(r, 0, 0) for r in tp_res.values()],
          "sp_local": [brief(r, 0, sp_step.get(k, 0)) for k, r in sp_res.items()],
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
    # the channels-last path of the bf16 models: the NHWC variants
    nhwc = nhwc_phase(args.seed, device)
    emit(nhwc)
    if not nhwc["ok"]:
        raise AssertionError("the NHWC variants or the bf16 models' layout failed their checks")

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
        if variants != gn_on(want["gn_adagn_silu"]):
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
        step_launches.append(named_launches())
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
                and all(v == gn_on(want_step["gn_adagn_silu"])
                        for v in step_variants)
                and all(v == gn_on(want_step["gn_adagn_silu_bwd"])
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

    # the train step's state and the models the phases above compared are
    # done with: their memory goes back to the card now, before the later
    # phases' allocations settle around it (the ddp phase's processes share
    # the card, and cuDNN filters its algorithms by its free memory)
    import gc

    del state, optimizer, params, start, frozen_start, train_step, now, leaves, loss, x_0
    del x, t, zz, eps_k, g_k, eps_p, g_p, noise, grads_k, grads_p, latent, classifier
    del kernel_out, kernel_again, plain_out, x_s, weight
    gc.collect()
    torch.cuda.empty_cache()

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
    celeba64_files = {"celeba64": {
        "config": os.path.join(trainer_dir, "a", "config.yml"),
        "checkpoint": os.path.join(trainer_dir, "a", "checkpoints", "latest.ckpt"),
        "stats": os.path.join(samplers_dir, "synthetic.ckpt"),
        "dpm_config": os.path.join(samplers_dir, "dpm.yml")}}
    stages = stages_phase(args.seed, device, celeba64_files, compared,
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

    # 13. steps_per_dispatch: chunks of steps replayed from a CUDA graph ------
    precision_dir = os.path.join(OUT_DIR, "precision")
    dispatch = dispatch_phase(args.seed, device, {
        **celeba64_files, "celebahq128": celebahq_files(os.path.join(OUT_DIR, "stages"))},
        (os.path.join(precision_dir, "dpm_ffhq.yml"),
         os.path.join(precision_dir, "dpm_ffhq.ckpt")))
    with open(os.path.join(OUT_DIR, "chip_smoke_dispatch.json"), "w") as f:
        json.dump(dispatch, f, indent=1)
    emit({"phase": "dispatch", **dispatch})
    if not dispatch["ok"]:
        raise AssertionError("the dispatch phase failed its checks")

    # 14. data-parallel training: two ranks on the card, NCCL in the graph ---
    ddp, fsdp_runs, tp_runs = ddp_phase(args.seed, device, want_step)
    with open(os.path.join(OUT_DIR, "chip_smoke_ddp.json"), "w") as f:
        json.dump(ddp, f, indent=1)
    emit({"phase": "ddp", **ddp})
    if not ddp["ok"]:
        raise AssertionError("the ddp phase failed its checks")

    # 15. FSDP: two ranks sharded on the card, NCCL's collectives in the graph
    fsdp = fsdp_phase(want_step, ddp, fsdp_runs)
    with open(os.path.join(OUT_DIR, "chip_smoke_fsdp.json"), "w") as f:
        json.dump(fsdp, f, indent=1)
    emit({"phase": "fsdp", **fsdp})
    if not fsdp["ok"]:
        raise AssertionError("the fsdp phase failed its checks")

    # 16. tensor parallelism: two ranks split on the card, four under fsdp+tp
    controls = {}
    tp = tp_phase(args.seed, device, want_step, per_step, ddp, tp_runs, service, images,
                  max(v["bound_uint8"] for v in res["ops"].values()), controls)
    with open(os.path.join(OUT_DIR, "chip_smoke_tp.json"), "w") as f:
        json.dump(tp, f, indent=1)
    emit({"phase": "tp", **{k: v for k, v in tp.items() if k != "shapes"}})
    if not tp["ok"]:
        raise AssertionError("the tp phase failed its checks")

    # 17. spatial parallelism: two ranks on each image's rows, four under fsdp+sp
    sp = sp_phase(device, per_step, serve_counts, tp_runs, controls, service, images,
                  max(v["bound_uint8"] for v in res["ops"].values()), train_peak_gb)
    with open(os.path.join(OUT_DIR, "chip_smoke_sp.json"), "w") as f:
        json.dump(sp, f, indent=1)
    emit({"phase": "sp", **{k: v for k, v in sp.items() if k != "shapes"}})
    if not sp["ok"]:
        raise AssertionError("the sp phase failed its checks")

    # 18. the reference-headline program at FFHQ128 -----------------------------
    headline = headline_phase(args.seed, device, compared)
    emit({"phase": "headline", **headline})
    if not headline["ok"]:
        raise AssertionError("the headline phase failed its checks")
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
    for name, rec in dispatch.items():
        if isinstance(rec, dict) and "g1" in rec:
            runs = [rec[r] for r in ("g1", "g2") if r in rec]
            per_op[f"dispatch_{name}_graph"] = {
                k: sum(r["launches_on_path"][k] for r in runs) for k in rec["structure"]}
    for rank, counts in ddp["two_ranks"]["launches_per_rank"].items():
        per_op[f"ddp_two_ranks_{rank}"] = counts
    per_op["ddp_nccl1_graph"] = ddp["nccl1_graph"]["launches_on_path"]
    for rank, counts in fsdp["two_ranks"]["launches_per_rank"].items():
        per_op[f"fsdp_two_ranks_{rank}"] = counts
    per_op["fsdp_nccl1_graph"] = fsdp["nccl1_graph"]["launches_on_path"]
    for run in ("two_ranks", "four_ranks"):
        for rank, counts in tp[run]["launches_per_rank"].items():
            per_op[f"tp_{run}_{rank}"] = counts
    per_op["tp_service_rank0"] = tp["service"]["launches_per_rank"]["rank0"]
    per_op["tp_nccl1_graph"] = tp["nccl1_graph"]["launches_on_path"]
    for run in ("two_ranks", "four_ranks"):
        for rank, counts in sp[run]["launches_per_rank"].items():
            per_op[f"sp_{run}_{rank}"] = counts
    for n in SP_SERVE_IMAGES:
        per_op[f"sp_service_b{n}_rank0"] = sp["service"][f"b{n}"]["launches_per_rank"]["rank0"]
    for run in headline["launches"]["runs"]:
        if run["fn"] != "evaluate":
            per_op[f"headline_{run['fn']}_{run['arg']}"] = run["launches"]
    sp_main = sp["two_ranks"]["launches_per_rank"]["rank0"]
    regular_ms = stages["regular"]["kernel_ms_per_step"]
    sp_per = (f"one b{TRAIN_BATCH} train step of one rank at sp {SP_SIZE} (sum over its "
              "launches)")
    emit({"kernels": [
        {**summarise("attention", "pdae_torch/csrc/attention.cu",
                     "pdae_tpu/ops/attention.py:40", attn_res, per_request, per_step,
                     ae_launches["attention"], train_launches["attention"]),
         "launches_per_op": {k: v["attention"] for k, v in per_op.items()},
         "regular_step": regular_ms["attention"],
         "sp_train_step": {**summarise_split("attention", sp_res, sp_step, sp_per),
                           "launches": sp_main["attention"]}},
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
         "launches_per_op": {k: v["gn_adagn_silu_bwd"] for k, v in per_op.items()
                             if k in ("trainer_step", "regular_step", "ingest_step")
                             or (k.startswith(("dispatch_", "ddp_", "fsdp_", "tp_",
                                               "headline_"))
                                 and v["gn_adagn_silu_bwd"])},
         "regular_step": regular_ms["gn_adagn_silu_bwd"]},
        *({"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": sp_main.get(name, 0),
           **summarise_split(name, sp_res, sp_step, sp_per),
           "launches_per_op": {k: v.get(name, 0) for k, v in per_op.items()
                               if k.startswith("sp_")}}
          for name, source, replaces in (
              ("gn_stats", "pdae_torch/csrc/groupnorm.cu", "pdae_tpu/ops/groupnorm.py:55"),
              ("gn_apply", "pdae_torch/csrc/groupnorm.cu", "pdae_tpu/ops/groupnorm.py:55"),
              ("gn_bwd_moments", "pdae_torch/csrc/groupnorm_bwd.cu",
               "pdae_tpu/ops/groupnorm_train.py:196"),
              ("gn_bwd_dx", "pdae_torch/csrc/groupnorm_bwd.cu",
               "pdae_tpu/ops/groupnorm_train.py:196"))),
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
    if sys.argv[1:2] == ["--ddp-worker"]:
        # a process of the ddp phase, likewise
        sys.exit(ddp_worker(*sys.argv[2:4]))
    # a SIGTERM ends the script through its clean-up, which stops the
    # processes it started
    signal.signal(signal.SIGTERM, lambda signum, frame: sys.exit(128 + signum))
    adopt_orphans()
    try:
        code = main()
    finally:
        drop_heavy_files()
        left = stop_children()
        if left:
            print(f"chip_smoke: stopped {len(left)} process(es) still running at its end: "
                  + "; ".join(a[:200] for a in left), file=sys.stderr, flush=True)
    sys.exit(code)
