#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pdae_torch``) on one NVIDIA H100.

Run from the root of the repository, on a machine with a card:

    python3 chip_smoke.py [--seed N]

Phases, one JSON line each; any failure exits non-zero before the last line:

1. ``build``: compile every kernel from ``pdae_torch/csrc`` with nvcc (all
   sources at once) and report the seconds and ptxas's register/spill lines.
2. ``kernels``: every kernel against its plain PyTorch version on the card, at
   every shape the celeba64 autoencode path gives it (read off the models with
   forward hooks), in fp32 with TF32 off and in bf16, both GN modes; with the
   kernel's device time (CUDA-graph replay), its eager per-call time, and the
   plain version's and a PyTorch library call's device times. Every
   comparison in full goes to ``chiprun_out/chip_smoke_kernels.json``.
3. ``serving``: ``PDAEService`` at the full celeba64 width (ShiftUNet
   ``CELEBA64_DPM`` + 64px encoder, latent 512, seeded random weights with the
   zero-init layers perturbed) answers an ``encode`` and an ``autoencode``
   request (b8, ddim100/ddim100). The launch counters, reset just before each
   request, must show exactly the launches the models' structure predicts.
4. ``whole_path``: one full-width ShiftUNet forward at b2 and one b2
   ddim5/ddim5 autoencode with the kernels against the plain versions
   (``set_use_kernels(False)``) on the card.

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
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

LATENT = 512
BATCH = 8
STEPS = 100                      # ddim100 encode + ddim100 decode
HBM_BYTES_PER_S = 3.35e12        # H100 SXM
FP32_FLOPS = 67e12               # H100 SXM, fp32 outside the tensor cores

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
}
WHOLE_PATH_TOL = (1e-4, 1e-3)    # (atol, rtol): one ShiftUNet forward, fp32
# every comparison in full, beside the printed summary
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")


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


def path_shapes(decoder, encoder, device):
    """Count, per input shape, the GN chains and attention blocks of one
    ShiftUNet evaluation and one encoder pass at batch BATCH."""
    from pdae_torch import ops
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain

    dec_counts, enc_counts = collections.Counter(), collections.Counter()
    current = [None]

    def gn_hook(mod, args):
        x = args[0]
        has_st = len(args) > 1 and args[1] is not None
        has_z = len(args) > 3 and args[3] is not None
        current[0][("gn",) + tuple(x.shape) + (has_st, has_z)] += 1

    def attn_hook(mod, args):
        b, c, h, w = args[0].shape
        current[0][("attention", b, mod.num_heads, h * w, c // mod.num_heads)] += 1

    handles = []
    for model in (decoder, encoder):
        for m in model.modules():
            if isinstance(m, GNSiluChain):
                handles.append(m.register_forward_pre_hook(gn_hook))
            elif isinstance(m, AttentionBlock):
                handles.append(m.register_forward_pre_hook(attn_hook))
    ops.set_use_kernels(False)
    try:
        with torch.inference_mode():
            current[0] = dec_counts
            decoder(torch.zeros(BATCH, 3, 64, 64, device=device),
                    torch.zeros(BATCH, dtype=torch.int32, device=device),
                    torch.zeros(BATCH, LATENT, device=device))
            current[0] = enc_counts
            encoder(torch.zeros(BATCH, 3, 64, 64, device=device))
    finally:
        ops.set_use_kernels(None)
        for h in handles:
            h.remove()
    return dec_counts, enc_counts


def check_attention(shape, gen, device):
    from pdae_torch import ops
    from pdae_torch.ops import attention

    b, h, t, d = shape
    scale = 1.0 / math.sqrt(math.sqrt(d))
    res = {"shape": list(shape), "err": {}}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen).to(device, dtype) for _ in range(3))
        got = attention.attention_cuda(q, k, v)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        res["err"][name] = compare(got, ops.reference_attention(q, k, v, scale),
                                   TOL[("attention", dtype)])
        if dtype == torch.float32:
            res.update(timings(
                lambda: attention.attention_cuda(q, k, v),
                lambda: ops.reference_attention(q, k, v, scale),
                lambda: F.scaled_dot_product_attention(q, k, v,
                                                       scale=1.0 / math.sqrt(d))))
            res["bytes"] = 4 * q.numel() * q.element_size()
            res["flops"] = 4 * b * h * t * t * d
    return res


def gn_coefficients(shape, has_st, has_z, gen, device, dtype):
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen).to(device, dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(device)
    beta = (0.1 * torch.randn(c, generator=gen)).to(device)
    # the halves of one [B, 2C] Linear output, strided as the ResBlocks pass them
    st = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(device, dtype).chunk(2, dim=1)
    zz = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(device, dtype).chunk(2, dim=1)
    return (x, gamma, beta, *(st if has_st else (None, None)),
            *(zz if has_z else (None, None)))


def library_gn(x, gamma, beta, s, t, zs, zt, groups):
    y = F.group_norm(x, groups, gamma, beta, 1e-5)
    if s is not None:
        y = y * (1 + s[:, :, None, None]) + t[:, :, None, None]
    if zs is not None:
        y = (1 + zs[:, :, None, None]) * y + zt[:, :, None, None]
    return F.silu(y)


def check_gn(key, gen, device):
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm

    shape, has_st, has_z = key[1:5], key[5], key[6]
    groups = 32
    res = {"shape": list(shape), "adagn": has_st, "z": has_z, "err": {}}
    for dtype in (torch.float32, torch.bfloat16):
        args = gn_coefficients(shape, has_st, has_z, gen, device, dtype)
        got = groupnorm.gn_cuda(*args, groups=groups)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
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
        if dtype == torch.float32:
            res.update(timings(
                lambda: groupnorm.gn_cuda(*args, groups=groups),
                lambda: ops.gn_adagn_silu_fwd(*args, groups=groups),
                lambda: library_gn(*args, groups)))
            res["bytes"] = (2 * x.numel() * x.element_size() + 8 * shape[1]
                            + sum(a.numel() * a.element_size()
                                  for a in (s, t, zs, zt) if a is not None))
            res["flops"] = 15 * x.numel()
    return res


def brief(res, launches) -> dict:
    """A per-shape record for the printed line: the launches per request at
    this shape, max abs/rel errors (3 digits; in full in the json file) and
    times."""
    out = {k: v for k, v in res.items() if k not in ("err", "bytes", "flops")}
    out["launches_per_request"] = launches
    for kind in ("max_abs_err", "max_rel_err"):
        out[kind] = {k: float(f"{v[kind]:.3g}") for k, v in res["err"].items()}
    out["bound_ms"] = max(res["bytes"] / HBM_BYTES_PER_S, res["flops"] / FP32_FLOPS) * 1e3
    return out


def summarise(name, source, replaces, results, per_request, launches):
    """One kernel's line: the request's launches, and every time summed over
    the launches of one autoencode request at the path's shapes (fp32)."""
    def total(field):
        return sum(per_request[k] * r[field] for k, r in results.items())

    bytes_, flops = total("bytes"), total("flops")
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches,
            "max_abs_err": max(v["max_abs_err"] for r in results.values()
                               for key, v in r["err"].items()
                               if key.endswith("float32")),
            "ms": total("ms"), "host_ms": total("host_ms"),
            "plain_ms": total("plain_ms"),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": total("library_ms"),
            "per": f"one b{BATCH} ddim{STEPS}/ddim{STEPS} autoencode request "
                   "(sum over its launches)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a card",
              file=sys.stderr)
        return 2

    import pdae_torch
    from pdae_torch import ops
    from pdae_torch.models import CELEBA64_DPM, ShiftUNet, encoder_for_resolution
    from pdae_torch.ops import _build
    from pdae_torch.serving import PDAEService

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
    gen = torch.Generator().manual_seed(args.seed)
    torch.manual_seed(args.seed)
    decoder = ShiftUNet(latent_dim=LATENT, **CELEBA64_DPM)
    encoder = encoder_for_resolution(64, LATENT)
    perturb_zero_params(decoder, gen)
    perturb_zero_params(encoder, gen)
    decoder.to(device).eval()
    encoder.to(device).eval()
    dec_counts, enc_counts = path_shapes(decoder, encoder, device)
    per_request = {k: STEPS * 2 * dec_counts[k] + enc_counts[k]
                   for k in set(dec_counts) | set(enc_counts)}

    # 2. kernels against their plain versions -------------------------------
    attn_res = {k: check_attention(k[1:], gen, device)
                for k in sorted(per_request) if k[0] == "attention"}
    gn_res = {k: check_gn(k, gen, device)
              for k in sorted(per_request) if k[0] == "gn"}
    failed = [(r["shape"], k) for r in list(attn_res.values()) + list(gn_res.values())
              for k, v in r["err"].items() if not v["ok"]]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_kernels.json"), "w") as f:
        json.dump({"attention": list(attn_res.values()),
                   "gn_adagn_silu": list(gn_res.values())}, f, indent=1)
    emit({"phase": "kernels", "tolerances": {f"{k[0]}/{str(k[1])[6:]}": v
                                             for k, v in TOL.items()},
          "attention": [brief(r, per_request[k]) for k, r in attn_res.items()],
          "gn_adagn_silu": [brief(r, per_request[k]) for k, r in gn_res.items()],
          "ok": not failed})
    if failed:
        raise AssertionError(f"kernels disagree with their plain versions: {failed}")

    # 3. serving at full width ---------------------------------------------
    config = {"trained_ddpm_config": CELEBA64_DPM,
              "decoder_config": {"latent_dim": LATENT},
              "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": LATENT},
              "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
              "image_size": 64, "max_batch": 64,
              "encoder_ddim_style": f"ddim{STEPS}", "decoder_ddim_style": f"ddim{STEPS}"}
    service = PDAEService(config, encoder.state_dict(), decoder.state_dict())
    images = np.random.RandomState(args.seed).randint(0, 256, (BATCH, 64, 64, 3),
                                                      np.uint8)
    want_enc = {"attention": sum(v for k, v in enc_counts.items() if k[0] == "attention"),
                "gn_adagn_silu": sum(v for k, v in enc_counts.items() if k[0] == "gn")}
    want_ae = {"attention": sum(v for k, v in per_request.items() if k[0] == "attention"),
               "gn_adagn_silu": sum(v for k, v in per_request.items() if k[0] == "gn")}

    service.autoencode(images, "ddim5", "ddim5")          # warm-up, not counted
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    z = service.encode(images)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    enc_launches = ops.launch_counts()
    if z.shape != (BATCH, LATENT) or z.dtype != np.float32 or not np.isfinite(z).all():
        raise AssertionError(f"encode gave {z.shape} {z.dtype}, finite={np.isfinite(z).all()}")

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    recon = service.autoencode(images)
    torch.cuda.synchronize()
    autoencode_s = time.perf_counter() - t0
    ae_launches = ops.launch_counts()
    if recon.shape != images.shape or recon.dtype != np.uint8:
        raise AssertionError(f"autoencode gave {recon.shape} {recon.dtype}")
    emit({"phase": "serving", "batch": BATCH, "styles": f"ddim{STEPS}/ddim{STEPS}",
          "encode_s": encode_s, "autoencode_s": autoencode_s,
          "autoencode_imgs_per_s": BATCH / autoencode_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "encode_launches": enc_launches, "encode_launches_expected": want_enc,
          "autoencode_launches": ae_launches,
          "autoencode_launches_expected": want_ae})
    if enc_launches != want_enc or ae_launches != want_ae:
        raise AssertionError("the launch counters do not match the path's structure")

    # 4. whole path: kernels against plain versions on the card ---------------
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
    ok = res["eps"]["ok"] and res["gradient"]["ok"] and \
        res["autoencode_ddim5_max_uint8_diff"] <= 1
    emit({"phase": "whole_path", "batch": 2, **res, "ok": ok})
    if not ok:
        raise AssertionError("the kernel path disagrees with the plain path")

    emit({"kernels": [
        summarise("attention", "pdae_torch/csrc/attention.cu",
                  "pdae_tpu/ops/attention.py:40", attn_res, per_request,
                  ae_launches["attention"]),
        summarise("gn_adagn_silu", "pdae_torch/csrc/groupnorm.cu",
                  "pdae_tpu/ops/groupnorm.py:55", gn_res, per_request,
                  ae_launches["gn_adagn_silu"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
