"""Sweep the launch plans of the attention and GN kernels on the card.

    python3 -m pdae_torch.tools.tune_kernels [--quick] [--only attention|gn|gn_bwd|nhwc]

Run from the root of the repository: the shapes, the timer, the tolerances
and the inputs are ``chip_smoke.py``'s (the shapes read off the celeba64
models at b8 and b32, ``device_ms``, ``TOL``, ``ATTENTION_EDGES``), so the
sweep measures what the smoke run checks. For each shape it holds the kernel
against its plain version under every candidate plan and prints the device
time per launch (CUDA-graph replay, fp32): the GN forward's cluster variant
over part sizes and block sizes beside the general variant; the GN
backward's cluster variant over cluster sizes and block sizes (``cC_tT``)
beside the general variant, at the train step's 23 backward shapes, in fp32
and (checked, not timed) bf16; the attention kernel over
the built query-tile heights beside ``scaled_dot_product_attention``. The
candidates go through the wrappers' private ``_launch``; the public wrappers
take ``gn_plan``'s, ``gn_bwd_plan``'s and ``attention_plan``'s choice alone,
whose constants were chosen from this table. ``--quick`` builds, checks every plan once (the
attention edge shapes too) and times nothing. One JSON line per shape; the
whole table goes to ``chiprun_out/tune_kernels.json``.

``--only nhwc`` sweeps the GN kernels' NHWC variants instead, at every GN
call of one bf16 FFHQ128 representation step (b32, channels-last; the calls
recorded by ``chip_smoke.nhwc_gn_keys``): ``groupnorm.nhwc_plan`` under each
pixel-row target, least tile, part size and block size (``rR_sS_pP_tT``:
bytes, KB, KB of each operand a block holds, threads), forward and
backward, each held against the plain version and timed in bf16 beside the
plan the wrappers take (``default``) and the NCHW cluster variant on the
same values (``nchw``); one JSON line per call, the table to
``chiprun_out/tune_nhwc.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

import torch
import torch.nn.functional as F

PART_SIZES = (8192, 16384, 32768, 49152, 65536)
BLOCK_SIZES = (128, 256, 512)
BWD_BLOCK_SIZES = (32, 64, 128, 256, 512)
BWD_MAX_PAIR = 196608      # the most of x and g the backward's cluster block takes
NHWC_ROWS = (16, 32, 64, 128, 256)
NHWC_TILES = (2048, 8192, 32768)
NHWC_PARTS = (8192, 16384, 32768, 65536)
NHWC_THREADS = (64, 128, 256)


def attention_candidates(bh, t, d, elt):
    """Every built plan that takes ``[bh, t, d]``, by name."""
    from pdae_torch.ops import attention

    base = attention.attention_plan(bh, t, d, elt)
    bn = 64 if base.mma else base.bn
    plans = {}
    for (bm, tile_bn, warps), rows in attention.BUILT[elt].items():
        r = attention.wv_rows(bm, warps, d)
        if tile_bn == bn and r in rows and bm // r * (d // 4) <= 64 * warps:
            plans[f"bm{bm}w{warps}"] = attention.AttentionPlan(
                bm, bn, warps, r, -(-t // bm) * bh,
                attention.attention_smem_bytes(t, d, elt, bm, bn))
    if elt == 2 and d in attention.MMA_DIMS:
        for bm in attention.MMA_ROWS:
            plans[f"bm{bm}mma"] = attention.AttentionPlan(
                bm, 64, 4, 0, -(-t // bm) * bh,
                attention.attention_mma_smem_bytes(t, d, bm), True)
    plans = {k: p for k, p in plans.items() if p.smem_bytes <= attention.SMEM_LIMIT}
    if base not in plans.values():
        raise AssertionError(f"attention_plan gave {base}, which is not built")
    return base, plans


def gn_bwd_candidates(n, hw, elt, need_dx):
    """The backward's plans for a slab of ``n`` elements, by name: every
    cluster size whose even part the kernel takes, at every block size that
    leaves no warp without a vector."""
    from pdae_torch.ops import groupnorm, groupnorm_train

    vec = 16 // elt
    plans = {"general": groupnorm.GENERAL}
    for cluster in groupnorm.CLUSTER_SIZES:
        if n % (cluster * vec) or 2 * n // cluster * elt > BWD_MAX_PAIR:
            continue
        for threads in BWD_BLOCK_SIZES:
            if threads > 32 and (threads - 32) * vec >= n // cluster:
                continue
            plans[f"c{cluster}_t{threads}"] = groupnorm.GNPlan(
                "cluster", cluster, threads, 2 * n // cluster * elt)
    base = groupnorm_train.gn_bwd_plan(n, hw, elt, need_dx)
    plans[f"c{base.cluster}_t{base.threads}" if base.cluster else "general"] = base
    return base, plans


def nhwc_candidates(c, hw, operands, keep_ok):
    """The NHWC plans of a [B, hw, c] bf16 call, by name (``rR_sS_pP_tT``:
    row bytes, KB of a tile at the least, KB of a part, threads), each once."""
    from pdae_torch.ops import groupnorm

    plans = {}
    for row in NHWC_ROWS:
        for tile in NHWC_TILES:
            for part in NHWC_PARTS:
                for threads in NHWC_THREADS:
                    try:
                        plan = groupnorm.nhwc_plan(c, hw, 32, 2, True, operands, keep_ok, row,
                                                   tile, part * operands, part * operands,
                                                   threads)
                    except ValueError:
                        continue
                    plans.setdefault(
                        plan, f"r{row}_s{tile // 1024}_p{part // 1024}_t{threads}")
    return {name: plan for plan, name in plans.items()}


def nhwc_sweep(cs, dev, quick) -> int:
    from pdae_torch import ops
    from pdae_torch.ops import groupnorm, groupnorm_train

    encoder, decoder = cs.ffhq128_bf16_models(0, dev)
    fwd, bwd, _ = cs.nhwc_gn_keys(cs.ffhq128_bf16_step(encoder, decoder, cs.TRAIN_BATCH,
                                                       dev, 1))
    del encoder, decoder
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(2)
    table, bad = [], []
    for key in sorted(fwd) + sorted(bwd):
        back = key[0] == "gn_bwd"
        shape, has_st, has_z = key[1:5], key[5], key[6]
        need_dx = back and key[7]
        x, gamma, beta, *coef = cs.gn_coefficients(shape, has_st, has_z, gen, dev,
                                                   torch.bfloat16)
        cl = x.contiguous(memory_format=torch.channels_last)
        c, hw = shape[1], shape[2] * shape[3]
        row = {"key": list(key), "calls": (bwd if back else fwd)[key]}
        if back:
            g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            gcl = g.contiguous(memory_format=torch.channels_last)
            _, mean, rstd = groupnorm.gn_cuda(x, gamma, beta, *coef, save_stats=True)
            want = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef,
                                               need_dx=need_dx)
            dx = torch.empty_like(cl) if need_dx else None
            d_a = torch.empty(shape[:2], device=dev)
            d_b = torch.empty_like(d_a)
            default = groupnorm_train.nhwc_plan_for(cl, gcl, dx, 32)
            plans = nhwc_candidates(c, hw, 2, need_dx)

            def launch(plan):
                groupnorm_train._launch_nhwc(plan, cl, gcl, mean, rstd, gamma, beta, *coef,
                                             32, dx, d_a, d_b)

            def check():
                worst = 0.0
                for a, w in zip((dx, d_a, d_b), want):
                    if w is not None:
                        res = cs.compare(a, w, cs.scaled(cs.TOL[("gn_bwd", torch.bfloat16)], w))
                        worst = max(worst, res["max_abs_err"] if res["ok"] else math.inf)
                return worst

            def nchw():
                groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef,
                                            need_dx=need_dx)
        else:
            want = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef)
            out = torch.empty_like(cl)
            default = groupnorm.nhwc_plan_for(cl, out, 32)
            plans = nhwc_candidates(c, hw, 1, True)

            def launch(plan):
                groupnorm._launch_nhwc(plan, cl, out, gamma, beta, *coef, 32)

            def check():
                res = cs.compare(out, want, cs.TOL[("gn_model", torch.bfloat16)])
                return res["max_abs_err"] if res["ok"] else math.inf

            def nchw():
                groupnorm.gn_cuda(x, gamma, beta, *coef)
        plans = {"default": default, **{k: p for k, p in plans.items() if p != default}}
        row["default"] = default._asdict()
        for name, plan in plans.items():
            try:
                launch(plan)
                torch.cuda.synchronize()
            except RuntimeError as err:           # a launch the kernel does not take
                row[name] = str(err)[:60]
                continue
            err = check()
            if not math.isfinite(err):
                bad.append((key, name))
            if not quick:
                row[name] = cs.device_ms(lambda: launch(plan))
        if not quick:
            row["nchw"] = cs.device_ms(nchw)
            timed = {k: v for k, v in row.items() if k in plans and isinstance(v, float)}
            row["best"] = min(timed, key=timed.get) if timed else "default"
        table.append(row)
        print(json.dumps({k: v for k, v in row.items() if k != "default"}), flush=True)
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "tune_nhwc.json"), "w") as f:
        json.dump(table, f, indent=1)
    if not quick:
        for name in ("default", "best", "nchw"):
            total = sum(r["calls"] * (r[r["best"]] if name == "best" else r[name])
                        for r in table)
            print(json.dumps({f"{name}_ms_per_step": total}), flush=True)
    print(json.dumps({"ok": not bad, "bad": bad[:20]}), flush=True)
    return 0 if not bad else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", choices=("attention", "gn", "gn_bwd", "nhwc"), default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tune_kernels: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pdae_torch import ops
    from pdae_torch.ops import _build, attention, groupnorm, groupnorm_train

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(json.dumps({"build_s": _build.build()}), flush=True)
    if args.only == "nhwc":
        return nhwc_sweep(cs, dev, args.quick)
    decoder, encoder, gen = cs.build_models(0, dev)
    shapes = set()
    for train in (False, True):
        for counts in cs.path_shapes(decoder, encoder, dev, train=train):
            shapes |= set(counts)
    table, bad = [], []
    print(json.dumps({"launch_floor_ms": cs.device_ms(lambda: groupnorm.launch_empty(dev))}),
          flush=True)

    attn = sorted(k[1:] for k in shapes if k[0] == "attention")
    if args.quick:
        attn = cs.ATTENTION_EDGES + attn
    for shape in [] if args.only in ("gn", "gn_bwd") else attn:
        b, h, t, d = shape
        for dtype in (torch.float32, torch.bfloat16):
            if (d * dtype.itemsize) % 16:
                continue
            q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype) for _ in range(3))
            want = ops.reference_attention(q, k, v, d ** -0.25)
            base, plans = attention_candidates(b * h, t, d, q.element_size())
            row = {"attention": list(shape), "dtype": str(dtype)[6:], "plan": base}
            for name, plan in plans.items():
                got = attention._launch(plan, q, k, v)
                torch.cuda.synchronize()
                res = cs.compare(got, want, cs.TOL[("attention", dtype)])
                row[f"{name}_err"] = res["max_abs_err"]
                if not res["ok"]:
                    bad.append((shape, str(dtype), name, res["max_abs_err"]))
                if not args.quick:
                    row[f"{name}_ms"] = cs.device_ms(
                        lambda: attention._launch(plan, q, k, v))
            if not args.quick:
                row["library_ms"] = cs.device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=1.0 / math.sqrt(d)))
            table.append(row)
            print(json.dumps(row), flush=True)

    # one coefficient combination per shape: the fullest the path has there
    gn = sorted({k[1:5]: k for k in sorted(shapes) if k[0] == "gn"}.values())
    for key in [] if args.only in ("attention", "gn_bwd") else gn[:: 5 if args.quick else 1]:
        shape, has_st, has_z = key[1:5], key[5], key[6]
        hw = shape[2] * shape[3]
        for dtype in (torch.float32, torch.bfloat16) if args.quick else (torch.float32,):
            x, gamma, beta, *coef = cs.gn_coefficients(shape, has_st, has_z, gen, dev, dtype)
            want, mean_w, rstd_w = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, groups=32,
                                                         return_stats=True)
            zero = torch.zeros(shape[:2], device=dev, dtype=dtype)
            full = [zero if a is None else a for a in coef]
            want_fold = ops.reference_gn_adagn_silu(x, gamma, beta, *full, 32)
            row = {"gn": list(shape), "adagn": has_st, "z": has_z, "dtype": str(dtype)[6:]}
            plans = {"general": groupnorm.GENERAL}
            for part in PART_SIZES:
                for threads in BLOCK_SIZES:
                    p = groupnorm.cluster_plan(shape[1] // 32 * hw, x.element_size(),
                                               part, threads)
                    if p is not None:
                        plans[f"c{p.cluster}_t{p.threads}"] = p
            out, out_fold = torch.empty_like(x), torch.empty_like(x)
            mean, rstd = torch.empty_like(mean_w), torch.empty_like(rstd_w)
            for name, p in plans.items():
                groupnorm._launch(p, x, out, gamma, beta, *coef, 32, False, mean, rstd)
                groupnorm._launch(p, x, out_fold, gamma, beta, *full, 32, True)
                torch.cuda.synchronize()
                for what, a, w in (("gn_model", out, want), ("gn_fold", out_fold, want_fold),
                                   ("gn_stats", mean, mean_w), ("gn_stats", rstd, rstd_w)):
                    res = cs.compare(a, w, cs.TOL[(what, dtype)])
                    if not res["ok"]:
                        bad.append((shape, str(dtype), name, what, res["max_abs_err"]))
                    if what == "gn_model":
                        row[name + "_err"] = res["max_abs_err"]
                if not args.quick:
                    row[name] = cs.device_ms(lambda: groupnorm._launch(
                        p, x, out, gamma, beta, *coef, 32, False))
            table.append(row)
            print(json.dumps(row), flush=True)

    # the backward at every shape of the train step, in both dtypes
    bwd = sorted(k for k in shapes if k[0] == "gn_bwd")
    for key in [] if args.only in ("attention", "gn") else bwd:
        shape, has_st, has_z, need_dx = key[1:5], key[5], key[6], key[7]
        hw = shape[2] * shape[3]
        for dtype in (torch.float32, torch.bfloat16):
            x, gamma, beta, *coef = cs.gn_coefficients(shape, has_st, has_z, gen, dev, dtype)
            g = torch.randn(shape, generator=gen).to(dev, dtype)
            _, mean, rstd = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, groups=32,
                                                  return_stats=True)
            want = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef,
                                               groups=32, need_dx=need_dx)
            base, plans = gn_bwd_candidates(shape[1] // 32 * hw, hw, x.element_size(),
                                            need_dx)
            row = {"gn_bwd": list(shape), "adagn": has_st, "z": has_z, "dx": need_dx,
                   "dtype": str(dtype)[6:], "plan": base._asdict()}
            dx = torch.empty_like(x) if need_dx else None
            d_a = torch.empty(shape[:2], device=dev)
            d_b = torch.empty_like(d_a)
            for name, p in plans.items():
                def run():
                    groupnorm_train._launch(p, x, g, mean, rstd, gamma, beta, *coef, 32,
                                            dx, d_a, d_b)
                run()
                torch.cuda.synchronize()
                err = 0.0
                for what, a, w in zip(("dx", "dA", "dB"), (dx, d_a, d_b), want):
                    if w is None:
                        continue
                    res = cs.compare(a, w, cs.scaled(cs.TOL[("gn_bwd", dtype)], w))
                    err = max(err, res["max_abs_err"])
                    if not res["ok"]:
                        bad.append((shape, str(dtype), name, what, res["max_abs_err"]))
                row[name + "_err"] = err
                if not args.quick and dtype == torch.float32:
                    row[name] = cs.device_ms(run)
            table.append(row)
            print(json.dumps(row), flush=True)

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "tune_kernels.json"), "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps({"ok": not bad, "bad": bad[:20]}), flush=True)
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
