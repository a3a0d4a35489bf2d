"""Operations and bytes of a cell's work, counted from the configuration's
geometry: the yardstick of every roofline and ``mfu`` metric.

The plain reference's models are run once on the ``meta`` device at the
cell's batch (no memory, no arithmetic), and a hook on each layer records
its shapes and which tensors carry a gradient. From those:

* model FLOPs: 2 x the multiply-adds of every convolution, linear layer and
  attention product in the forward and, in a train step, the backward
  products autograd needs (the input's gradient where the input carries one,
  the weight's where the weight trains); recomputation is not counted;
* the GroupNorm+AdaGN+SiLU forward and backward work, each call's bytes
  (every input read once, every output written once) and operations;
* the attention forward's bytes (q, k, v read, the output written) and
  operations (the two products).

``PEAK`` is the table of one H100 SXM's published rates (NVIDIA's data
sheet, dense, at the card's full 700 W).
"""

from __future__ import annotations

import torch

from ..reference import diffusion
from ..reference.model import AttentionBlock, Conv, Conv1, Dense, Norm
from ..reference.train import trained_params
from ..weights import reference_models

PEAK = {"hbm_bytes_per_s": 3.35e12, "fp32_flops": 67e12, "bf16_flops": 989e12}
ELT = {"float32": 4, "bfloat16": 2}
# the operations of one element of the GN chain on the CUDA cores: stats
# (2), normalise (2), affine (2), AdaGN (2), shift-AdaGN (2), SiLU (4); its
# backward about twice that. Against 67 TFLOP/s they bound below the bytes.
GN_FWD_OPS, GN_BWD_OPS = 14, 28
MMA_HEAD_DIMS = (32, 64, 128)     # bf16 attention runs on the tensor cores at these


def _record(models, run):
    """The calls ``run()`` makes into the layers of ``models``: one dict per
    call with its kind, shapes and gradient flags."""
    calls, hooks = [], []

    def mm(mod, args, out):
        x = args[0]
        if isinstance(mod, Dense):
            macs = out.numel() * mod.in_features
        else:
            k = mod.weight.shape[1] * mod.weight[0, 0].numel()
            macs = out.numel() * k
        calls.append({"kind": "mm", "flops": 2 * macs, "x_grad": x.requires_grad,
                      "w_grad": mod.weight.requires_grad, "out_grad": out.requires_grad})

    def norm(mod, args, out):
        x = args[0]
        given = sum(a is not None for a in args[1:])
        calls.append({"kind": "gn", "numel": x.numel(), "batch": x.shape[0],
                      "channels": x.shape[1], "groups": mod.num_groups, "adagn": given,
                      "x_grad": x.requires_grad, "out_grad": out.requires_grad})

    def attention(mod, args, out):
        b, c, h, w = args[0].shape
        calls.append({"kind": "attn", "batch": b, "heads": mod.num_heads, "tokens": h * w,
                      "head_dim": c // mod.num_heads, "out_grad": out.requires_grad})

    for model in models:
        for m in model.modules():
            if isinstance(m, (Conv, Conv1, Dense)):
                hooks.append(m.register_forward_hook(mm))
            elif isinstance(m, Norm):
                hooks.append(m.register_forward_hook(norm))
            elif isinstance(m, AttentionBlock):
                hooks.append(m.register_forward_hook(attention))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls


def model_flops(calls) -> int:
    total = 0
    for c in calls:
        if c["kind"] == "mm":
            total += c["flops"]
            if c["out_grad"]:
                total += c["flops"] * (int(c["x_grad"]) + int(c["w_grad"]))
        elif c["kind"] == "attn":
            fwd = 4 * c["batch"] * c["heads"] * c["tokens"] ** 2 * c["head_dim"]
            total += fwd * (3 if c["out_grad"] else 1)
    return total


def gn_fwd_work(calls, elt: int):
    """[(bytes, ops)] of each GN chain forward: x read, the output written,
    gamma and beta (fp32) and the AdaGN rows read, and where the chain
    trains its fp32 [B, G] mean and rstd written."""
    out = []
    for c in calls:
        if c["kind"] != "gn":
            continue
        b, ch, g = c["batch"], c["channels"], c["groups"]
        stats = 2 * b * g * 4 if c["out_grad"] else 0
        out.append((2 * c["numel"] * elt + 2 * ch * 4 + c["adagn"] * b * ch * elt + stats,
                    GN_FWD_OPS * c["numel"]))
    return out


def gn_bwd_work(calls, elt: int):
    """[(bytes, ops)] of each GN chain backward (the chains a gradient flows
    through): x and the output's gradient read, dx written where x carries
    a gradient, the stats, gamma, beta and AdaGN rows read, and the fp32
    [B, C] partials of the affine written."""
    out = []
    for c in calls:
        if c["kind"] != "gn" or not c["out_grad"]:
            continue
        b, ch, g = c["batch"], c["channels"], c["groups"]
        big = (3 if c["x_grad"] else 2) * c["numel"] * elt
        small = 2 * b * g * 4 + 2 * ch * 4 + c["adagn"] * b * ch * elt + 2 * b * ch * 4
        out.append((big + small, GN_BWD_OPS * c["numel"]))
    return out


def attention_work(calls, elt: int):
    """[(bytes, ops, on tensor cores)] of each attention forward."""
    out = []
    for c in calls:
        if c["kind"] != "attn":
            continue
        n = c["batch"] * c["heads"] * c["tokens"] * c["head_dim"]
        out.append((4 * n * elt, 4 * n * c["tokens"],
                    elt == 2 and c["head_dim"] in MMA_HEAD_DIMS))
    return out


def least_seconds(work, flops_peak: float) -> float:
    """The sum over calls of the larger of bytes / HBM bandwidth and
    operations / ``flops_peak``."""
    return sum(max(b / PEAK["hbm_bytes_per_s"], f / flops_peak) for b, f, *_ in work)


def attention_seconds(work) -> float:
    return sum(max(b / PEAK["hbm_bytes_per_s"],
                   f / PEAK["bf16_flops" if mma else "fp32_flops"]) for b, f, mma in work)


def train_step_calls(config: dict, batch: int):
    """The calls of one representation train step at ``batch``: the encoder,
    the trunk and both decodes forward, and what the loss's gradient with
    respect to the trained leaves flows through."""
    enc, dec = reference_models(config)
    trained_params(enc, dec)          # freezes the trunk
    size = int(config["image_size"])
    tables = {k: v.to("meta") for k, v in diffusion.loss_tables().items()}

    def run():
        x = torch.empty(batch, 3, size, size, device="meta")
        t = torch.zeros(batch, dtype=torch.int32, device="meta")
        diffusion.representation_loss_sum(tables, enc, dec, x, t, torch.empty_like(x))

    return _record((enc, dec), run)


def inference_calls(config: dict, batch: int):
    """(encoder calls, one ShiftUNet evaluation's calls) at ``batch``."""
    enc, dec = reference_models(config)
    size, latent = int(config["image_size"]), int(config["latent_dim"])
    x = torch.empty(batch, 3, size, size, device="meta")
    with torch.no_grad():
        enc_calls = _record((enc,), lambda: enc(x))
        dec_calls = _record((dec,), lambda: dec(
            x, torch.zeros(batch, dtype=torch.int32, device="meta"),
            torch.empty(batch, latent, device="meta")))
    return enc_calls, dec_calls


def train_step(config: dict, batch: int) -> dict:
    """Per train step: model FLOPs, the peak an ``mfu`` takes them against,
    and the least seconds of the GN forward, GN backward and attention
    forward work."""
    calls = train_step_calls(config, batch)
    elt = ELT[config["compute_dtype"]]
    return {"model_flops": model_flops(calls),
            "peak_flops": peak_flops(config["compute_dtype"]),
            "gn_fwd_s": least_seconds(gn_fwd_work(calls, elt), PEAK["fp32_flops"]),
            "gn_bwd_s": least_seconds(gn_bwd_work(calls, elt), PEAK["fp32_flops"]),
            "attention_s": attention_seconds(attention_work(calls, elt))}


def autoencode_request(config: dict, batch: int, evaluations: int) -> dict:
    """Per request (an encoder pass and ``evaluations`` ShiftUNet
    evaluations): model FLOPs, the peak an ``mfu`` takes them against, and
    the least seconds of the GN forward and attention forward work."""
    enc_calls, dec_calls = inference_calls(config, batch)
    calls = enc_calls + dec_calls * evaluations
    elt = ELT[config["compute_dtype"]]
    return {"model_flops": model_flops(calls),
            "peak_flops": peak_flops(config["compute_dtype"]),
            "gn_fwd_s": least_seconds(gn_fwd_work(calls, elt), PEAK["fp32_flops"]),
            "attention_s": attention_seconds(attention_work(calls, elt))}


def peak_flops(dtype: str) -> float:
    """The peak an ``mfu`` is taken against: bf16 on the tensor cores, fp32
    outside them (TF32 off)."""
    return PEAK["bf16_flops" if dtype == "bfloat16" else "fp32_flops"]
