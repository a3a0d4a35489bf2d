"""Channels-last activations in the port's bf16 models, on the CPU.

A model that computes in bf16 and runs unsharded keeps its activations
channels-last (``pdae_torch.models.blocks.nhwc_model``), and the GN chain's
kernels have NHWC variants for them. Held here: the GN chain's plain versions
give the NCHW results bit for bit on channels-last inputs, in x's layout; the
kernel wrappers send each layout to its variant and refuse every other
stride (the launches themselves recorded, on a tensor that reports a card);
the NHWC plans' limits at every GN shape of the bf16 FFHQ128 step; the
layout rule (bf16 models channels-last inside, NCHW outputs and gradients
within bf16 rounding of an NCHW run; fp32, tp and sp models NCHW); and the
encoder's flatten in NCHW order on a converted checkpoint. The kernels run on
the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY_DPM, init_flax, nchw
from pdae_tpu.models import encoder_for_resolution as jax_encoder_for_resolution
from pdae_torch import ops
from pdae_torch.models import SemanticEncoder, ShiftUNet, UNet, blocks, encoder_for_resolution
from pdae_torch.ops import groupnorm, groupnorm_train
from pdae_torch.parallel import sp as sp_mod
from pdae_torch.utils import encoder_state_dict

torch.set_num_threads(1)
CL = torch.channels_last


def _cl(t):
    return t.contiguous(memory_format=CL)


def _chain_inputs(c, dtype, side=4, b=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, side, side, generator=gen).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=gen)
    beta = 0.1 * torch.randn(c, generator=gen)
    st = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(dtype).chunk(2, dim=1)
    zz = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(dtype).chunk(2, dim=1)
    return x, gamma, beta, (*st, *zz)


# the bf16 FFHQ128 step's channel counts (2 to 32 channels a group)
FFHQ128_CHANNELS = [64, 128, 256, 384, 512, 768, 1024]


@pytest.mark.parametrize("channels", FFHQ128_CHANNELS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_gn_forward_and_backward_on_channels_last_equal_nchw(channels, dtype):
    x, gamma, beta, coef = _chain_inputs(channels, dtype)
    want, mean, rstd = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, return_stats=True)
    got, mean_cl, rstd_cl = ops.gn_adagn_silu_fwd(_cl(x), gamma, beta, *coef,
                                                  return_stats=True)
    assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
    assert torch.equal(got, want) and torch.equal(mean_cl, mean) and torch.equal(rstd_cl, rstd)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    want_b = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef)
    got_b = ops.gn_adagn_silu_bwd_plain(_cl(x), _cl(g), mean, rstd, gamma, beta, *coef)
    assert got_b[0].is_contiguous(memory_format=CL)
    for a, b in zip(got_b, want_b):
        assert torch.equal(a, b)


def test_the_function_brings_the_gradient_to_x_layout():
    """The autograd Function on a channels-last x: an NCHW incoming gradient
    is brought to x's layout, dx comes back channels-last, every gradient as
    on the NCHW x."""
    x, gamma, beta, coef = _chain_inputs(128, torch.float32)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    leaves = [gamma, beta, *coef]

    def grads(x_in):
        x_in = x_in.detach().requires_grad_()
        params = [t.detach().requires_grad_() for t in leaves]
        out = ops.gn_adagn_silu(x_in, *params[:2], *params[2:])
        return torch.autograd.grad(out, [x_in, *params], cot)

    want = grads(x)
    got = grads(_cl(x))
    assert got[0].is_contiguous(memory_format=CL)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_memory_layout_names_both_layouts_and_nothing_else():
    x = torch.randn(2, 8, 4, 4)
    assert groupnorm.memory_layout(x) == "nchw"
    assert groupnorm.memory_layout(_cl(x)) == "nhwc"
    assert groupnorm.memory_layout(_cl(torch.randn(2, 8, 1, 1))) == "nchw"   # both ways
    assert groupnorm.memory_layout(torch.randn(2, 8, 16)) == "nchw"
    assert groupnorm.memory_layout(x.transpose(2, 3)) is None
    assert groupnorm.memory_layout(x[:, ::2]) is None


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a card, so that the wrappers' checks and
    dispatch run here (their launches are replaced)."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def launched(monkeypatch):
    calls = []
    for mod in (groupnorm, groupnorm_train):
        monkeypatch.setattr(mod, "_launch", lambda plan, *a, **k: calls.append(plan))
        monkeypatch.setattr(mod, "_launch_nhwc", lambda plan, *a, **k: calls.append(plan))
    return calls


def test_the_wrappers_send_each_layout_to_its_variant(launched):
    x, gamma, beta, coef = _chain_inputs(256, torch.bfloat16, side=8)
    on_card = x.as_subclass(_OnCard)
    out = groupnorm.gn_cuda(on_card, gamma, beta, *coef)
    assert out.is_contiguous() and isinstance(launched[-1], groupnorm.GNPlan)
    out = groupnorm.gn_cuda(_cl(x).as_subclass(_OnCard), gamma, beta, *coef)
    assert out.is_contiguous(memory_format=CL) and not out.is_contiguous()
    assert launched[-1] == groupnorm.nhwc_plan(256, 64, 32, 2, True)
    square = torch.randn(2, 256, 1, 1).to(torch.bfloat16)              # both ways: NCHW
    groupnorm.gn_cuda(_cl(square).as_subclass(_OnCard), gamma, beta)
    assert isinstance(launched[-1], groupnorm.GNPlan)
    mean, rstd = torch.zeros(2, 32), torch.ones(2, 32)
    g = _cl(torch.randn(x.shape).to(x.dtype)).as_subclass(_OnCard)
    dx, _, _ = groupnorm_train.gn_bwd_cuda(_cl(x).as_subclass(_OnCard), g, mean, rstd, gamma,
                                           beta, *coef)
    assert dx.is_contiguous(memory_format=CL)
    assert launched[-1] == groupnorm_train.nhwc_plan_for(_cl(x), g, dx, 32)
    assert launched[-1].keep
    groupnorm_train.gn_bwd_cuda(on_card, x.as_subclass(_OnCard), mean, rstd, gamma, beta,
                                *coef, need_dx=False)
    assert isinstance(launched[-1], groupnorm.GNPlan) and len(launched) == 5


def test_the_wrappers_refuse_other_strides_and_mixed_layouts(launched):
    x, gamma, beta, coef = _chain_inputs(64, torch.float32, side=8)
    with pytest.raises(ValueError, match="contiguous"):
        groupnorm.gn_cuda(x.transpose(2, 3).as_subclass(_OnCard), gamma, beta)
    with pytest.raises(ValueError, match="fold mode"):
        groupnorm.gn_cuda(_cl(x).as_subclass(_OnCard), gamma, beta, *coef, fold=True)
    with pytest.raises(ValueError, match="contiguous"):                # split passes: NCHW
        groupnorm.gn_apply_cuda(_cl(x).as_subclass(_OnCard), torch.zeros(2, 32),
                                torch.ones(2, 32), gamma, beta)
    mean, rstd = torch.zeros(2, 32), torch.ones(2, 32)
    with pytest.raises(ValueError, match="x's layout"):
        groupnorm_train.gn_bwd_cuda(_cl(x).as_subclass(_OnCard), x.as_subclass(_OnCard),
                                    mean, rstd, gamma, beta)
    assert not launched


# (channels, H=W) of every GN chain of the bf16 FFHQ128 step: the ShiftUNet's
# trunk and both decodes, the 128px encoder
FFHQ128_GN = [(128, 128), (256, 128), (128, 64), (256, 64), (384, 64), (128, 32),
              (256, 32), (384, 32), (512, 32), (256, 16), (512, 16), (768, 16), (256, 8),
              (512, 8), (768, 8), (1024, 8), (512, 4), (1024, 4), (64, 64), (256, 4)]
SMEM = 232448 - 1024      # what a block may use on sm_90, less the kernels' reserve


def _smem(plan, c, elt, operands):
    """The dynamic shared memory the kernels' launchers ask for: the parts,
    column_totals's scratch (rounded to 16 bytes), the per-channel table and
    sums, the per-group sums."""
    w = plan.groups * (c // 32)
    r = w // plan.vec
    slots = plan.threads // 32 * r if r < 32 and 32 % r == 0 else plan.threads
    scratch = -(-slots * plan.vec * 2 // 4) * 4
    part = operands * plan.pixels * w * elt if plan.keep else 0
    floats = (10 * w + 4 * plan.groups) if operands == 1 else (12 * w + 2 * plan.groups)
    return part + 4 * (scratch + floats)


@pytest.mark.parametrize("channels,side", FFHQ128_GN)
def test_the_nhwc_plans_at_the_ffhq128_step(channels, side):
    hw, cs = side * side, channels // 32
    x = torch.empty(1, channels, side, side, dtype=torch.bfloat16)
    for plan, operands, mod, max_part in (
            (groupnorm.nhwc_plan_for(x, x, 32), 1, groupnorm, groupnorm.NHWC_MAX_PART_BYTES),
            (groupnorm_train.nhwc_plan_for(x, x, x, 32), 2, groupnorm_train,
             groupnorm_train.NHWC_MAX_PAIR_BYTES)):
        w = plan.groups * cs
        assert 32 % plan.groups == 0 and plan.vec == 8 and w % plan.vec == 0
        assert w * 2 >= mod.NHWC_ROW_BYTES          # pixel rows of at least the target
        r = w // plan.vec
        assert plan.threads % r == 0 and plan.threads % 32 == 0
        assert plan.threads <= mod.NHWC_MAX_THREADS
        assert plan.pixels * plan.cluster >= hw and plan.cluster in groupnorm.CLUSTER_SIZES
        # held (read once) wherever 8 parts hold the tile, else read twice
        tile = hw * w * 2 * operands
        assert plan.keep == (tile <= 8 * max_part)
        assert not plan.keep or plan.part_bytes * operands <= max_part
        assert _smem(plan, channels, 2, operands) == plan.smem_bytes <= SMEM


def test_a_tile_over_the_cluster_is_read_twice_and_a_ragged_row_by_elements():
    plan = groupnorm.nhwc_plan(64, 256 * 256, 32, 2, True)
    assert not plan.keep and plan.cluster == 8 and plan.vec == 8
    plan = groupnorm.nhwc_plan(96, 144, 32, 2, False)          # misaligned
    assert plan.vec == 1 and not plan.keep and plan.threads % (plan.groups * 3) == 0
    plan = groupnorm.nhwc_plan(6, 16, 6, 4, True)              # 24-byte pixel rows
    assert plan.vec == 1 and plan.groups == 6 and plan.threads % 6 == 0


def _perturbed(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _tiny_pair(dtype, seed=0):
    torch.manual_seed(seed)
    decoder = _perturbed(ShiftUNet(latent_dim=16, dtype=dtype, **TINY_DPM), seed)
    encoder = _perturbed(SemanticEncoder(16, channels=(32, 64), attn_after_stage=2,
                                         image_size=16, dtype=dtype), seed + 1)
    return encoder, decoder


def _record_layouts(monkeypatch):
    """The layout of every GN chain's and conv's input, as the models run."""
    seen = []
    chain, conv = ops.gn_adagn_silu, blocks._CastConv.forward

    def record_chain(x, *args, **kwargs):
        seen.append(("chain", groupnorm.memory_layout(x)))
        return chain(x, *args, **kwargs)

    def record_conv(self, x):
        if x.dim() == 4:
            seen.append(("conv", groupnorm.memory_layout(x)))
        return conv(self, x)

    monkeypatch.setattr(blocks.ops, "gn_adagn_silu", record_chain)
    monkeypatch.setattr(blocks._CastConv, "forward", record_conv)
    return seen


def _run(encoder, decoder, x, t):
    leaves = [p for m in (encoder, decoder) for p in m.parameters() if p.requires_grad]
    z = encoder(x)
    eps, grad = decoder(x, t, z)
    loss = (eps.square().mean() + grad.square().mean() + z.square().mean())
    return [z, eps, grad], torch.autograd.grad(loss, leaves)


def _rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def test_bf16_models_run_channels_last_and_hand_back_nchw(monkeypatch):
    encoder, decoder = _tiny_pair(torch.bfloat16)
    assert blocks.nhwc_model(encoder) and blocks.nhwc_model(decoder)
    x = torch.randn(2, 3, 16, 16, generator=torch.Generator().manual_seed(3))
    t = torch.tensor([3, 500])
    seen = _record_layouts(monkeypatch)
    outs, grads = _run(encoder, decoder, x, t)
    assert seen and all(layout == "nhwc" for _, layout in seen), seen
    assert all(o.dtype == torch.float32 and o.is_contiguous() for o in outs)
    seen.clear()
    monkeypatch.setattr(blocks, "nhwc_model", lambda model: False)
    want_outs, want_grads = _run(encoder, decoder, x, t)
    assert seen and all(layout == "nchw" for _, layout in seen)
    # the control: the same models in fp32
    enc32, dec32 = _tiny_pair(torch.float32)
    outs32, grads32 = _run(enc32, dec32, x, t)
    for got, want, ref in zip(outs, want_outs, outs32):
        assert _rel(got, want) <= max(2e-2, 2 * _rel(want, ref))
    flat = [torch.cat([g.flatten() for g in gs]) for gs in (grads, want_grads, grads32)]
    assert _rel(flat[0], flat[1]) <= max(2e-2, 2 * _rel(flat[1], flat[2]))


def test_attention_on_channels_last_matches_nchw():
    """The attention block's [B, T, C] path (norm, 1x1 products, head split)
    against its NCHW path, on weights with no zero projection."""
    for new_order in (False, True):
        torch.manual_seed(4)
        block = _perturbed(blocks.AttentionBlock(64, num_heads=4,
                                                 use_new_attention_order=new_order), 4)
        x = torch.randn(2, 64, 4, 8)
        got = block(_cl(x))
        assert got.is_contiguous(memory_format=CL) and not got.is_contiguous()
        torch.testing.assert_close(got, block(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["fp32", "tp", "sp"])
def test_fp32_tp_and_sp_models_stay_nchw(kind, monkeypatch):
    encoder, decoder = _tiny_pair(torch.float32 if kind == "fp32" else torch.bfloat16)
    unet = UNet(dtype=decoder.dtype, **TINY_DPM)
    models = (encoder, decoder, unet)
    if kind == "tp":          # parallel/tp.py marks every ResBlock and AttentionBlock
        for model in models:
            for m in model.modules():
                if isinstance(m, (blocks.ResBlock, blocks.AttentionBlock)):
                    monkeypatch.setattr(m, "tp", object(), raising=False)
    if kind == "sp":
        for model in models:
            monkeypatch.setattr(model, "sp", sp_mod.Groups(2, 1, 0, 0))
    assert not any(blocks.nhwc_model(m) for m in models)
    x = torch.randn(2, 3, 16, 16)
    for model in models:
        assert groupnorm.memory_layout(blocks.model_input(model, x)) == "nchw"
    if kind == "fp32":
        seen = _record_layouts(monkeypatch)
        _run(encoder, decoder, x, torch.tensor([3, 500]))
        assert seen and all(layout == "nchw" for _, layout in seen)


def test_the_fp32_conv_casts_stay_the_tensor_itself():
    conv = blocks.conv3x3(8, 8)
    assert conv.weight.to(conv.compute_dtype) is conv.weight
    x = torch.randn(1, 3, 4, 4)
    assert blocks.model_output(x) is x


def test_encoder_flattens_in_nchw_order_on_a_converted_checkpoint(monkeypatch):
    """The 64px encoder from converted JAX params, in bf16: z channels-last
    inside equals z of the NCHW run within bf16 rounding, and far from z of
    a flatten taken in NHWC order."""
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jax_model = jax_encoder_for_resolution(64, 16)
    params = init_flax(jax_model, jnp.asarray(x), seed=6)
    port = encoder_for_resolution(64, 16, dtype=torch.bfloat16)
    port.load_state_dict(encoder_state_dict(params), strict=True)
    with torch.no_grad():
        got = port(nchw(x))
        monkeypatch.setattr(blocks, "nhwc_model", lambda model: False)
        want = port(nchw(x))
        flatten = port.encoder[-2]
        monkeypatch.setattr(flatten, "forward",
                            lambda h: h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
        wrong = port(nchw(x))
    assert _rel(got, want) <= 2e-2
    assert _rel(wrong, want) > 10 * _rel(got, want)
