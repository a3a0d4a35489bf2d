"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a card). Run where the card is, without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version at the celeba64
path's shapes, fp32 with TF32 off: attention within 2e-5 + 1e-4*|ref|, the
GN chain within 1e-4 + 1e-4*|ref| (sums in another order). The two autograd
Functions (GN chain: forward and backward kernels; attention: forward kernel,
plain-torch backward) are held against the same Functions on the plain
versions (``set_use_kernels(False)``): every gradient within
1e-4 * max(1, max|ref|) + 1e-4 * |ref|. The GN backward kernel's two
variants are held against its plain version directly (dx, dA, dB within
1e-4 * max(1, max|ref|) + 1e-4 * |ref| in fp32, 3e-2 * max(1, max|ref|) +
2e-2 * |ref| in bf16, where dx is rounded), and two of its launches on the
same inputs must be bit-equal. The serving ops (the latent DPM's sampler,
``manipulate``, a dpm5 autoencode, trajectory interpolation) run at b2
through the kernels and through the plain versions on a small 64px stack
and agree within one uint8 level. The representation trainer takes 2 steps
through the kernels, saves, and a resumed trainer holds the same tensors bit
for bit. ``AutoencodingEval`` and ``PDAEService.from_config`` on files the
port writes run on the card and on the CPU and agree (reconstructions within
1e-2, served images within one uint8 level). The regular, latent and
manipulation trainers each take 2 steps on a resident uint8 corpus, every
step's launches equal to the structure's, run their eval and resume bit for
bit. A bf16 train step at b2 through the kernels agrees with the bf16 plain
path within twice the plain path's own bf16-against-fp32 gap, and FFHQ128's
256-channel 128x128 GN backward slab pair (1 MB in fp32) runs on the cluster
variant. With ``steps_per_dispatch`` > 1 the representation step and a
resident latent chunk replayed from a CUDA graph equal the eager K=1 steps
bit for bit, and a step that cannot be captured raises. The split passes
of spatial parallelism (the GN stats and apply passes, the backward's
moments and dx passes) match their plain versions at a rank's shapes in fp32
and bf16, the apply pass on the fused kernel's saved stats gives the fused
kernel's bits, the split chain's Function in one part matches the fused
one, and the attention of a rank's query rows against every key matches the
plain version and the same rows of the ``Tq = Tk`` launch. The GN kernels'
NHWC variants (channels-last inputs: every kind of GN shape of the bf16
FFHQ128 step and the edges, fp32 and bf16) match the plain versions, the
backward bit for bit from run to run, inside a CUDA graph too, and refuse
fold mode and other strides; a bf16 FFHQ128 step runs every GN launch on them
and agrees with the same models run NCHW, and an fp32 celeba64 evaluation
runs none of them.
``chip_smoke.py`` covers every path shape, bf16 and timings.
"""

import pytest
import torch

from pdae_torch import ops
from pdae_torch.ops import _dispatch, attention, groupnorm, groupnorm_train

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = _dispatch._USE_KERNELS
    yield torch.device("cuda")
    _dispatch._USE_KERNELS = saved


# the path's shapes, then the edges of the tiling: T off the query and key
# tiles, the TPU kernel's limits (T=1024, D=256), small D
@pytest.mark.parametrize("shape", [(8, 4, 64, 128), (8, 4, 256, 32), (3, 1, 16, 16),
                                   (32, 4, 64, 128), (1, 1, 1024, 256), (2, 3, 50, 36),
                                   (1, 2, 1000, 64), (2, 2, 77, 8)])
def test_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda) for _ in range(3))
    before = attention.launches
    got = ops.fused_qkv_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    plan = attention.attention_plan(shape[0] * shape[1], shape[2], shape[3], 4)
    assert attention.library_smem_bytes(plan, shape[2], shape[3], 4) == plan.smem_bytes
    want = ops.reference_attention(q, k, v, shape[-1] ** -0.25)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


# three path shapes (clusters of 4, 1 and 1), then the edges: a cluster of 8,
# H*W no power of two, and two slabs for the general variant (H*W no multiple
# of the 16-byte vector, a slab over 8 x 64 KB)
# bf16: D of 32, 64, 128 runs both products on the tensor cores (T on and off
# its 16-key steps and 64-key tiles, T=1024), any other D on the CUDA cores
@pytest.mark.parametrize("shape", [(8, 4, 64, 128), (8, 4, 256, 32), (32, 4, 256, 32),
                                   (2, 2, 1024, 128), (3, 2, 100, 32), (2, 3, 77, 64),
                                   (1, 1, 1024, 256), (3, 1, 16, 16)])
def test_bf16_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, torch.bfloat16) for _ in range(3))
    b, h, t, d = shape
    plan = attention.attention_plan(b * h, t, d, 2)
    assert plan.mma is (d in (32, 64, 128))
    assert attention.library_smem_bytes(plan, t, d, 2) == plan.smem_bytes
    got = ops.fused_qkv_attention(q, k, v)
    torch.cuda.synchronize()
    want = ops.reference_attention(q, k, v, d ** -0.25)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("shape,variant", [((8, 384, 64, 64), "plain"),
                                           ((8, 128, 64, 64), "adagn_z"),
                                           ((8, 512, 8, 8), "adagn"),
                                           ((1, 64, 256, 256), "adagn_z"),
                                           ((2, 64, 12, 12), "adagn"),
                                           ((2, 64, 3, 3), "adagn_z"),
                                           ((1, 64, 384, 384), "plain")])
def test_gn_kernel_matches_plain_in_both_modes(cuda, shape, variant):
    gen = torch.Generator().manual_seed(1)
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen).to(cuda)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(c, generator=gen)).to(cuda)
    s, t = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(cuda).chunk(2, dim=1)
    zs, zt = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(cuda).chunk(2, dim=1)
    coef = {"plain": (None,) * 4, "adagn": (s, t, None, None),
            "adagn_z": (s, t, zs, zt)}[variant]
    before = dict(groupnorm.variant_launches)
    got = ops.gn_adagn_silu(x, gamma, beta, *coef, groups=32)
    plan = groupnorm.plan_for(x, got, 32)
    assert groupnorm.variant_launches[plan.variant] == before[plan.variant] + 1
    want = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, groups=32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    zero = torch.zeros_like(s)
    full = tuple(zero if a is None else a for a in coef)
    got = ops.fused_gn_adagn_silu(x, gamma, beta, *full, groups=32)
    want = ops.reference_gn_adagn_silu(x, gamma, beta, *full, 32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kernels_raise_rather_than_fall_back(cuda):
    q = torch.randn(1, 1, 1025, 64, device=cuda)           # past the kernel's T
    with pytest.raises(ValueError, match="outside"):
        ops.fused_qkv_attention(q, q, q)
    q = torch.randn(1, 1, 8, 6, device=cuda)               # rows of 24 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        ops.fused_qkv_attention(q, q, q)
    q = torch.randn(1, 1, 64, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ops.fused_qkv_attention(q.half(), q.half(), q.half())
    x = torch.randn(2, 64, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.gn_adagn_silu(x.transpose(2, 3), torch.ones(64, device=cuda),
                          torch.zeros(64, device=cuda), groups=32)
    with pytest.raises(ValueError, match="gamma/beta"):
        ops.gn_adagn_silu(x, torch.ones(64, device=cuda, dtype=torch.float64),
                          torch.zeros(64, device=cuda), groups=32)


def test_kernels_capture_in_a_cuda_graph(cuda):
    """The wrappers launch on PyTorch's current stream, so a CUDA graph
    captures them (replays give the eager result)."""
    x = torch.randn(8, 256, 16, 16, device=cuda)
    gamma, beta = torch.ones(256, device=cuda), torch.zeros(256, device=cuda)
    q = torch.randn(8, 4, 64, 128, device=cuda)
    eager = (groupnorm.gn_cuda(x, gamma, beta), attention.attention_cuda(q, q, q))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupnorm.gn_cuda(x, gamma, beta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (groupnorm.gn_cuda(x, gamma, beta), attention.attention_cuda(q, q, q))
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_a_cluster_launch_captures_in_a_cuda_graph(cuda):
    """The GN cluster variant with more than one block per slab (a launch
    with a cluster-dimension attribute) inside a CUDA graph, and a misaligned
    input beside it, which takes the general variant."""
    x = torch.randn(8, 384, 64, 64, device=cuda)
    gamma, beta = torch.ones(384, device=cuda), torch.zeros(384, device=cuda)
    eager = groupnorm.gn_cuda(x, gamma, beta)
    assert groupnorm.plan_for(x, eager, 32).cluster == 4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupnorm.gn_cuda(x, gamma, beta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = groupnorm.gn_cuda(x, gamma, beta)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    off = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    before = groupnorm.variant_launches["general"]
    torch.testing.assert_close(groupnorm.gn_cuda(off, gamma, beta), eager,
                               atol=1e-4, rtol=1e-4)
    assert groupnorm.variant_launches["general"] == before + 1


def _grads_both_ways(fn, leaves, cot):
    """Gradients of ``fn(*leaves)`` with the kernels and with the plain
    versions, from the same inputs and cotangent."""
    present = [a for a in leaves if a is not None]
    ops.set_use_kernels(None)
    got = torch.autograd.grad(fn(*leaves), present, cot)
    ops.set_use_kernels(False)
    want = torch.autograd.grad(fn(*leaves), present, cot)
    ops.set_use_kernels(None)
    return got, want


def _assert_grads_close(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize("shape,variant", [((4, 384, 64, 64), "plain"),
                                           ((4, 128, 64, 64), "adagn_z"),
                                           ((4, 512, 8, 8), "adagn"),
                                           ((4, 128, 4, 4), "plain")])
def test_gn_function_gradients_match_plain(cuda, shape, variant):
    gen = torch.Generator().manual_seed(2)
    b, c = shape[:2]

    def leaf(*size, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*size, generator=gen)).to(cuda).requires_grad_()

    x, gamma, beta = leaf(*shape), leaf(c, scale=0.1, shift=1.0), leaf(c, scale=0.1)
    st, zz = leaf(b, 2 * c, scale=0.1), leaf(b, 2 * c, scale=0.1)
    cot = torch.randn(shape, generator=gen).to(cuda)

    def fn(x, gamma, beta, st, zz):
        s, t = st.chunk(2, dim=1) if st is not None else (None, None)
        zs, zt = zz.chunk(2, dim=1) if zz is not None else (None, None)
        return ops.gn_adagn_silu(x, gamma, beta, s, t, zs, zt, groups=32)

    leaves = {"plain": [x, gamma, beta, None, None], "adagn": [x, gamma, beta, st, None],
              "adagn_z": [x, gamma, beta, st, zz]}[variant]
    before = (groupnorm.launches, groupnorm_train.launches)
    got, want = _grads_both_ways(fn, leaves, cot)
    assert (groupnorm.launches, groupnorm_train.launches) == (before[0] + 1, before[1] + 1)
    _assert_grads_close(got, want)


def test_gn_function_skips_dx_for_an_input_without_grad(cuda):
    x = torch.randn(4, 256, 16, 16, device=cuda)
    gamma = torch.ones(256, device=cuda, requires_grad=True)
    beta = torch.zeros(256, device=cuda, requires_grad=True)
    cot = torch.randn_like(x)
    got, want = _grads_both_ways(
        lambda g, b: ops.gn_adagn_silu(x, g, b, groups=32), [gamma, beta], cot)
    _assert_grads_close(got, want)


@pytest.mark.parametrize("shape", [(8, 4, 64, 128), (8, 4, 256, 32)])
def test_attention_function_gradients_match_plain(cuda, shape):
    gen = torch.Generator().manual_seed(3)
    leaves = [torch.randn(shape, generator=gen).to(cuda).requires_grad_() for _ in range(3)]
    cot = torch.randn(shape, generator=gen).to(cuda)
    before = attention.launches
    got, want = _grads_both_ways(ops.fused_qkv_attention, leaves, cot)
    assert attention.launches == before + 1
    _assert_grads_close(got, want)


def test_backward_through_the_kernels_reaches_every_trainable_parameter(cuda):
    """A loss through the ShiftUNet and the encoder on the card: no trainable
    parameter is left with ``grad is None`` (a kernel output without a
    ``grad_fn`` would cut the graph silently), the frozen trunk gets none, and
    the counters show the backward kernel ran once per chain that needs it."""
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.models import SemanticEncoder, ShiftUNet
    from pdae_torch.training import trainable_params

    torch.manual_seed(0)
    geometry = dict(input_channel=3, base_channel=32, channel_multiplier=(1, 2),
                    num_residual_blocks_of_a_block=1, attention_resolutions=(2,),
                    num_heads=2, head_channel=-1, use_new_attention_order=False,
                    dropout=0.0)
    decoder = ShiftUNet(latent_dim=16, **geometry)
    encoder = SemanticEncoder(16, channels=(32, 64), attn_after_stage=2, image_size=16)
    with torch.no_grad():
        for model in (decoder, encoder):
            for p in model.parameters():
                if not p.any():
                    p.normal_(std=0.05)
    decoder.to(cuda)
    encoder.to(cuda)
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    x_0 = torch.rand(4, 3, 16, 16, device=cuda) * 2 - 1
    ops.reset_launch_counts()
    loss = gd.representation_learning_train_one_batch(
        torch.Generator(device=cuda).manual_seed(0), encoder, decoder,
        x_0)["prediction_loss"]
    loss.backward()
    torch.cuda.synchronize()
    params = trainable_params(encoder, decoder)
    missing = [f"{g}.{k}" for g, named in params.items() for k, p in named.items()
               if p.grad is None or not torch.isfinite(p.grad).all()]
    assert not missing, missing
    trained = {id(p) for named in params.values() for p in named.values()}
    assert all(p.grad is None for p in decoder.parameters() if id(p) not in trained)
    counts = ops.launch_counts()
    assert counts["gn_adagn_silu_bwd"] > 0 and counts["attention"] > 0
    assert counts["gn_adagn_silu_bwd"] < counts["gn_adagn_silu"]


def _rel_l2(a, b):
    a = torch.cat([t.detach().double().flatten() for t in a])
    b = torch.cat([t.detach().double().flatten() for t in b])
    return float((a - b).norm() / b.norm())


def test_bf16_train_step_through_the_kernels_matches_plain_within_its_control(cuda):
    """The representation loss and every trainable gradient at b2, bf16
    compute over fp32 params: the kernels against the plain versions, both in
    bf16, within twice the control, the plain path in bf16 against fp32 twins
    of the same models (the loss, one number, with the larger of its own
    control and the gradients'). Params and grads stay fp32."""
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.models import SemanticEncoder, ShiftUNet
    from pdae_torch.training import trainable_params
    from pdae_torch.training.state import flat_params

    geometry = dict(input_channel=3, base_channel=32, channel_multiplier=(1, 2),
                    num_residual_blocks_of_a_block=1, attention_resolutions=(2,),
                    num_heads=2, head_channel=-1, use_new_attention_order=False,
                    dropout=0.0)
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        torch.manual_seed(0)
        decoder = ShiftUNet(latent_dim=16, dtype=dtype, **geometry)
        encoder = SemanticEncoder(16, channels=(32, 64), attn_after_stage=2, image_size=16,
                                  dtype=dtype)
        with torch.no_grad():
            for model in (decoder, encoder):
                for p in model.parameters():
                    if not p.any():
                        p.normal_(std=0.05)
        models[dtype] = (encoder.to(cuda), decoder.to(cuda))
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    gen = torch.Generator(device=cuda).manual_seed(1)
    x_0 = torch.rand(2, 3, 16, 16, device=cuda, generator=gen) * 2 - 1
    noise = torch.randn(2, 3, 16, 16, device=cuda, generator=gen)
    t = torch.tensor([10, 500], dtype=torch.int32, device=cuda)

    def loss_and_grads(encoder, decoder):
        leaves = flat_params(trainable_params(encoder, decoder))
        loss = gd.representation_learning_train_one_batch(
            None, encoder, decoder, x_0, t=t, noise=noise)["prediction_loss"]
        grads = torch.autograd.grad(loss, leaves)
        assert all(p.dtype == torch.float32 for p in leaves)
        assert all(g.dtype == torch.float32 for g in grads)
        return [loss.detach()], list(grads)

    ops.reset_launch_counts()
    kernel = loss_and_grads(*models[torch.bfloat16])
    assert ops.launch_counts()["gn_adagn_silu_bwd"] > 0
    ops.set_use_kernels(False)
    plain = loss_and_grads(*models[torch.bfloat16])
    plain32 = loss_and_grads(*models[torch.float32])
    grad_control = _rel_l2(plain[1], plain32[1])
    assert 0 < grad_control <= 5e-2
    assert _rel_l2(kernel[1], plain[1]) <= 2 * grad_control
    loss_control = max(_rel_l2(plain[0], plain32[0]), grad_control)
    assert _rel_l2(kernel[0], plain[0]) <= 2 * loss_control


def _bwd_inputs(cuda, shape, variant, dtype=torch.float32, seed=5):
    """x, g, the forward kernel's saved stats, gamma, beta and the four AdaGN
    vectors (None where ``variant`` has none) for the GN backward kernel."""
    gen = torch.Generator().manual_seed(seed)
    b, c = shape[:2]
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    g = torch.randn(shape, generator=gen).to(cuda, dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(cuda)
    beta = (0.1 * torch.randn(c, generator=gen)).to(cuda)
    s, t = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(cuda, dtype).chunk(2, dim=1)
    zs, zt = (0.1 * torch.randn(b, 2 * c, generator=gen)).to(cuda, dtype).chunk(2, dim=1)
    coef = {"plain": (None,) * 4, "adagn": (s, t, None, None),
            "adagn_z": (s, t, zs, zt)}[variant]
    _, mean, rstd = groupnorm.gn_cuda(x, gamma, beta, *coef, groups=32, save_stats=True)
    return x, g, mean, rstd, gamma, beta, coef


def _assert_bwd_close(got, want, dtype):
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 2e-2)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        torch.testing.assert_close(a.float(), b.float(), rtol=rtol,
                                   atol=atol * max(1.0, float(b.float().abs().max())))


# each variant at the train step's kinds of slab (clusters of 8, 4, 2 and 1; a
# segmented scan at 8x8 and 4x4), then the edges: a cluster of 8 with two
# channels a group, no dx over a
# cluster, H*W no power of two, and two slabs for the general variant (H*W no
# multiple of the 16-byte vector, a slab pair over 8 parts)
@pytest.mark.parametrize("shape,variant,need_dx,want", [
    ((4, 384, 64, 64), "plain", True, ("cluster", 8)),
    ((4, 256, 64, 64), "adagn_z", True, ("cluster", 4)),
    ((4, 128, 64, 64), "adagn_z", True, ("cluster", 2)),
    ((4, 512, 8, 8), "adagn", True, ("cluster", 1)),
    ((4, 128, 4, 4), "plain", True, ("cluster", 1)),
    ((1, 64, 128, 256), "adagn_z", True, ("cluster", 8)),
    ((2, 256, 128, 128), "adagn_z", True, ("cluster", 8)),   # FFHQ128's 1 MB fp32 pair
    ((2, 256, 64, 64), "plain", False, ("cluster", 4)),
    ((4, 512, 8, 8), "plain", False, ("cluster", 1)),
    ((2, 64, 12, 12), "adagn_z", True, ("cluster", 1)),
    ((2, 64, 3, 3), "adagn_z", True, ("general", 0)),
    ((1, 64, 384, 384), "plain", True, ("general", 0))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_backward_kernel_matches_plain(cuda, shape, variant, need_dx, want, dtype):
    x, g, mean, rstd, gamma, beta, coef = _bwd_inputs(cuda, shape, variant, dtype)
    before = dict(groupnorm_train.variant_launches)
    got = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef,
                                      need_dx=need_dx)
    torch.cuda.synchronize()
    plan = groupnorm_train.plan_for(x, g, got[0], 32)
    if dtype == torch.float32:
        assert (plan.variant, plan.cluster) == want
    assert groupnorm_train.variant_launches[plan.variant] == before[plan.variant] + 1
    want_grads = ops.gn_adagn_silu_bwd_plain(x, g, mean, rstd, gamma, beta, *coef,
                                             need_dx=need_dx)
    _assert_bwd_close(got, want_grads, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_backward_repeats_bit_for_bit(cuda, dtype):
    """The sums feed the parameter gradients: no atomics, one order."""
    x, g, mean, rstd, gamma, beta, coef = _bwd_inputs(cuda, (32, 256, 64, 64), "adagn_z",
                                                      dtype)
    first = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    second = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    torch.cuda.synchronize()
    assert groupnorm_train.plan_for(x, g, first[0], 32).cluster > 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,variant", [((8, 256, 32, 64), "adagn_z"),
                                           ((8, 512, 4, 8), "adagn"), ((2, 64, 3, 3), "plain")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_split_gn_passes_match_plain(cuda, shape, variant, dtype):
    x, g, mean, rstd, gamma, beta, coef = _bwd_inputs(cuda, shape, variant, dtype)
    n = x[0].numel() // 32
    sums = groupnorm.gn_stats_cuda(x, 32)
    want = ops.gn_stats_plain(x, 32)
    torch.testing.assert_close(sums, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, float(want.abs().max())))
    mean, rstd = ops.moments_from_sums(want, n)
    got = groupnorm.gn_apply_cuda(x, mean, rstd, gamma, beta, *coef)
    atol, rtol = (1e-4, 1e-4) if dtype == torch.float32 else (3e-2, 2e-2)
    torch.testing.assert_close(got.float(), ops.gn_apply_plain(
        x, mean, rstd, gamma, beta, *coef).float(), rtol=rtol, atol=atol)
    fused, m_f, r_f = groupnorm.gn_cuda(x, gamma, beta, *coef, save_stats=True)
    assert torch.equal(groupnorm.gn_apply_cuda(x, m_f, r_f, gamma, beta, *coef), fused)
    d_a, d_b, moments = groupnorm_train.gn_bwd_moments_cuda(x, g, mean, rstd, gamma, beta,
                                                            *coef)
    want_m = ops.gn_bwd_moments_plain(x, g, mean, rstd, gamma, beta, *coef)
    _assert_bwd_close((d_a, d_b, moments), want_m, dtype)
    m = (want_m[2] / n).contiguous()
    dx = groupnorm_train.gn_bwd_dx_cuda(x, g, mean, rstd, m, gamma, beta, *coef)
    _assert_bwd_close((dx,), (ops.gn_bwd_dx_plain(x, g, mean, rstd, m, gamma, beta, *coef),),
                      dtype)


def test_the_split_chain_in_one_part_matches_the_fused_chain(cuda):
    x, g, _, _, gamma, beta, coef = _bwd_inputs(cuda, (4, 256, 32, 32), "adagn_z")
    args = [a.detach().clone().requires_grad_(True) for a in (x, gamma, beta, *coef)]
    out = ops.gn_adagn_silu_split(*args, groups=32)
    got = torch.autograd.grad(out, args, g)
    args2 = [a.detach().clone().requires_grad_(True) for a in args]
    want_out = ops.gn_adagn_silu_train(*args2, groups=32)
    want = torch.autograd.grad(want_out, args2, g)
    torch.testing.assert_close(out, want_out, rtol=1e-4, atol=1e-4)
    _assert_bwd_close(got, want, torch.float32)


@pytest.mark.parametrize("shape", [(32, 4, 128, 256, 32), (32, 4, 32, 64, 128),
                                   (2, 2, 25, 50, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tq_below_tk_attention_matches_plain_and_the_whole_rows(cuda, shape, dtype):
    b, h, tq, tk, d = shape
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(b, h, tk, d, generator=gen).to(cuda, dtype) for _ in range(3))
    rows = q[:, :, :tq].contiguous()
    got = attention.attention_cuda(rows, k, v)
    want = ops.reference_attention(rows, k, v, d ** -0.25)
    atol, rtol = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    assert torch.equal(got, attention.attention_cuda(q, k, v)[:, :, :tq])


def test_gn_backward_misaligned_input_takes_the_general_variant(cuda):
    x, g, mean, rstd, gamma, beta, coef = _bwd_inputs(cuda, (2, 256, 16, 16), "adagn_z")
    aligned = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    off_x = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
    off_g = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape).copy_(g)
    for xs, gs in ((off_x, g), (x, off_g)):
        before = groupnorm_train.variant_launches["general"]
        got = groupnorm_train.gn_bwd_cuda(xs, gs, mean, rstd, gamma, beta, *coef)
        torch.cuda.synchronize()
        assert groupnorm_train.variant_launches["general"] == before + 1
        _assert_bwd_close(got, aligned, torch.float32)


def test_a_gn_backward_cluster_launch_captures_in_a_cuda_graph(cuda):
    x, g, mean, rstd, gamma, beta, coef = _bwd_inputs(cuda, (8, 256, 64, 64), "plain")
    args = (x, g, mean, rstd, gamma, beta)
    eager = groupnorm_train.gn_bwd_cuda(*args)
    assert groupnorm_train.plan_for(x, g, eager[0], 32).cluster == 4
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        groupnorm_train.gn_bwd_cuda(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = groupnorm_train.gn_bwd_cuda(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


# -- the serving ops end to end: kernels against the plain versions -------- #

CARD_DPM = dict(input_channel=3, base_channel=32, channel_multiplier=(1, 2),
                num_residual_blocks_of_a_block=1, attention_resolutions=(2,),
                num_heads=2, head_channel=-1, use_new_attention_order=False,
                dropout=0.0)


@pytest.fixture(scope="module")
def card_stack():
    """A 64px service on the card (the tiny ShiftUNet, the full 64px
    encoder, a small MLPSkipNet, a 40-class classifier, seeded) and fixed
    b2 inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    import numpy as np

    from pdae_torch.models import (MLPSkipNet, ShiftUNet, build_classifier,
                                   encoder_for_resolution)
    from pdae_torch.serving import PDAEService

    torch.manual_seed(0)
    latent_dim = 16
    decoder = ShiftUNet(latent_dim=latent_dim, **CARD_DPM)
    with torch.no_grad():
        for p in decoder.parameters():
            if not p.any():
                p.normal_(std=0.05)
    latent = MLPSkipNet(latent_dim, 64, 4)
    rs = np.random.RandomState(1)
    stats = ((0.1 * rs.randn(1, latent_dim)).astype(np.float32),
             rs.uniform(0.5, 1.5, (1, latent_dim)).astype(np.float32))
    config = {"trained_ddpm_config": CARD_DPM, "decoder_config": {"latent_dim": latent_dim},
              "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": latent_dim},
              "latent_config": {"input_channel": latent_dim, "model_channel": 64,
                                "num_layers": 4},
              "image_size": 64, "max_batch": 4}
    service = PDAEService(config, encoder_for_resolution(64, latent_dim).state_dict(),
                          decoder.state_dict(), device="cuda",
                          latent_state=latent.state_dict(), latent_stats=stats,
                          classifier_state=build_classifier(40, latent_dim).state_dict())
    inputs = dict(
        images=rs.randint(0, 256, (2, 64, 64, 3), np.uint8),
        z_T=torch.from_numpy(rs.randn(2, latent_dim).astype(np.float32)).cuda(),
        x_T=torch.from_numpy(rs.randn(2, 3, 64, 64).astype(np.float32)).cuda(),
        mean=torch.from_numpy(stats[0]).cuda(), std=torch.from_numpy(stats[1]).cuda())
    return service, latent.cuda().eval(), inputs


@pytest.mark.parametrize("op", ["latent_diffusion_sample", "manipulate", "autoencode_dpm5",
                                "interpolation"])
def test_serving_ops_kernels_match_plain(cuda, card_stack, op):
    """Each op at b2 and short styles through the kernels, then through the
    plain versions: within one uint8 level, as ``chip_smoke.py`` holds them
    at full width."""
    import numpy as np

    from pdae_torch.utils import from_uint8, to_uint8

    service, latent, a = card_stack
    gd = service.gd
    x_0 = torch.from_numpy(from_uint8(a["images"])).cuda().permute(0, 3, 1, 2).contiguous()

    def as_uint8(t):
        return to_uint8(t.permute(0, 2, 3, 1).cpu().numpy())

    def run():
        with torch.inference_mode():
            if op == "latent_diffusion_sample":
                return as_uint8(gd.latent_diffusion_sample(
                    None, "ddim5", "ddim5", latent, service.decoder, a["x_T"], a["mean"],
                    a["std"], latent_dim=16, z_T=a["z_T"]))
            if op == "manipulate":
                return service.manipulate(a["images"], attribute="Smiling",
                                          encode_style="ddim5", decode_style="ddim5")
            if op == "autoencode_dpm5":
                return service.autoencode(a["images"], "dpm5", "dpm5")
            z = service.encoder(x_0)
            return as_uint8(gd.representation_learning_ddim_trajectory_interpolation(
                "ddim5", service.decoder, z, z.flip(0), a["x_T"], 0.5))

    ops.reset_launch_counts()
    got = run()
    counts = ops.launch_counts()
    assert counts["attention"] > 0 and counts["gn_adagn_silu"] > 0, counts
    ops.set_use_kernels(False)
    want = run()
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_trainer_steps_saves_and_resumes_on_the_card(cuda, tmp_path):
    """The representation trainer on the card (64px encoder over the tiny
    ShiftUNet, SYNTHETIC b2): 2 steps through the three kernels, a save, and a
    resumed trainer that holds the same tensors bit for bit."""
    from pdae_torch.training import RepresentationLearningTrainer

    config = {
        "train_dataset_config": {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                                 "length": 8},
        "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
        "trained_ddpm_config": {"denoise_fn_config": CARD_DPM},
        "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": 16},
        "decoder_config": {"model": "ShiftUNet", "latent_dim": 16},
        "dataloader_config": {"train": {"num_workers": 1, "batch_size": 2}},
        "optimizer_config": {"lr": 1e-3},
        "runner_config": {"display_steps": 1, "evaluate_every_steps": 100000,
                          "save_latest_every_steps": 2, "ema_decay": 0.9}}
    run = str(tmp_path / "run")
    trainer = RepresentationLearningTrainer(config=config, run_path=run)
    assert trainer.device.type == "cuda"
    ops.reset_launch_counts()
    assert trainer.train(max_steps=2) == 2
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd")), \
        counts
    resumed = RepresentationLearningTrainer(config=config, run_path=run, resume="latest")
    assert resumed.start_step == 2
    for group in ("encoder", "shift"):
        for key, p in trainer.state.params[group].items():
            q = resumed.state.params[group][key]
            assert q.device.type == "cuda" and torch.equal(p, q), key
            assert torch.equal(trainer.state.ema_params[group][key],
                               resumed.state.ema_params[group][key])
            for m in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(trainer.optimizer.state[p][m], resumed.optimizer.state[q][m])
    for key, value in trainer.decoder.state_dict().items():
        assert torch.equal(value, resumed.decoder.state_dict()[key]), key


@pytest.fixture(scope="module")
def card_files(tmp_path_factory):
    """Checkpoint files and run configs that the port writes for a 64px stack
    (the tiny ShiftUNet, the full 64px encoder, a small MLPSkipNet, a
    40-class classifier, seeded), and a sampler config naming them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels have no CPU mode)")
    import numpy as np

    from pdae_torch.models import (MLPSkipNet, ShiftUNet, build_classifier,
                                   encoder_for_resolution)
    from pdae_torch.utils import (classifier_tree, encoder_tree, mlp_skip_net_tree,
                                  save_checkpoint, save_yaml, unet_tree)

    root = tmp_path_factory.mktemp("card_files")
    torch.manual_seed(1)
    decoder = ShiftUNet(latent_dim=16, **CARD_DPM)
    with torch.no_grad():
        for p in decoder.parameters():
            if not p.any():
                p.normal_(std=0.05)
    dataset = {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3, "length": 6}
    latent_config = {"input_channel": 16, "model_channel": 64, "num_layers": 4}
    save_yaml({"train_dataset_config": dataset,
               "diffusion_config": {"timesteps": 1000, "betas_type": "linear"},
               "trained_ddpm_config": {"denoise_fn_config": CARD_DPM},
               "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": 16},
               "decoder_config": {"model": "ShiftUNet", "latent_dim": 16}},
              str(root / "run.yml"))
    save_checkpoint(str(root / "run.ckpt"),
                    {"ema_encoder": encoder_tree(encoder_for_resolution(64, 16).state_dict()),
                     "ema_decoder": unet_tree(decoder.state_dict())})
    save_yaml({"latent_denoise_fn_config": latent_config}, str(root / "latent.yml"))
    save_checkpoint(str(root / "latent.ckpt"), {"ema_latent_denoise_fn": mlp_skip_net_tree(
        MLPSkipNet(16, 64, 4).state_dict())})
    save_checkpoint(str(root / "classifier.ckpt"), {"ema_classifier": classifier_tree(
        build_classifier(40, 16).state_dict())})
    rs = np.random.RandomState(2)
    save_checkpoint(str(root / "stats.ckpt"),
                    {"mean": (0.1 * rs.randn(16)).astype(np.float32),
                     "std": rs.uniform(0.5, 1.5, 16).astype(np.float32)})
    return {"config_path": str(root / "run.yml"), "checkpoint_path": str(root / "run.ckpt"),
            "latent_config_path": str(root / "latent.yml"),
            "latent_checkpoint_path": str(root / "latent.ckpt"),
            "classifier_checkpoint_path": str(root / "classifier.ckpt"),
            "inferred_latents_path": str(root / "stats.ckpt"), "dataset_config": dataset,
            "max_batch": 4}


def test_autoencoding_eval_on_the_card_matches_the_cpu(cuda, card_files, monkeypatch):
    """The eval through the kernels on the card against the plain versions on
    the CPU: reconstructions within 1e-2 (the DDIM encode amplifies a
    model-level difference), each run's metrics within 1e-6 of the CPU
    metric of its own reconstructions, so the two runs' metrics within 1e-6
    plus what the reconstructions' difference moves the CPU metric by."""
    import numpy as np

    from pdae_torch.data import build_dataset
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.metrics import mse, ssim
    from pdae_torch.sampling import SAMPLERS

    inner = GaussianDiffusion.representation_learning_autoencoding
    captured = []

    def capture(self, *args, **kwargs):
        out = inner(self, *args, **kwargs)
        captured[-1].append(out.cpu())
        return out

    monkeypatch.setattr(GaussianDiffusion, "representation_learning_autoencoding", capture)
    config = dict(card_files, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5",
                  batch_size=4, max_samples=6)
    results = {}
    for device in ("cuda", "cpu"):
        captured.append([])
        ops.reset_launch_counts()
        results[device] = SAMPLERS["autoencoding_eval"](config, device=device).start()
        if device == "cuda":
            counts = ops.launch_counts()
            assert counts["attention"] > 0 and counts["gn_adagn_silu"] > 0, counts
    card, cpu = (torch.cat(c)[:6] for c in captured)
    torch.testing.assert_close(card, cpu, atol=1e-2, rtol=0)
    ds = build_dataset(card_files["dataset_config"])
    x_0 = torch.from_numpy(np.stack([ds[i]["x_0"] for i in range(6)])).permute(0, 3, 1, 2)
    b = (x_0 + 1) / 2

    def cpu_metrics(recon):
        a = (recon + 1) / 2
        return {"ssim": float(ssim(a, b, size_average=False).double().mean()),
                "mse": float(mse(a.numpy(), b.numpy()).mean())}

    own = {"cuda": cpu_metrics(card), "cpu": cpu_metrics(cpu)}
    for k in ("ssim", "mse"):
        for device in ("cuda", "cpu"):
            assert abs(results[device][k] - own[device][k]) <= 1e-6, (device, k)
        assert abs(results["cuda"][k] - results["cpu"][k]) <= \
            2e-6 + abs(own["cuda"][k] - own["cpu"][k]), k


def test_from_config_on_the_card_matches_the_cpu(cuda, card_files):
    """The service built from files on the card (kernels) and on the CPU
    (plain versions): ``encode`` within rtol 1e-4, ``autoencode`` and
    ``manipulate`` within one uint8 level."""
    import numpy as np

    from pdae_torch.serving import PDAEService

    config = dict(card_files, encoder_ddim_style="ddim5", decoder_ddim_style="ddim5",
                  encode_ddim_style="ddim5", decode_ddim_style="ddim5")
    card = PDAEService.from_config(config)
    cpu = PDAEService.from_config(config, device="cpu")
    assert card.device.type == "cuda"
    images = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3), np.uint8)
    ops.reset_launch_counts()
    np.testing.assert_allclose(card.encode(images), cpu.encode(images), rtol=1e-4, atol=1e-5)
    for op in (lambda s: s.autoencode(images),
               lambda s: s.manipulate(images, attribute="Smiling", scale=0.3)):
        got, want = op(card), op(cpu)
        assert got.shape == want.shape == (2, 64, 64, 3)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    counts = ops.launch_counts()
    assert counts["attention"] > 0 and counts["gn_adagn_silu"] > 0, counts
    assert card.generate(2, seed=0).shape == (2, 64, 64, 3)


# -- the regular, latent and manipulation trainers on the card ------------- #

def _structure(model, *inputs):
    """The GN chains and attention blocks one forward of ``model`` runs,
    counted with hooks on a plain-path call."""
    from pdae_torch.models.blocks import AttentionBlock, GNSiluChain
    counts = {"attention": 0, "gn_adagn_silu": 0}

    def hook(mod, args):
        counts["gn_adagn_silu" if isinstance(mod, GNSiluChain) else "attention"] += 1

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, (GNSiluChain, AttentionBlock))]
    ops.set_use_kernels(False)
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        ops.set_use_kernels(None)
        for h in handles:
            h.remove()
    return counts


def _stage_config(stage, files):
    ds = {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3, "length": 8,
          "transfer_uint8": True, "device_resident": True}
    cfg = {"train_dataset_config": ds, "eval_dataset_config": {},
           "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
           "dataloader_config": {"train": {"num_workers": 1, "batch_size": 2},
                                 "eval": {"num_generations": 2}},
           "optimizer_config": {"lr": 1e-3},
           "runner_config": {"display_steps": 1, "evaluate_every_steps": 100000,
                             "save_latest_every_steps": 2, "ema_decay": 0.9}}
    if stage == "regular":
        cfg["denoise_fn_config"] = {"model": "UNet", **CARD_DPM, "num_class": 10}
        return cfg
    cfg.update(trained_representation_learning_config=files["config_path"],
               trained_representation_learning_checkpoint=files["checkpoint_path"],
               inferred_latents=files["inferred_latents_path"])
    if stage.startswith("latent"):
        cfg["latent_denoise_fn_config"] = {"input_channel": 16, "model_channel": 64,
                                           "num_layers": 4}
    else:
        cfg["num_classes"] = 40
        ds["multilabel"] = 40
    if stage.endswith("precomputed"):
        cfg["runner_config"]["latent_train_source"] = "precomputed"
    return cfg


@pytest.mark.parametrize("stage", ["regular", "latent", "latent_precomputed",
                                   "manipulation"])
def test_stage_trainer_steps_and_resumes_on_the_card(cuda, card_files, tmp_path, stage):
    """Each new trainer on the card over a resident uint8 SYNTHETIC 64px
    corpus at b2 (the regular DPM class-conditional with the device flip):
    every step's launches equal the structure's (the UNet's forward and a GN
    backward per chain; the frozen encoder's forward; none for precomputed
    z), the eval runs through the kernels, and a resumed trainer holds the
    step-2 tensors bit for bit."""
    from pdae_torch.train import pick_trainer

    config = _stage_config(stage, card_files)
    run = str(tmp_path / "run")
    trainer = pick_trainer(config)(config=config, run_path=run)
    assert trainer.device.type == "cuda"
    if stage == "regular":
        trainer.train_dataset.augmentation = True      # SYNTHETIC has no host flip
        per = _structure(trainer.model, torch.zeros(2, 3, 64, 64, device="cuda"),
                         torch.zeros(2, dtype=torch.int32, device="cuda"),
                         torch.zeros(2, dtype=torch.int32, device="cuda"))
        want = {**per, "gn_adagn_silu_bwd": per["gn_adagn_silu"]}
    elif stage.endswith("precomputed"):
        want = {"attention": 0, "gn_adagn_silu": 0, "gn_adagn_silu_bwd": 0}
    else:
        want = {**_structure(trainer.encoder, torch.zeros(2, 3, 64, 64, device="cuda")),
                "gn_adagn_silu_bwd": 0}
    seen, inner = [], trainer.train_step

    def counted(batch):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = inner(batch)
        torch.cuda.synchronize()
        seen.append({k: ops.launch_counts()[k] for k in want})
        return out

    trainer.train_step = counted
    assert trainer.train(max_steps=2) == 2
    assert seen == [want, want]
    ops.reset_launch_counts()
    if stage == "regular":
        trainer.evaluate(2, ddim_style="ddim4")
    elif stage == "manipulation":
        trainer.evaluate(2, encode_style="ddim3", decode_style="ddim3")
    else:
        trainer.evaluate(2, latent_ddim_style="ddim3", decoder_ddim_style="ddim3")
    assert ops.launch_counts()["gn_adagn_silu"] > 0
    resumed = pick_trainer(config)(config=config, run_path=run, resume="latest")
    assert resumed.start_step == 2
    for key, p in trainer.state.params["model"].items():
        q = resumed.state.params["model"][key]
        assert q.device.type == "cuda" and torch.equal(p, q), key
        assert torch.equal(trainer.state.ema_params["model"][key],
                           resumed.state.ema_params["model"][key])
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(trainer.optimizer.state[p][m], resumed.optimizer.state[q][m])


def _rep_config(k):
    return {
        "train_dataset_config": {"name": "SYNTHETIC", "image_size": 64, "image_channel": 3,
                                 "length": 8},
        "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
        "trained_ddpm_config": {"denoise_fn_config": CARD_DPM},
        "encoder_config": {"model": "CELEBA64Encoder", "latent_dim": 16},
        "decoder_config": {"model": "ShiftUNet", "latent_dim": 16},
        "dataloader_config": {"train": {"num_workers": 1, "batch_size": 2}},
        "optimizer_config": {"lr": 1e-3},
        "runner_config": {"display_steps": 4, "evaluate_every_steps": 100000,
                          "save_latest_every_steps": 100000, "ema_decay": 0.9,
                          "steps_per_dispatch": k}}


def _assert_same_state(a, b):
    for group, named in a.state.params.items():
        for key, p in named.items():
            q = b.state.params[group][key]
            assert torch.equal(p, q), key
            assert torch.equal(a.state.ema_params[group][key], b.state.ema_params[group][key])
            for m in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a.optimizer.state[p][m], b.optimizer.state[q][m]), m
    assert a.step == b.step


def _losses_of(trainer):
    seen, inner = [], trainer._chunk_runner

    def runner(*args):
        run = inner(*args)

        def wrapped(c):
            out, load = run(c)
            seen.extend(m["prediction_loss"] for m in out)
            return out, load
        return wrapped

    trainer._chunk_runner = runner
    return seen


def test_the_captured_representation_step_replays_the_eager_one(cuda, tmp_path):
    """K=4 on the card: the first step is the eager warm-up, then one capture
    and 3 replays, each after the streams are re-seeded; every loss, param,
    EMA tensor, Adam moment and the count equal the K=1 eager run's bit for
    bit (cuDNN deterministic), and a replay's launches are one step's."""
    from pdae_torch.training import RepresentationLearningTrainer

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = RepresentationLearningTrainer(config=_rep_config(1),
                                              run_path=str(tmp_path / "e"))
        want = _losses_of(eager)
        ops.reset_launch_counts()
        eager.train(max_steps=4, save_on_exit=False)
        per_step = {k: v // 4 for k, v in ops.launch_counts().items()}
        graph = RepresentationLearningTrainer(config=_rep_config(4),
                                              run_path=str(tmp_path / "g"))
        got = _losses_of(graph)
        graph.train(max_steps=4, save_on_exit=False)
    finally:
        torch.backends.cudnn.deterministic = saved
    dispatch = graph._dispatch
    assert dispatch.replays == 3 and list(dispatch.graphs) == [True]
    assert dispatch.launches == per_step
    assert all(per_step[k] for k in ("attention", "gn_adagn_silu", "gn_adagn_silu_bwd"))
    assert len(got) == len(want) == 4
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    _assert_same_state(graph, eager)


def test_a_resident_latent_chunk_replays_the_eager_steps(cuda, card_files, tmp_path):
    """The latent trainer over a resident uint8 corpus at K=3: the epoch
    index rows copied into the static buffer, the gather and the draws in
    the graph; 7 steps (a chunk of 3 whose first step is the warm-up, a
    chunk of 3, a tail of 1) equal the eager K=1 run's bit for bit."""
    from pdae_torch.train import pick_trainer

    def config(k):
        cfg = _stage_config("latent", card_files)
        cfg["runner_config"].update(display_steps=3, save_latest_every_steps=3 * 10 ** 5,
                                    evaluate_every_steps=3 * 10 ** 5,
                                    save_checkpoint_every_steps=3 * 10 ** 5,
                                    steps_per_dispatch=k)
        return cfg

    eager = pick_trainer(config(1))(config=config(1), run_path=str(tmp_path / "e"))
    want = _losses_of(eager)
    eager.train(max_steps=7, save_on_exit=False)
    graph = pick_trainer(config(3))(config=config(3), run_path=str(tmp_path / "g"))
    got = _losses_of(graph)
    graph.train(max_steps=7, save_on_exit=False)
    assert graph._dispatch.replays == 6 and sorted(graph._dispatch.static) == ["indices"]
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and len(got) == 7
    _assert_same_state(graph, eager)


def test_dropout_under_remat_replays_the_eager_masks(cuda, tmp_path):
    """The shift branch with dropout 0.1 under ``remat: skips`` at K=2: the
    checkpoint stashes the RNG state inside the capture and the recompute
    draws the forward's masks, so the replays equal the eager K=1 steps bit
    for bit."""
    from pdae_torch.training import RepresentationLearningTrainer

    def config(k):
        cfg = _rep_config(k)
        cfg["trained_ddpm_config"] = {"denoise_fn_config": {**CARD_DPM, "dropout": 0.1}}
        cfg["runner_config"].update(remat="skips", display_steps=2)
        return cfg

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager = RepresentationLearningTrainer(config=config(1), run_path=str(tmp_path / "e"))
        assert eager._dropout
        want = _losses_of(eager)
        eager.train(max_steps=4, save_on_exit=False)
        graph = RepresentationLearningTrainer(config=config(2), run_path=str(tmp_path / "g"))
        got = _losses_of(graph)
        graph.train(max_steps=4, save_on_exit=False)
    finally:
        torch.backends.cudnn.deterministic = saved
    assert graph._dispatch.replays == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and len(got) == 4
    _assert_same_state(graph, eager)


def test_a_capture_that_fails_raises_rather_than_runs_eagerly(cuda, tmp_path):
    """A step that synchronises with the host cannot be captured: the loop
    raises, and no step past the warm-up has run."""
    from pdae_torch.training import RepresentationLearningTrainer

    trainer = RepresentationLearningTrainer(config=_rep_config(4), run_path=str(tmp_path))
    inner = trainer._step

    def syncing(batch, ema=None):
        out = inner(batch, ema=ema)
        float(out["prediction_loss"])            # a host read: illegal in a capture
        return out

    trainer._step = syncing
    with pytest.raises(RuntimeError, match="capturing the train step into a CUDA graph"):
        trainer.train(max_steps=4, save_on_exit=False)
    assert trainer.step == 1 and trainer._dispatch.replays == 0


# -- channels-last: the NHWC variants and the bf16 models' layout ----------- #

def _cl(t):
    return t.contiguous(memory_format=torch.channels_last)


def _cl_inputs(cuda, shape, variant, dtype, seed=6):
    """``_bwd_inputs``'s tensors with x and g channels-last, and the NCHW
    plain version's stats of x."""
    x, g, _, _, gamma, beta, coef = _bwd_inputs(cuda, shape, variant, dtype, seed)
    _, mean, rstd = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, groups=32, return_stats=True)
    return _cl(x), _cl(g), mean, rstd, gamma, beta, coef


# every kind of GN shape of the bf16 FFHQ128 step at b2 (4 to 32 channels a
# group, 4x4 to 128x128; 384 and 768 channels give 3-vector rows), then the
# edges: 96 channels (3 a group), one channel a group, a tile read twice (over
# the cluster's shared memory) and H*W of no power of two
NHWC_SHAPES = [(2, 128, 128, 128), (2, 256, 128, 128), (2, 384, 64, 64), (2, 256, 64, 64),
               (2, 128, 32, 32), (2, 384, 32, 32), (2, 512, 32, 32), (2, 768, 16, 16),
               (2, 256, 16, 16), (2, 1024, 8, 8), (2, 768, 8, 8), (2, 512, 4, 4),
               (2, 1024, 4, 4), (2, 64, 64, 64), (3, 96, 12, 12), (2, 32, 16, 16),
               (1, 64, 256, 256), (2, 128, 10, 6)]


@pytest.mark.parametrize("shape", NHWC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_gn_kernel_matches_plain(cuda, shape, dtype):
    x, _, mean_w, rstd_w, gamma, beta, coef = _cl_inputs(cuda, shape, "adagn_z", dtype)
    before = dict(groupnorm.variant_launches)
    got, mean, rstd = groupnorm.gn_cuda(x, gamma, beta, *coef, groups=32, save_stats=True)
    torch.cuda.synchronize()
    assert groupnorm.variant_launches["nhwc"] == before["nhwc"] + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = ops.gn_adagn_silu_fwd(x.contiguous(), gamma, beta, *coef, groups=32)
    tol = (1e-4, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    torch.testing.assert_close(got.float(), want.float(), atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(mean, mean_w, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstd_w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", NHWC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("need_dx", [True, False])
def test_nhwc_gn_backward_kernel_matches_plain(cuda, shape, dtype, need_dx):
    x, g, mean, rstd, gamma, beta, coef = _cl_inputs(cuda, shape, "adagn_z", dtype)
    before = dict(groupnorm_train.variant_launches)
    got = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef, need_dx=need_dx)
    torch.cuda.synchronize()
    assert groupnorm_train.variant_launches["nhwc"] == before["nhwc"] + 1
    if need_dx:
        assert got[0].is_contiguous(memory_format=torch.channels_last)
    want = ops.gn_adagn_silu_bwd_plain(x.contiguous(), g.contiguous(), mean, rstd, gamma,
                                       beta, *coef, need_dx=need_dx)
    _assert_bwd_close(got, want, dtype)


def test_nhwc_gn_misaligned_input_takes_one_element_columns(cuda):
    """An x 2 bytes off the 16-byte vector: the NHWC variants read one
    element a column (and twice), with the aligned launch's values."""
    x, g, mean, rstd, gamma, beta, coef = _cl_inputs(cuda, (2, 256, 16, 16), "adagn",
                                                     torch.bfloat16)
    off = _cl(torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view(
        2, 16, 16, 256).permute(0, 3, 1, 2).copy_(x))
    assert off.data_ptr() % 16 and groupnorm.memory_layout(off) == "nhwc"
    assert groupnorm.nhwc_plan_for(off, off, 32).vec == 1
    aligned = groupnorm.gn_cuda(x, gamma, beta, *coef)
    torch.testing.assert_close(groupnorm.gn_cuda(off, gamma, beta, *coef).float(),
                               aligned.float(), atol=2e-2, rtol=2e-2)
    want = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    got = groupnorm_train.gn_bwd_cuda(off, g, mean, rstd, gamma, beta, *coef)
    torch.cuda.synchronize()
    _assert_bwd_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nhwc_gn_backward_repeats_bit_for_bit(cuda, dtype):
    x, g, mean, rstd, gamma, beta, coef = _cl_inputs(cuda, (8, 256, 128, 128), "adagn_z",
                                                     dtype)
    first = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    second = groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef)
    torch.cuda.synchronize()
    assert groupnorm_train.nhwc_plan_for(x, g, first[0], 32).cluster > 1
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_nhwc_cluster_launches_capture_in_a_cuda_graph(cuda):
    x, g, mean, rstd, gamma, beta, coef = _cl_inputs(cuda, (4, 128, 128, 128), "adagn_z",
                                                     torch.bfloat16)
    assert groupnorm.nhwc_plan_for(x, x, 32).cluster > 1

    def both():
        return (groupnorm.gn_cuda(x, gamma, beta, *coef),
                *groupnorm_train.gn_bwd_cuda(x, g, mean, rstd, gamma, beta, *coef))
    eager = both()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        both()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = both()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_nhwc_kernels_refuse_fold_mode_and_other_strides(cuda):
    x = _cl(torch.randn(2, 64, 8, 8, device=cuda))
    one, zero = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="fold mode"):
        ops.fused_gn_adagn_silu(x, one, zero, torch.zeros(2, 64, device=cuda),
                                torch.zeros(2, 64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.gn_adagn_silu(x.permute(0, 1, 3, 2), one, zero, groups=32)
    with pytest.raises(ValueError, match="contiguous"):      # the split passes take NCHW
        groupnorm.gn_apply_cuda(x, torch.zeros(2, 32, device=cuda),
                                torch.ones(2, 32, device=cuda), one, zero)


def _ffhq128_bf16_models(cuda, encoder_too=True):
    from pdae_torch.models import FFHQ128_DPM, ShiftUNet, encoder_for_resolution

    torch.manual_seed(0)
    decoder = ShiftUNet(latent_dim=512, dtype=torch.bfloat16, **FFHQ128_DPM)
    encoder = encoder_for_resolution(128, 512, dtype=torch.bfloat16)
    with torch.no_grad():
        for model in (decoder, encoder):
            for p in model.parameters():
                if not p.any():
                    p.normal_(std=0.02)
    return encoder.to(cuda), decoder.to(cuda)


def test_bf16_ffhq128_step_runs_every_gn_launch_on_the_nhwc_variants(cuda):
    """A bf16 FFHQ128 representation loss and backward at b2: every GN launch,
    forward and backward, on the NHWC variants; the outputs contiguous NCHW;
    and within bf16 rounding of the same models run NCHW (the layout rule
    switched off)."""
    from pdae_torch.diffusion import GaussianDiffusion
    from pdae_torch.models import blocks
    from pdae_torch.training import trainable_params
    from pdae_torch.training.state import flat_params

    encoder, decoder = _ffhq128_bf16_models(cuda)
    gd = GaussianDiffusion({"timesteps": 1000, "betas_type": "linear"})
    gen = torch.Generator(device=cuda).manual_seed(1)
    x_0 = torch.rand(2, 3, 128, 128, device=cuda, generator=gen) * 2 - 1
    noise = torch.randn(2, 3, 128, 128, device=cuda, generator=gen)
    t = torch.tensor([10, 500], dtype=torch.int32, device=cuda)
    leaves = flat_params(trainable_params(encoder, decoder))

    def loss_and_grads():
        loss = gd.representation_learning_train_one_batch(
            None, encoder, decoder, x_0, t=t, noise=noise)["prediction_loss"]
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    ops.reset_launch_counts()
    got = loss_and_grads()
    torch.cuda.synchronize()
    fwd, bwd = ops.gn_variant_counts(), ops.gn_bwd_variant_counts()
    assert fwd["nhwc"] > 0 and fwd["cluster"] == fwd["general"] == 0, fwd
    assert bwd["nhwc"] > 0 and bwd["cluster"] == bwd["general"] == 0, bwd
    counts = ops.launch_counts()
    assert counts["gn_adagn_silu_nhwc"] == counts["gn_adagn_silu"] == fwd["nhwc"]
    assert counts["gn_adagn_silu_bwd_nhwc"] == counts["gn_adagn_silu_bwd"] == bwd["nhwc"]
    eps, grad = decoder(x_0, t, encoder(x_0))
    assert eps.is_contiguous() and grad.is_contiguous() and eps.dtype == torch.float32
    rule = blocks.nhwc_model
    blocks.nhwc_model = lambda model: False
    try:
        ops.reset_launch_counts()
        want = loss_and_grads()
        assert ops.gn_variant_counts()["nhwc"] == 0
    finally:
        blocks.nhwc_model = rule
    assert _rel_l2(got[:1], want[:1]) <= 2e-2
    assert _rel_l2(got[1:], want[1:]) <= 5e-2


def test_fp32_celeba64_evaluation_stays_on_the_nchw_variants(cuda):
    """The fp32 celeba64 ShiftUNet's evaluation at b2: the parent's launches
    by variant (92 an evaluation, all on the cluster variant), none NHWC."""
    from pdae_torch.models import CELEBA64_DPM, ShiftUNet

    decoder = ShiftUNet(latent_dim=512, **CELEBA64_DPM).to(cuda).eval()
    ops.reset_launch_counts()
    with torch.no_grad():
        decoder(torch.randn(2, 3, 64, 64, device=cuda), torch.tensor([5, 9], device=cuda),
                torch.randn(2, 512, device=cuda))
    torch.cuda.synchronize()
    assert ops.gn_variant_counts() == {"cluster": 92, "general": 0, "nhwc": 0}
