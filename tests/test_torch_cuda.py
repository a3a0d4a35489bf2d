"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a card). Run where the card is, without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version at the celeba64
path's shapes, fp32 with TF32 off: attention within 2e-5 + 1e-4*|ref|, the
GN chain within 1e-4 + 1e-4*|ref| (sums in another order). The two autograd
Functions (GN chain: forward and backward kernels; attention: forward kernel,
plain-torch backward) are held against the same Functions on the plain
versions (``set_use_kernels(False)``): every gradient within
1e-4 * max(1, max|ref|) + 1e-4 * |ref|. ``chip_smoke.py`` covers every path
shape, bf16 and timings.
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


@pytest.mark.parametrize("shape", [(8, 4, 64, 128), (8, 4, 256, 32), (3, 1, 16, 16)])
def test_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda) for _ in range(3))
    before = attention.launches
    got = ops.fused_qkv_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = ops.reference_attention(q, k, v, shape[-1] ** -0.25)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,variant", [((8, 384, 64, 64), "plain"),
                                           ((8, 128, 64, 64), "adagn_z"),
                                           ((8, 512, 8, 8), "adagn")])
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
    got = ops.gn_adagn_silu(x, gamma, beta, *coef, groups=32)
    want = ops.gn_adagn_silu_fwd(x, gamma, beta, *coef, groups=32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    zero = torch.zeros_like(s)
    full = tuple(zero if a is None else a for a in coef)
    got = ops.fused_gn_adagn_silu(x, gamma, beta, *full, groups=32)
    want = ops.reference_gn_adagn_silu(x, gamma, beta, *full, 32)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


def test_kernels_raise_rather_than_fall_back(cuda):
    q = torch.randn(1, 1, 1024, 256, device=cuda)          # K and V overflow smem
    with pytest.raises(ValueError, match="shared memory"):
        ops.fused_qkv_attention(q, q, q)
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
