"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a card). Run where the card is, without the JAX conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version at the celeba64
path's shapes, fp32 with TF32 off: attention within 2e-5 + 1e-4*|ref|, the
GN chain within 1e-4 + 1e-4*|ref| (sums in another order). ``chip_smoke.py``
covers every path shape, bf16 and timings.
"""

import pytest
import torch

from pdae_torch import ops
from pdae_torch.ops import _dispatch, attention, groupnorm

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
