"""The port's ops (``pdae_torch.ops``) against the JAX package's on the CPU.

Each op's plain PyTorch version is held against the JAX function it mirrors,
and the Pallas kernel it replaces (run in interpret mode), on the same numpy
inputs. The CUDA kernels themselves run only on the card (``chip_smoke.py``).
Tolerance: 2e-5 absolute and relative in fp32, the repo's own bound for the
Pallas kernels against their references (sums taken in another order).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdae_tpu.ops.attention import _pallas_attention
from pdae_tpu.ops.attention import reference_attention as jax_reference_attention
from pdae_tpu.ops.groupnorm import _pallas_gn
from pdae_tpu.ops.groupnorm_train import gn_adagn_silu_inline
from pdae_torch import ops
from pdae_torch.ops import attention as port_attention
from pdae_torch.ops import groupnorm as port_groupnorm
from pdae_torch.ops import _dispatch

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_kernel_switch():
    saved = _dispatch._USE_KERNELS
    yield
    _dispatch._USE_KERNELS = saved


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape", [(2, 2, 64, 32), (1, 4, 256, 64), (3, 1, 16, 16),
                                   (2, 4, 64, 128), (2, 4, 256, 32)])
def test_attention_matches_pallas_and_jax_reference(shape):
    q, k, v = _qkv(shape)
    scale = 1.0 / np.sqrt(np.sqrt(shape[-1]))
    got = ops.reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  scale).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(
        _pallas_attention(jq, jk, jv, interpret=True)), **TOL)
    np.testing.assert_allclose(got, np.asarray(
        jax_reference_attention(jq, jk, jv, scale)), **TOL)


def _gn_inputs(shape, seed):
    """NHWC x and its [C] / [B, C] coefficients, as the JAX tests make them."""
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    x = rs.randn(*shape).astype(np.float32)
    gs, gb = (rs.randn(c).astype(np.float32) for _ in range(2))
    s, t, zs, zt = ((rs.randn(b, c) * 0.1).astype(np.float32) for _ in range(4))
    return x, gs, gb, s, t, zs, zt


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nchw(x):
    return _t(x.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 64), 32), ((1, 16, 16, 32), 8),
                                          ((3, 4, 4, 128), 32)])
def test_fold_mode_plain_version_matches_pallas(shape, groups):
    x, gs, gb, s, t, zs, zt = _gn_inputs(shape, 0)
    want = np.asarray(_pallas_gn(*(jnp.asarray(a) for a in (x, gs, gb, s, t, zs, zt)),
                                 groups, interpret=True))
    got = ops.reference_gn_adagn_silu(_nchw(x), *(_t(a) for a in (gs, gb, s, t, zs, zt)),
                                      groups)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)
    # the fold-mode op on a CPU tensor is its plain version, z = None -> zeros
    no_z = ops.fused_gn_adagn_silu(_nchw(x), _t(gs), _t(gb), _t(s), _t(t),
                                   groups=groups)
    want_no_z = ops.reference_gn_adagn_silu(
        _nchw(x), _t(gs), _t(gb), _t(s), _t(t), torch.zeros_like(_t(s)),
        torch.zeros_like(_t(s)), groups)
    assert torch.equal(no_z, want_no_z)


@pytest.mark.parametrize("channels", [128, 384])          # 4 and 12 per group
@pytest.mark.parametrize("variant", ["plain", "adagn", "adagn_z"])
def test_model_mode_plain_version_matches_jax_fwd(channels, variant):
    x, gs, gb, s, t, zs, zt = _gn_inputs((2, 8, 8, channels), 1)
    zeros = np.zeros_like(s)
    jax_args = {"plain": (zeros, zeros, zeros, zeros), "adagn": (s, t, zeros, zeros),
                "adagn_z": (s, t, zs, zt)}[variant]
    want = np.asarray(gn_adagn_silu_inline(
        *(jnp.asarray(a) for a in (x, gs, gb) + jax_args), 32))
    port_args = {"plain": (None,) * 4, "adagn": (_t(s), _t(t), None, None),
                 "adagn_z": (_t(s), _t(t), _t(zs), _t(zt))}[variant]
    got = ops.gn_adagn_silu_fwd(_nchw(x), _t(gs), _t(gb), *port_args, groups=32)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, **TOL)
    # the model-mode op on a CPU tensor runs exactly its plain version
    assert torch.equal(ops.gn_adagn_silu(_nchw(x), _t(gs), _t(gb), *port_args,
                                         groups=32), got)


def test_none_coefficients_equal_zeros():
    x, gs, gb, s, *_ = _gn_inputs((2, 4, 4, 64), 2)
    zero = torch.zeros_like(_t(s))
    assert torch.equal(
        ops.gn_adagn_silu_fwd(_nchw(x), _t(gs), _t(gb), groups=32),
        ops.gn_adagn_silu_fwd(_nchw(x), _t(gs), _t(gb), zero, zero, zero, zero, 32))


def test_cpu_dispatch_takes_plain_path_and_counts_nothing():
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 8, 16)
    out = ops.fused_qkv_attention(q, q, q)
    assert torch.equal(out, ops.reference_attention(q, q, q, 16 ** -0.25))
    ops.gn_adagn_silu(torch.randn(1, 32, 4, 4), torch.ones(32), torch.zeros(32),
                      groups=32)
    assert ops.launch_counts() == {"attention": 0, "gn_adagn_silu": 0,
                                   "gn_adagn_silu_bwd": 0, "gn_stats": 0, "gn_apply": 0,
                                   "gn_bwd_moments": 0, "gn_bwd_dx": 0,
                                   "gn_adagn_silu_nhwc": 0, "gn_adagn_silu_bwd_nhwc": 0}
    ops.set_use_kernels(False)
    assert torch.equal(ops.fused_qkv_attention(q, q, q), out)


def test_forced_kernels_raise_on_cpu_tensors():
    ops.set_use_kernels(True)
    q = torch.randn(1, 1, 8, 8)
    with pytest.raises(RuntimeError, match="CUDA only"):
        ops.fused_qkv_attention(q, q, q)
    with pytest.raises(RuntimeError, match="CUDA only"):
        ops.gn_adagn_silu(torch.randn(1, 32, 4, 4), torch.ones(32), torch.zeros(32),
                          groups=32)
    with pytest.raises(ValueError):
        ops.set_use_kernels("yes")


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 1, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        port_attention.attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        port_groupnorm.gn_cuda(torch.randn(1, 32, 4, 4), torch.ones(32),
                               torch.zeros(32))


def test_import_needs_no_nvcc_card_or_jax():
    """``import pdae_torch`` (every module) works with no nvcc on PATH and no
    visible card, and pulls in no JAX."""
    code = ("import sys, pdae_torch, pdae_torch.ops, pdae_torch.serving, "
            "pdae_torch.utils, pdae_torch.training, "
            "pdae_torch.tools.profile_train_step; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pdae_tpu')]; "
            "assert not bad, bad; print('ok')")
    env = {"PATH": os.path.dirname(sys.executable), "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": REPO, "HOME": os.environ.get("HOME", "/tmp")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
