"""The port's differentiable ops against the JAX package's on the CPU.

The backward of the GN + AdaGN + SiLU chain (``pdae_torch.ops.groupnorm_train``,
whose plain version stands in for the CUDA kernel on CPU tensors) is held
against ``jax.vjp`` of ``gn_adagn_silu_train`` and against the TPU kernel
``_bwd_kernel`` itself, run through a ``pl.pallas_call(..., interpret=True)``
that this file builds as ``_bwd_pallas`` does. The attention backward is held
against ``jax.vjp`` of ``_attention_core``. Inputs come from a numpy seed.

Tolerances, each times ``max(1, max|reference|)`` of the tensor compared, as
the JAX package's own test of this backward scales them
(``tests/test_groupnorm_train.py``): 1e-4 in fp32 (sums in another order),
3e-2 in bf16 (the backward recomputes y from the fp32 fold while the forward
rounded after the affine; both packages make that choice).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pdae_tpu.ops import attention as jax_attention
from pdae_tpu.ops.groupnorm_train import (_bwd_kernel, _fold_affine, _stats,
                                          gn_adagn_silu_train as jax_gn_train)
from pdae_torch import ops
from pdae_torch.ops import groupnorm_train as port_train

torch.set_num_threads(1)
NAMES = ["dx", "dgamma", "dbeta", "dscale", "dshift", "dz_scale", "dz_shift"]
JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(shape, seed, constant=False):
    """NHWC x and cotangent, [C] GroupNorm parameters, four [B, C] vectors."""
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    x = rs.randn(*shape).astype(np.float32)
    if constant:
        x[:] = 0.75                      # every slab flat: rstd = 1/sqrt(eps)
    cot = rs.randn(*shape).astype(np.float32)
    gs = (1.0 + 0.2 * rs.randn(c)).astype(np.float32)
    gb = (0.2 * rs.randn(c)).astype(np.float32)
    vecs = [(0.3 * rs.randn(b, c)).astype(np.float32) for _ in range(4)]
    return x, cot, gs, gb, vecs


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _np(t, nhwc=False):
    a = t.detach().float().numpy()
    return a.transpose(0, 2, 3, 1) if nhwc else a


def _jax_grads(x, cot, gs, gb, vecs, groups, dtype):
    args = (jnp.asarray(x, dtype), jnp.asarray(gs), jnp.asarray(gb),
            *(jnp.asarray(v, dtype) for v in vecs))
    out, vjp = jax.vjp(lambda *a: jax_gn_train(*a, groups), *args)
    return out, vjp(jnp.asarray(cot, dtype))


def _port_grads(x, cot, gs, gb, vecs, groups, dtype):
    """Grads of the port's chain; an entry of ``vecs`` may be None."""
    leaves = [_nchw(x, dtype).requires_grad_(), torch.from_numpy(gs).requires_grad_(),
              torch.from_numpy(gb).requires_grad_()]
    leaves += [None if v is None else torch.from_numpy(v).to(dtype).requires_grad_()
               for v in vecs]
    out = ops.gn_adagn_silu(*leaves, groups=groups)
    present = [a for a in leaves if a is not None]
    grads = iter(torch.autograd.grad(out, present, _nchw(cot, dtype)))
    return out, [None if a is None else next(grads) for a in leaves]


def _assert_grads(got, want, tol):
    for name, a, b in zip(NAMES, got, want):
        b64 = np.asarray(b, np.float64)
        a64 = _np(a, nhwc=(name == "dx")).astype(np.float64)
        np.testing.assert_allclose(a64, b64, rtol=0,
                                   atol=tol * max(float(np.abs(b64).max()), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("variant", ["plain", "adagn", "adagn_z"])
def test_chain_grads_match_jax_vjp(dtype, tol, variant):
    x, cot, gs, gb, vecs = _inputs((3, 8, 8, 64), 0)
    zero = np.zeros_like(vecs[0])
    vecs = {"plain": [zero] * 4, "adagn": vecs[:2] + [zero, zero],
            "adagn_z": vecs}[variant]
    want_out, want = _jax_grads(x, cot, gs, gb, vecs, 32, JAX_DTYPE[dtype])
    out, got = _port_grads(x, cot, gs, gb, vecs, 32, dtype)
    # forward: fp32 as the other op tests; bf16 within two bf16 steps (2^-7)
    fwd_tol = dict(rtol=0, atol=2e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(_np(out, nhwc=True), np.asarray(want_out, np.float32),
                               **fwd_tol)
    _assert_grads(got, want, tol)
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype), (a.dtype, b.dtype)


@pytest.mark.parametrize("groups", [32, 16, 1])
def test_chain_grads_match_jax_vjp_by_groups(groups):
    x, cot, gs, gb, vecs = _inputs((2, 4, 4, 64), 1)
    _, want = _jax_grads(x, cot, gs, gb, vecs, groups, jnp.float32)
    _, got = _port_grads(x, cot, gs, gb, vecs, groups, torch.float32)
    _assert_grads(got, want, 1e-4)


def test_chain_grads_on_a_constant_slab():
    """var = 0: rstd = 1/sqrt(eps) and xhat = 0; m2 then multiplies nothing
    large, and every grad stays finite and equal to the JAX package's."""
    x, cot, gs, gb, vecs = _inputs((2, 4, 4, 64), 2, constant=True)
    _, want = _jax_grads(x, cot, gs, gb, vecs, 32, jnp.float32)
    _, got = _port_grads(x, cot, gs, gb, vecs, 32, torch.float32)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _assert_grads(got, want, 1e-4)


@pytest.mark.parametrize("variant", ["plain", "adagn"])
def test_none_coefficients_get_no_grad_and_equal_zeros(variant):
    """The JAX models feed zeros for absent coefficients and get zero grads
    back; the port takes None, gives None, and the other grads are equal."""
    x, cot, gs, gb, vecs = _inputs((2, 4, 4, 64), 3)
    zero = np.zeros_like(vecs[0])
    with_none = [None] * 4 if variant == "plain" else vecs[:2] + [None, None]
    with_zero = [zero if v is None else v for v in with_none]
    out_n, got_n = _port_grads(x, cot, gs, gb, with_none, 32, torch.float32)
    out_z, got_z = _port_grads(x, cot, gs, gb, with_zero, 32, torch.float32)
    assert torch.equal(out_n, out_z)
    for name, v, a, b in zip(NAMES, [1, 1, 1] + with_none, got_n, got_z):
        if v is None:
            assert a is None, name
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=name)


def _pallas_bwd(x, g, a, b, mean, inv, groups):
    """``_bwd_kernel`` in interpret mode, called as ``_bwd_pallas`` calls it:
    (dx [B,H,W,C], dA [B,C], dB [B,C])."""
    bsz, h, w, c = x.shape
    rows = h * w

    def rep8(v):
        return jnp.broadcast_to(v[:, None, :], (bsz, 8, c)).reshape(bsz * 8, c)

    row_spec = pl.BlockSpec((rows, c), lambda i: (i, 0))
    coef_spec = pl.BlockSpec((8, c), lambda i: (i, 0))
    dx, da8, db8 = pl.pallas_call(
        functools.partial(_bwd_kernel, groups=groups, rows=rows),
        grid=(bsz,),
        in_specs=[row_spec, row_spec] + [coef_spec] * 4,
        out_specs=[row_spec, coef_spec, coef_spec],
        out_shape=[jax.ShapeDtypeStruct((bsz * rows, c), x.dtype),
                   jax.ShapeDtypeStruct((bsz * 8, c), jnp.float32),
                   jax.ShapeDtypeStruct((bsz * 8, c), jnp.float32)],
        interpret=True,
    )(x.reshape(bsz * rows, c), g.reshape(bsz * rows, c), rep8(a), rep8(b),
      rep8(jnp.repeat(mean, c // groups, axis=1)),
      rep8(jnp.repeat(inv, c // groups, axis=1)))
    return (dx.reshape(bsz, h, w, c), da8.reshape(bsz, 8, c)[:, 0],
            db8.reshape(bsz, 8, c)[:, 0])


@pytest.mark.parametrize("variant", ["plain", "adagn", "adagn_z"])
@pytest.mark.parametrize("channels,groups", [(128, 32), (64, 16)])
def test_plain_backward_matches_the_tpu_kernel(variant, channels, groups):
    x, cot, gs, gb, vecs = _inputs((2, 8, 8, channels), 4)
    zero = jnp.zeros_like(jnp.asarray(vecs[0]))
    jv = [jnp.asarray(v) for v in vecs]
    jv = {"plain": [zero] * 4, "adagn": jv[:2] + [zero, zero], "adagn_z": jv}[variant]
    a, b = _fold_affine(jnp.asarray(gs), jnp.asarray(gb), *jv)
    mean, inv = _stats(jnp.asarray(x), groups)
    want = _pallas_bwd(jnp.asarray(x), jnp.asarray(cot), a, b, mean, inv, groups)

    pv = {"plain": [None] * 4, "adagn": [torch.from_numpy(v) for v in vecs[:2]]
          + [None, None], "adagn_z": [torch.from_numpy(v) for v in vecs]}[variant]
    xt = _nchw(x)
    _, mean_t, rstd_t = ops.gn_adagn_silu_fwd(
        xt, torch.from_numpy(gs), torch.from_numpy(gb), *pv, groups=groups,
        return_stats=True)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rstd_t.numpy(), np.asarray(inv), rtol=1e-5, atol=0)
    got = ops.gn_adagn_silu_bwd_plain(xt, _nchw(cot), mean_t, rstd_t,
                                      torch.from_numpy(gs), torch.from_numpy(gb),
                                      *pv, groups=groups)
    for name, g_, w_, nhwc in zip(("dx", "dA", "dB"), got, want, (True, False, False)):
        w64 = np.asarray(w_, np.float64)
        np.testing.assert_allclose(_np(g_, nhwc=nhwc), w64, rtol=0, err_msg=name,
                                   atol=1e-4 * max(float(np.abs(w64).max()), 1.0))
    # without an input gradient the sums are the same and dx is not made
    dx, d_a, d_b = ops.gn_adagn_silu_bwd_plain(
        xt, _nchw(cot), mean_t, rstd_t, torch.from_numpy(gs), torch.from_numpy(gb),
        *pv, groups=groups, need_dx=False)
    assert dx is None and torch.equal(d_a, got[1]) and torch.equal(d_b, got[2])


def test_chain_saves_no_activation_sized_tensor_but_x():
    x = torch.randn(2, 64, 8, 8, requires_grad=True)
    s, t = torch.randn(2, 128).chunk(2, dim=1)
    out = ops.gn_adagn_silu(x, torch.ones(64, requires_grad=True), torch.zeros(64),
                            s, t, groups=32)
    big = [v for v in out.grad_fn.saved_tensors if v is not None and v.numel() >= x.numel()]
    assert len(big) == 1 and big[0].data_ptr() == x.data_ptr()


def test_chain_routes_through_the_function_only_for_a_gradient():
    x = torch.randn(2, 64, 4, 4)
    gamma, beta = torch.ones(64, requires_grad=True), torch.zeros(64)
    tracked = ops.gn_adagn_silu(x, gamma, beta, groups=32)
    assert type(tracked.grad_fn).__name__.startswith("_GNAdaGNSiLU")
    with torch.no_grad():
        assert ops.gn_adagn_silu(x, gamma, beta, groups=32).grad_fn is None
    assert ops.gn_adagn_silu(x, gamma.detach(), beta, groups=32).grad_fn is None
    assert torch.equal(tracked, ops.gn_adagn_silu_fwd(x, gamma, beta, groups=32))
    # an input gradient alone (a frozen chain inside a trainable stack) counts
    xg = x.clone().requires_grad_()
    out = ops.gn_adagn_silu(xg, gamma.detach(), beta, groups=32)
    (dx,) = torch.autograd.grad(out.sum(), xg)
    assert dx.shape == x.shape and bool(torch.isfinite(dx).all())
    with pytest.raises(ValueError, match="both set or both None"):
        port_train.gn_adagn_silu_train(xg, gamma, beta, scale=torch.zeros(2, 64))
    assert ops.launch_counts()["gn_adagn_silu_bwd"] == 0     # CPU: plain versions


@pytest.mark.parametrize("shape", [(2, 2, 32, 16), (1, 4, 64, 32)])
def test_attention_backward_matches_jax_custom_vjp(shape):
    rs = np.random.RandomState(5)
    q, k, v = (rs.randn(*shape).astype(np.float32) for _ in range(3))
    orig = jax_attention._pallas_attention
    jax_attention._pallas_attention = lambda q, k, v, interpret=False: orig(
        q, k, v, interpret=True)
    try:
        want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_attention._attention_core(*a))),
                        argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    finally:
        jax_attention._pallas_attention = orig
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.fused_qkv_attention(*leaves)
    assert type(out.grad_fn).__name__.startswith("_Attention")
    got = torch.autograd.grad(out.sin().sum(), leaves)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-5)
    with torch.no_grad():
        assert ops.fused_qkv_attention(*leaves).grad_fn is None


def test_attention_backward_keeps_dtypes_in_bf16():
    q, k, v = (torch.randn(1, 2, 16, 8).bfloat16().requires_grad_() for _ in range(3))
    out = ops.fused_qkv_attention(q, k, v)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in grads)
