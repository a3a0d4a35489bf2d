"""Shared helpers of the ``tests/test_torch_*.py`` parity tests: tiny flax
models with perturbed weights, and NHWC <-> NCHW moves between the packages.

Inputs and weights are made with numpy from a seed and handed to both
``pdae_tpu`` (JAX, on the CPU) and ``pdae_torch`` (PyTorch, on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import TINY_DPM  # noqa: F401  (re-exported for the tests)


def perturb(params, seed: int):
    """Numpy copy of a flax param tree with every all-zero leaf (zero-init
    output convs and projections, biases) replaced by small noise and every
    GroupNorm ``scale`` moved off 1, so a conversion slip cannot hide behind
    zeros or ones."""
    rs = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if not a.any():
                a = (0.05 * rs.randn(*a.shape)).astype(np.float32)
            elif k == "scale":
                a = (a + 0.1 * rs.randn(*a.shape)).astype(np.float32)
            out[k] = a
        return out

    return walk(params)


def init_flax(model, *args, seed: int = 0):
    """Initialise a flax model on the given example inputs and perturb it."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed), *args)["params"]
    return perturb(jax.device_get(params), seed + 100)


def nchw(a) -> torch.Tensor:
    """NHWC numpy -> NCHW torch (CPU)."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def jnp_f32(a):
    return jnp.asarray(np.asarray(a, np.float32))


# -- a toy epsilon model (no weights), the same function in both packages -- #

def toy_eps_jax(x, t, condition=None):
    tt = (t.astype(jnp.float32) / 1000.0).reshape((-1,) + (1,) * (x.ndim - 1))
    return 0.3 * jnp.tanh(x) + 0.1 * jnp.sin(3.0 * x) * tt


def toy_eps_torch(x, t, condition=None):
    tt = (t.float() / 1000.0).reshape((-1,) + (1,) * (x.dim() - 1))
    return 0.3 * torch.tanh(x) + 0.1 * torch.sin(3.0 * x) * tt


def tiny_shift_decoders(latent: int, seed: int = 5, size: int = 16):
    """The tiny ShiftUNet (``TINY_DPM``) with perturbed weights in both
    packages, as ``decoder(x, t, z) -> (eps, gradient)`` callables that both
    take and give NHWC (the port's is wrapped), so one loop's inputs serve
    both."""
    from pdae_tpu.models import ShiftUNet as JaxShiftUNet
    from pdae_torch.models import ShiftUNet
    from pdae_torch.utils import unet_state_dict

    model = JaxShiftUNet(latent_dim=latent, **TINY_DPM)
    params = init_flax(model, jnp.zeros((1, size, size, 3)), jnp.zeros((1,), jnp.int32),
                       jnp.zeros((1, latent)), seed=seed)
    port = ShiftUNet(latent_dim=latent, **TINY_DPM).eval()
    port.load_state_dict(unet_state_dict(params), strict=True)

    def jax_decoder(xx, tt, zz):
        return model.apply({"params": params}, xx, tt, zz)

    def port_decoder(xx, tt, zz):
        eps, g = port(xx.permute(0, 3, 1, 2), tt, zz)
        return eps.permute(0, 2, 3, 1), g.permute(0, 2, 3, 1)

    return jax_decoder, port_decoder
