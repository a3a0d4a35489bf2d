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
