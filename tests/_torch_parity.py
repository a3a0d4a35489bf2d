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


# -- the tiny representation-learning run of the trainer tests ------------ #

# the stage-1 DPM and stage-2 PDAE of tests/test_training_pipeline.py:
# SYNTHETIC 16px gray, a two-level UNet of 8 channels, 20 timesteps, b8
TRAINER_DPM = {
    "model": "UNet", "input_channel": 1, "base_channel": 8,
    "channel_multiplier": [1, 2], "num_residual_blocks_of_a_block": 1,
    "attention_resolutions": [2], "num_heads": 1, "head_channel": -1,
    "use_new_attention_order": False, "dropout": 0.0,
}
TRAINER_DS = {"name": "SYNTHETIC", "image_size": 16, "image_channel": 1, "length": 32}
TRAINER_RUNNER = {"display_steps": 1, "evaluate_every_steps": 100000,
                  "save_latest_every_steps": 100000,
                  "save_checkpoint_every_steps": 100000, "num_iterations": 1,
                  "ema_every": 1, "ema_decay": 0.9, "compile": False}
TRAINER_OPT = {"lr": 1e-3, "adam_betas": "(0.9, 0.999)", "adam_eps": 1e-8,
               "weight_decay": 0.0, "enable_amp": False}
TRAINER_LATENT = 16


def tiny_pdae_config(ddpm_checkpoint=None, **runner):
    """A stage-2 config both packages' ``RepresentationLearningTrainer``
    read; ``runner`` overrides keys of ``runner_config``."""
    cfg = {
        "train_dataset_config": {**TRAINER_DS, "latent_dim": TRAINER_LATENT},
        "eval_dataset_config": {},
        "diffusion_config": {"timesteps": 20, "betas_type": "linear"},
        "trained_ddpm_config": {"denoise_fn_config": TRAINER_DPM},
        "encoder_config": {"model": "CELEBA64Encoder_TINY", "latent_dim": TRAINER_LATENT},
        "decoder_config": {"model": "ShiftUNet", "latent_dim": TRAINER_LATENT},
        "dataloader_config": {"train": {"num_workers": 1, "batch_size": 8},
                              "eval": {"num_generations": 2}},
        "optimizer_config": dict(TRAINER_OPT),
        "runner_config": {**TRAINER_RUNNER, **runner},
    }
    if ddpm_checkpoint is not None:
        cfg["trained_ddpm_checkpoint"] = ddpm_checkpoint
    return cfg


def patch_tiny_encoders(monkeypatch, jax_too=False):
    """Both packages' trainers build the two-stage encoder of 8 and 16
    channels at 16px gray (no shipped encoder is that small): the
    representation trainer's, and the frozen one of the port's latent and
    manipulation trainers (``jax_too`` patches the JAX representation
    trainer; ``test_stage34_sharded.patch_tiny_encoders`` the JAX later
    stages)."""
    import pdae_torch.training.representation as port_rep
    import pdae_torch.training.stage as port_stage
    from pdae_torch.models import SemanticEncoder

    def port_encoder(config, image_size=None, dtype=torch.float32):
        return SemanticEncoder(config["latent_dim"], channels=(8, 16), attn_after_stage=2,
                               image_size=image_size, input_channel=1, dtype=dtype)

    monkeypatch.setattr(port_rep, "build_encoder", port_encoder)
    monkeypatch.setattr(port_stage, "build_encoder", port_encoder)
    if jax_too:
        import pdae_tpu.training.representation as jax_rep
        from pdae_tpu.models.encoder import SemanticEncoder as JaxSemanticEncoder

        def jax_encoder(config, image_size=None, dtype=jnp.float32):
            return JaxSemanticEncoder(config["latent_dim"], channels=(8, 16),
                                      attn_after_stage=2, dtype=dtype)

        monkeypatch.setattr(jax_rep, "build_encoder", jax_encoder)


def assert_trees_bitwise(got, want, path=""):
    """Two nested dicts of arrays with the same keys, dtypes, shapes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, sorted(got),
                                                                       sorted(want))
        for k in want:
            assert_trees_bitwise(got[k], want[k], f"{path}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=path)
