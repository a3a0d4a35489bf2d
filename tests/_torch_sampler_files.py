"""Checkpoint files that ``pdae_tpu`` writes, for the tests of the port's
sampler suite and its file-built service (``tests/test_torch_samplers.py``,
``tests/test_torch_sample_serve.py``).

Perturbed flax params (no zero-init output hides a fault; a stack trained for
a step would have them) of the ``SMALL_DPM`` geometry at 16px RGB over 20
timesteps, with the two-stage encoder of 8 and 16 channels (both packages'
contexts build it in place of the shipped encoders), written with
``pdae_tpu.utils.save_checkpoint`` under the stage keys beside YAML run
configs, with a stats file and the latent-DPM and classifier checkpoints.
"""

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

import pdae_tpu.sampling.context as jax_context
import pdae_torch.sampling.context as port_context
from _torch_parity import TINY_DPM, init_flax
from pdae_tpu import ops as jax_ops
from pdae_tpu.models import LinearClassifier as JaxLinearClassifier
from pdae_tpu.models import MLPSkipNet as JaxMLPSkipNet
from pdae_tpu.models import ShiftUNet as JaxShiftUNet
from pdae_tpu.models import UNet as JaxUNet
from pdae_tpu.models.encoder import SemanticEncoder as JaxSemanticEncoder
from pdae_tpu.utils import save_checkpoint as jax_save_checkpoint
from pdae_tpu.utils import save_yaml as jax_save_yaml
from pdae_torch import serving
from pdae_torch.models import SemanticEncoder

SIZE, LATENT, STEPS = 16, 16, 20
SMALL_DPM = dict(TINY_DPM, base_channel=16, attention_resolutions=(4,))
DPM_CONFIG = {"model": "UNet", **{k: list(v) if isinstance(v, tuple) else v
                                  for k, v in SMALL_DPM.items()}}
DIFFUSION = {"timesteps": STEPS, "betas_type": "linear"}
LATENT_DPM = {"model": "MLPSkipNet", "input_channel": LATENT, "model_channel": 32,
              "num_layers": 3, "time_emb_channel": 16}
DATASET = {"name": "SYNTHETIC", "image_size": SIZE, "image_channel": 3, "length": 6}


def _port_encoder(config, image_size=None):
    return SemanticEncoder(config["latent_dim"], channels=(8, 16), attn_after_stage=2,
                           image_size=image_size)


def _jax_encoder(config, image_size=None, dtype=jnp.float32):
    return JaxSemanticEncoder(config["latent_dim"], channels=(8, 16), attn_after_stage=2,
                              dtype=dtype)


@contextlib.contextmanager
def sampler_files(root, size=SIZE):
    """The checkpoint files and run configs under ``root``, the JAX models and
    params that made them, and a sampler config naming them all; while the
    context is open, the contexts build the tiny encoder. ``size`` is the
    images' side (the encoder's last layer depends on it)."""
    dataset = dict(DATASET, image_size=size)
    x = jnp.zeros((1, size, size, 3))
    t = jnp.zeros((1,), jnp.int32)
    z = jnp.zeros((1, LATENT))
    m = SimpleNamespace(encoder=_jax_encoder({"latent_dim": LATENT}),
                        decoder=JaxShiftUNet(latent_dim=LATENT, **SMALL_DPM),
                        unet=JaxUNet(**SMALL_DPM),
                        latent=JaxMLPSkipNet(**{k: v for k, v in LATENT_DPM.items()
                                                if k != "model"}),
                        classifier=JaxLinearClassifier(num_classes=40))
    p = SimpleNamespace(encoder=init_flax(m.encoder, x, seed=0),
                        decoder=init_flax(m.decoder, x, t, z, seed=1),
                        unet=init_flax(m.unet, x, t, seed=2),
                        latent=init_flax(m.latent, z, t, seed=3),
                        classifier=init_flax(m.classifier, z, seed=4))
    rs = np.random.RandomState(5)
    stats = {"mean": (0.1 * rs.randn(LATENT)).astype(np.float32),
             "std": rs.uniform(0.5, 1.5, LATENT).astype(np.float32)}
    path = {k: str(root / k) for k in ("pdae.yml", "pdae.ckpt", "dpm.yml", "dpm.ckpt",
                                       "latent.yml", "latent.ckpt", "classifier.ckpt",
                                       "stats.ckpt")}
    jax_save_yaml({"train_dataset_config": dataset, "eval_dataset_config": {},
                   "diffusion_config": DIFFUSION,
                   "trained_ddpm_config": {"denoise_fn_config": DPM_CONFIG},
                   "encoder_config": {"model": "TinyEncoder", "latent_dim": LATENT},
                   "decoder_config": {"model": "ShiftUNet", "latent_dim": LATENT}},
                  path["pdae.yml"])
    jax_save_checkpoint(path["pdae.ckpt"], {"step": np.asarray(1, np.int32),
                                            "ema_encoder": p.encoder,
                                            "ema_decoder": p.decoder})
    jax_save_yaml({"denoise_fn_config": DPM_CONFIG, "diffusion_config": DIFFUSION},
                  path["dpm.yml"])
    jax_save_checkpoint(path["dpm.ckpt"], {"ema_denoise_fn": p.unet})
    jax_save_yaml({"latent_denoise_fn_config": LATENT_DPM}, path["latent.yml"])
    jax_save_checkpoint(path["latent.ckpt"], {"ema_latent_denoise_fn": p.latent})
    jax_save_checkpoint(path["classifier.ckpt"], {"ema_classifier": p.classifier})
    jax_save_checkpoint(path["stats.ckpt"], stats)
    config = {"config_path": path["pdae.yml"], "checkpoint_path": path["pdae.ckpt"],
              "latent_config_path": path["latent.yml"],
              "latent_checkpoint_path": path["latent.ckpt"],
              "inferred_latents_path": path["stats.ckpt"],
              "classifier_checkpoint_path": path["classifier.ckpt"],
              "dataset_config": dataset, "max_batch": 4}
    with pytest.MonkeyPatch.context() as mp:
        # both packages' contexts (and the port's in-memory service) build
        # the tiny encoder in place of a shipped one
        mp.setattr(port_context, "build_encoder", _port_encoder)
        mp.setattr(serving, "build_encoder", _port_encoder)
        mp.setattr(jax_context, "build_encoder", _jax_encoder)
        try:
            yield SimpleNamespace(root=root, path=path, config=config, models=m,
                                  params=p, stats=stats)
        finally:
            # a JAX service built on these files pins pdae_tpu's
            # fused-upsample mode for the whole process: put back the default
            jax_ops.set_fused_upsample(None)


def jax_fns(files):
    """The JAX encoder, decoder, UNet and latent DPM as callables (NHWC)."""
    m, p = files.models, files.params
    return SimpleNamespace(
        enc=lambda xx: m.encoder.apply({"params": p.encoder}, xx),
        dec=lambda xx, tt, zz: m.decoder.apply({"params": p.decoder}, xx, tt, zz),
        unet=lambda xx, tt, cc=None: m.unet.apply({"params": p.unet}, xx, tt, cc),
        latent=lambda zz, tt: m.latent.apply({"params": p.latent}, zz, tt))

def read_png(path) -> np.ndarray:
    return np.asarray(Image.open(path)).astype(int)


def within_one_level(got, want):
    assert got.shape == want.shape
    assert np.abs(np.asarray(got, int) - np.asarray(want, int)).max() <= 1
