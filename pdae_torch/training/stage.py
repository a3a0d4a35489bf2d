"""What the regular, latent and manipulation trainers share: one trained
module with Adam/AdamW and its EMA, checkpointed in the flax and optax
layouts under the stage's keys, and (for the two later stages) the frozen
PDAE they read.

The checkpoint of a stage holds ``<params_key>``, ``<ema_key>``,
``optimizer`` and ``step``, each tree as ``pdae_tpu``'s trainer of that
stage writes it, so either package resumes the other's files. Under FSDP the
plan (``training/fsdp.py``) holds the large tensors of the trained module
and of the frozen PDAE as each rank's blocks. Under tensor parallelism the
trained module and the frozen PDAE hold the rank's tp blocks and run split
(``parallel/tp.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..models import build_decoder, build_encoder
from ..utils import optimizer_moments, optimizer_tree, restore_into
from ..utils import encoder_state_dict, encoder_tree, unet_state_dict, unet_tree
from .artifacts import load_latent_stats, load_pdae, resolve_model_config
from .base import BaseTrainer, has_dropout


class StageTrainer(BaseTrainer):
    """A trainer of one module. A subclass's ``_build`` makes the module and
    calls ``_train_module``; ``params_key``/``ema_key`` name its
    checkpoint trees, ``to_tree``/``to_state_dict`` map its state dict to
    and from the flax layout."""

    params_key = ema_key = None
    to_tree = to_state_dict = None

    def _train_module(self, model: nn.Module) -> None:
        self.model = model.to(self.device)
        self._dropout = has_dropout(model)
        self._shard_module(model, type(self).to_tree)
        self._shard_state({"model": dict(model.named_parameters())},
                          {"model": type(self).to_tree}, [model])
        self.ema_decay = float(self.runner_config.get("ema_decay", 0.9999))
        self.eval_seconds = []

    @property
    def step(self) -> int:
        return int(self.state.step)

    def ema_weights(self, whole: bool = False) -> dict:
        """The trained module's EMA (gathered under FSDP: every rank calls
        it); under tensor parallelism the rank's tp blocks, or with
        ``whole`` gathered over the model group too."""
        ema = self._eval_ema()["model"]
        if whole and self.tp_layout is not None:
            params = self.state.params["model"]
            names = list(ema)
            copies = self.tp_layout.gather([ema[k] for k in names],
                                           [params[k] for k in names])
            ema = dict(zip(names, copies))
        return ema

    # -- the frozen PDAE of the latent and manipulation stages --------------- #

    def _load_frozen_pdae(self):
        """The trained PDAE's EMA encoder and decoder in the compute dtype,
        frozen in eval mode on the device, and the inferred latent stats;
        returns the PDAE's run config."""
        cfg = self.config
        pdae_cfg, enc_raw, dec_raw = load_pdae(
            cfg["trained_representation_learning_config"],
            cfg["trained_representation_learning_checkpoint"])
        size = int(cfg["train_dataset_config"]["image_size"])
        ddpm_cfg = resolve_model_config(cfg.get("trained_ddpm_config",
                                                pdae_cfg.get("trained_ddpm_config")))
        dtype = self._compute_dtype()
        self.encoder = build_encoder(pdae_cfg["encoder_config"], image_size=size,
                                     dtype=dtype)
        self.decoder = build_decoder(pdae_cfg["decoder_config"], ddpm_cfg, dtype=dtype)
        self.encoder.load_state_dict(encoder_state_dict(enc_raw), strict=True)
        self.decoder.load_state_dict(unet_state_dict(dec_raw), strict=True)
        for m in (self.encoder, self.decoder):
            m.requires_grad_(False)
            m.to(self.device).eval()
        self._shard_module(self.encoder, encoder_tree)
        self._shard_module(self.decoder, unet_tree)
        self._freeze("frozen_encoder", self.encoder, encoder_tree)
        self._freeze("frozen_decoder", self.decoder, unet_tree)
        mean, std = load_latent_stats(cfg["inferred_latents"])
        self.latents_mean, self.latents_std = mean.to(self.device), std.to(self.device)
        self.latent_dim = int(pdae_cfg["encoder_config"]["latent_dim"])
        return pdae_cfg

    def _latent_source(self) -> str:
        """``runner_config.latent_train_source``: ``encode`` (the frozen
        encoder runs in every step) or ``precomputed`` (the resident corpus
        holds z, encoded once)."""
        source = str(self.runner_config.get("latent_train_source", "encode"))
        if source not in ("encode", "precomputed"):
            raise ValueError(f"runner_config.latent_train_source must be 'encode' or "
                             f"'precomputed', got {source!r}")
        if source == "precomputed":
            if not self.device_resident:
                raise ValueError("latent_train_source 'precomputed' requires "
                                 "train_dataset_config.device_resident: true")
            if getattr(self.train_dataset, "augmentation", False):
                raise ValueError("latent_train_source 'precomputed' requires "
                                 "augmentation: false (a flipped image has a different "
                                 "z; keep 'encode' for augmented corpora)")
        return source

    def _precomputed_device_data(self, keys=()):
        """The resident corpus of ``precomputed``: x_0 replaced by its raw z
        (``encode_corpus``), and ``keys`` beside it."""
        if self._resident_cache is None:
            from .resident import encode_corpus, materialize_step_arrays
            host = materialize_step_arrays(self.train_dataset, ("x_0",) + tuple(keys))
            with self._whole_frozen():
                z = encode_corpus(self.encoder, host["x_0"], self.device)
            print(f"precomputed-z corpus: {z.shape[0]} items, "
                  f"{z.numel() * z.element_size() / 2 ** 20:.1f} MB on {self.device}",
                  flush=True)
            self._resident_cache = {"x_0": z, **{
                k: torch.from_numpy(host[k]).to(self.device) for k in keys}}
        return self._resident_cache

    # -- checkpoints ------------------------------------------------------ #

    def checkpoint_tree(self, snap):
        to_tree = type(self).to_tree
        return {self.params_key: to_tree(snap["params"]["model"]),
                self.ema_key: to_tree(snap["ema"]["model"]),
                "optimizer": optimizer_tree(self.optimizer_config, snap["count"],
                                            snap["mu"]["model"], snap["nu"]["model"],
                                            to_tree=to_tree)}

    def _tensors(self, tree) -> dict:
        """A flax tree as the trained module's named parameters (a state
        dict's extra names, as MLPSkipNet's second name of each
        ``linear_emb``, are dropped)."""
        sd = type(self).to_state_dict(tree)
        return {"model": {k: sd[k] for k in self.state.params["model"] if k in sd}}

    def load_state_dict(self, raw):
        keys = (self.params_key, self.ema_key, "optimizer")
        template = self._template()
        restore_into({k: template[k] for k in keys}, raw)
        self.state.load_converted({
            "step": int(raw["step"]), "params": self._tensors(raw[self.params_key]),
            "ema_params": self._tensors(raw[self.ema_key]),
            **optimizer_moments(self.optimizer_config, raw["optimizer"],
                                to_tensors=self._tensors)})
