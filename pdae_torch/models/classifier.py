"""The linear attribute classifier over normalized latents
(``pdae_tpu/models/classifier.py``; the reference's ``nn.Linear(512, 40)``).

Its ``weight`` and ``bias`` are the keys of ``export_classifier_state_dict``;
``weight`` is the ``[num_classes, latent_dim]`` matrix whose rows are the
manipulation's edit directions (the JAX ``LinearClassifier.weight(params)``).
``dtype`` is its compute dtype (``models/blocks.py``); the manipulation
trainer builds it fp32, as ``pdae_tpu``'s does.
"""

from __future__ import annotations

import torch

from .blocks import Linear


class LinearClassifier(Linear):

    def __init__(self, num_classes: int = 40, latent_dim: int = 512,
                 dtype=torch.float32):
        super().__init__(latent_dim, num_classes, compute_dtype=dtype)
