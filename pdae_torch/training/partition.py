"""Which parameters train: the port of ``pdae_tpu/training/partition.py``.

The PDAE decoder trains only ``label_emb`` and the shift branch while the
pre-trained DPM trunk stays frozen. The JAX package splits its param tree and
differentiates the trainable half; here the modules keep the tensors
(``ShiftUNet`` builds its trunk with ``requires_grad_(False)``) and these
functions split the *named parameters* the same way, for the optimizer, the
EMA copy and the tests.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..models.shift_unet import SHIFT_TRAINABLE_PREFIXES


def split_params(params: Dict, prefixes: Tuple[str, ...]) -> Tuple[Dict, Dict]:
    """Split ``{dotted name: tensor}`` into (top-level name in ``prefixes``,
    rest)."""
    inside = {k: v for k, v in params.items() if k.split(".")[0] in prefixes}
    outside = {k: v for k, v in params.items() if k.split(".")[0] not in prefixes}
    return inside, outside


def split_shift_unet(params: Dict) -> Tuple[Dict, Dict]:
    """(trainable shift branch, frozen DPM trunk)."""
    return split_params(params, SHIFT_TRAINABLE_PREFIXES)


def trainable_params(encoder, decoder) -> Dict[str, Dict]:
    """``{"encoder": {...}, "shift": {...}}``: the parameters the
    representation-learning step updates, by name, as the JAX train state
    keys them."""
    shift, _ = split_shift_unet(dict(decoder.named_parameters()))
    return {"encoder": dict(encoder.named_parameters()), "shift": shift}
