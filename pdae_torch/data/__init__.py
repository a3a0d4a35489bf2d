from .datasets import (BEDROOM, CELEBA64, CELEBAHQ, FFHQ, HORSE, MNIST, REGISTRY,
                       SYNTHETIC, build_dataset)
from .labels import CELEBAHQ_ID_TO_LABEL, CELEBAHQ_LABEL_TO_ID
from .lmdb_store import Reader, open_lmdb
from .pipeline import Loader, prefetch_to_device

__all__ = ["CELEBAHQ_ID_TO_LABEL", "CELEBAHQ_LABEL_TO_ID", "BEDROOM", "CELEBA64",
           "CELEBAHQ", "FFHQ", "HORSE", "MNIST", "REGISTRY", "SYNTHETIC", "build_dataset",
           "Reader", "open_lmdb", "Loader", "prefetch_to_device"]
