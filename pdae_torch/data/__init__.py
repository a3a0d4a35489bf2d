from .datasets import (BEDROOM, CELEBA64, CELEBAHQ, FFHQ, HORSE, MNIST, REGISTRY,
                       SYNTHETIC, build_dataset)
from .labels import CELEBAHQ_ID_TO_LABEL, CELEBAHQ_LABEL_TO_ID
from .lmdb_store import NativeReader, Reader, open_lmdb, write_lmdb, write_lmdb_stream
from .pipeline import Loader, prefetch_to_device

__all__ = ["CELEBAHQ_ID_TO_LABEL", "CELEBAHQ_LABEL_TO_ID", "BEDROOM", "CELEBA64",
           "CELEBAHQ", "FFHQ", "HORSE", "MNIST", "REGISTRY", "SYNTHETIC", "build_dataset",
           "NativeReader", "Reader", "open_lmdb", "write_lmdb", "write_lmdb_stream",
           "Loader", "prefetch_to_device"]
