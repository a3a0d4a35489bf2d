"""The process layer (``pdae_tpu.parallel``'s ``dist`` part): one run split
over ``torchrun`` processes, its host objects gathered over ``gloo``."""

from .dist import (dispatch_num_samples_for_process, gather_objects, init_distributed,
                   is_primary, process_count, process_index, process_shard_indices,
                   sync_global_devices)

__all__ = ["dispatch_num_samples_for_process", "gather_objects", "init_distributed",
           "is_primary", "process_count", "process_index", "process_shard_indices",
           "sync_global_devices"]
