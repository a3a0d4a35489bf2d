"""The process layer (``pdae_tpu.parallel``'s ``dist`` part): one run split
over ``torchrun`` processes, its host objects gathered over ``gloo``, a
data-parallel train step's gradients averaged over the tensor group."""

from .dist import (all_reduce_mean_, default_backend, dispatch_num_samples_for_process,
                   gather_objects, init_distributed, is_primary, mean_all_reducer,
                   process_count, process_index, process_shard_indices, sync_global_devices,
                   tensor_backend)

__all__ = ["all_reduce_mean_", "default_backend", "dispatch_num_samples_for_process",
           "gather_objects", "init_distributed", "is_primary", "mean_all_reducer",
           "process_count", "process_index", "process_shard_indices",
           "sync_global_devices", "tensor_backend"]
