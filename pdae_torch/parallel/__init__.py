"""The process layer (``pdae_tpu.parallel``'s ``dist`` part and its FSDP
rule): one run split over ``torchrun`` processes, its host objects gathered
over ``gloo``, a data-parallel train step's gradients averaged over the
tensor group, an FSDP step's reduce-scatter and all-gather, tensor
parallelism's grid, groups and split layers (``parallel/tp.py``), and
spatial parallelism's (``parallel/sp.py``)."""

from .dist import (all_gather_into_, all_reduce_mean_, default_backend,
                   dispatch_num_samples_for_process, gather_full, gather_objects,
                   init_distributed, is_primary, mean_all_reducer, process_count,
                   process_index, process_shard_indices, reduce_scatter_mean_,
                   sync_global_devices, tensor_backend, tensor_group)
from .mesh import (FSDP_MIN_SIZE, fsdp_dim, fsdp_tp_dims, hier_coords, hier_shape, sp_coords,
                   tp_coords, tp_dim)

__all__ = ["all_gather_into_", "all_reduce_mean_", "default_backend",
           "dispatch_num_samples_for_process", "gather_full", "gather_objects",
           "init_distributed", "is_primary", "mean_all_reducer", "process_count",
           "process_index", "process_shard_indices", "reduce_scatter_mean_",
           "sync_global_devices", "tensor_backend", "tensor_group", "FSDP_MIN_SIZE", "fsdp_dim",
           "fsdp_tp_dims", "hier_coords", "hier_shape", "sp_coords", "tp_coords", "tp_dim"]
