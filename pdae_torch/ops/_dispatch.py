"""The kernel-or-plain decision shared by every op wrapper."""

from __future__ import annotations

import torch

_USE_KERNELS = None   # tri-state, see pdae_torch.ops


def set_use_kernels(value) -> None:
    if value not in (None, True, False):
        raise ValueError(f"set_use_kernels takes None, True or False, got {value!r}")
    global _USE_KERNELS
    _USE_KERNELS = value


def kernel_for(x: torch.Tensor) -> bool:
    """Whether an op on ``x`` runs its CUDA kernel (True) or its plain version."""
    if _USE_KERNELS is False:
        return False
    if x.is_cuda:
        return True
    if _USE_KERNELS:
        raise RuntimeError(f"kernels forced on (set_use_kernels(True)) but the "
                           f"tensor lies on {x.device}; the kernels run on CUDA only")
    return False


def stream_handle(x: torch.Tensor) -> int:
    """PyTorch's current stream on ``x``'s device, as the raw cudaStream_t."""
    return torch.cuda.current_stream(x.device).cuda_stream


def dtype_code(dtype: torch.dtype) -> int:
    """The kernels' dtype switch: 0 = float32, 1 = bfloat16."""
    if dtype == torch.float32:
        return 0
    if dtype == torch.bfloat16:
        return 1
    raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {dtype}")


def check_cuda_error(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
