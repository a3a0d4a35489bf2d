"""The device memory PyTorch holds at its peak in the window, in GB:
``max_memory_reserved`` after a reset at the window's start, set-up's
cached blocks released before it. Reserved and not allocated, because a
CUDA graph's replays take their activations from the graph's own pool,
which the caching allocator reserved at the capture and does not count as
allocated again."""


def read(record):
    return record["window_reserved_bytes"] / 1e9
