"""Device milliseconds per train step in convolution kernels (cuDNN's
forward, data- and weight-gradient kernels and its layout transforms)."""

from h100_bench.trace import device_seconds


def read(record):
    return 1e3 * device_seconds(record, "conv") / record["units"]
