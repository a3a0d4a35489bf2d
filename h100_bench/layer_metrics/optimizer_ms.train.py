"""Device milliseconds per train step in the optimizer's multi-tensor
(Adam) kernels."""

from h100_bench.trace import device_seconds


def read(record):
    return 1e3 * device_seconds(record, "optimizer") / record["units"]
