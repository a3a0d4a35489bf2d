"""Device milliseconds per ShiftUNet evaluation in convolution kernels
(the encoder pass's convolutions included)."""

from h100_bench.trace import device_seconds


def read(record):
    evaluations = record["units"] * record["counts"]["evaluations"]
    return 1e3 * device_seconds(record, "conv") / evaluations
