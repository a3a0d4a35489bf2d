"""The attention forward kernel's share of its roofline in autoencoding, in %:
the least time of the requests' attention forward work (q, k, v read and the
output written over HBM bandwidth, or the two products over the peak of the
dtype the kernel runs them in, the larger) over the kernel's device time."""

from h100_bench.trace import roofline


def read(record):
    return roofline(record, "attention", "attention_s")
