"""The GroupNorm+AdaGN+SiLU forward kernels' share of their roofline in
training, in %: the least time of the steps' GN forward work (each call's
bytes over HBM bandwidth or operations over the peak, the larger) over the
device time of the kernels that do it."""

from h100_bench.trace import roofline


def read(record):
    return roofline(record, "gn_fwd", "gn_fwd_s")
