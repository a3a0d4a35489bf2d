"""The train step's model FLOPs (``h100_bench.counts``) over the traced
window, as a share of the peak of the configuration's compute dtype, in %."""

from h100_bench.trace import mfu as read  # noqa: F401
