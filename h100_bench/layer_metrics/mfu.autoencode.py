"""The requests' model FLOPs (``h100_bench.counts``: an encoder pass and
the solver loops' ShiftUNet evaluations) over the traced window, as a share
of the peak of the configuration's compute dtype (fp32: 67 TFLOP/s), in %."""

from h100_bench.trace import mfu as read  # noqa: F401
