"""The device's idle share of the traced window of training, in %: one
minus the union of its activities' intervals over the window."""

from h100_bench.trace import idle_share as read  # noqa: F401
