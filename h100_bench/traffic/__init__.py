"""Traffic kinds: one driver each, ``<kind>.py``, with a ``Cell`` class."""
