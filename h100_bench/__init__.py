"""The H100 benchmark of the ``pdae_torch`` port: ``python3 -m h100_bench.run``."""
