"""CPU tests of the benchmark: ``python -m pytest h100_bench/tests -q``."""
