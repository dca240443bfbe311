"""The benchmark harness of ``ab_line_classifier_torch`` (see
``benchmark/run.py``): cells resolved by name from ``BENCHMARK.json``,
traffic made from data files, the drivers of the timed windows, the trace
reduction and the comparison that decides ``correct``."""
