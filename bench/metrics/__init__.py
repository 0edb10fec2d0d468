"""One reader per per-layer metric, named as ``BENCHMARK.json`` names the
metric (see :mod:`bench.readers`)."""
