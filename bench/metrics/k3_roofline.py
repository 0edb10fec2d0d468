"""K3's share of its roofline over its launches in the profiled steps,
in % (bytes and operations from ``bench/kernels/k3.py``)."""

from bench import registry
from bench.readers import roofline


def read(run):
    return roofline(run, registry.module("kernels", "k3"))
