"""Kernels (csrc/* through ops/_build.py, and the library calls beside
them): the least time of a step's work (port_bench/flops.py) over the
device's busy time in the traced window.  Moves train_samples_per_s."""

from port_bench.metrics._common import roofline

UNIT = "%"


def read(run):
    return roofline(run, "train")
