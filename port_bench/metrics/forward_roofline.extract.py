"""Kernels: the least time of a batch's serving forward (CLS-only last
layer) over the device's busy time in the traced window.  Moves
extract_img_per_s."""

from port_bench.metrics._common import roofline

UNIT = "%"


def read(run):
    return roofline(run, "extract")
