"""Kernels: the least time of the traced calls' real-token work (float32
products at the TF32 tensor peak, weights read once) over the device's
busy time in the traced window.  Moves extract_text_rows_per_s."""

from port_bench.metrics._common import roofline

UNIT = "%"


def read(run):
    return roofline(run, "text")
