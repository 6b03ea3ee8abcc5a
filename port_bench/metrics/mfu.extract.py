"""The whole forward: model FLOPs of the window's batches over the window's
seconds at 989 TFLOP/s.  Moves extract_img_per_s."""

from port_bench.metrics._common import mfu

UNIT = "%"


def read(run):
    return mfu(run, "extract")
