"""The whole call: the real tokens' product FLOPs of the window's calls
over the window's seconds at the TF32 tensor peak, 494.7 TFLOP/s.  Moves
extract_text_rows_per_s."""

from port_bench.metrics._common import mfu

UNIT = "%"


def read(run):
    return mfu(run, "text")
