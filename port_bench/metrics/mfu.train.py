"""The whole step: model FLOPs of the window's steps over the window's
seconds at 989 TFLOP/s.  Moves train_samples_per_s."""

from port_bench.metrics._common import mfu

UNIT = "%"


def read(run):
    return mfu(run, "train")
