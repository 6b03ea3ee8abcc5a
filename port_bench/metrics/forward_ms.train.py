"""Model forward (models/clip.py, models/dino.py, models/uml_head.py) with
``place``, the loss and the step's metrics: device ms a step of every
other launch.  Moves train_samples_per_s."""

from port_bench.metrics._common import split_ms

UNIT = "ms"


def read(run):
    return split_ms(run, "train", "forward")
