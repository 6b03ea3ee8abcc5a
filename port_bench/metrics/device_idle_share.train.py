"""Device (H100): 100 x (1 - the union of device intervals over the traced
window) in a train cell.  Moves train_samples_per_s."""

from port_bench.metrics._common import idle

UNIT = "%"


def read(run):
    return idle(run, "train")
