"""Train loop, host side (train/supervised.py::make_train_step's step): host
ms of the program's ``uml.step`` span, its enqueue of one step from entry to
return, the median of the device-only traced segment's steps
(port_bench/spans.py).  Moves train_samples_per_s."""

from port_bench.spans import per_unit_ms

UNIT = "ms"


def read(run):
    return per_unit_ms(run, "train", "uml.step")
