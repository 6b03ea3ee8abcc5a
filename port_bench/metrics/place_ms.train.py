"""Host input (train/supervised.py::make_train_step's ``place``): host ms a
step in the ``uml.step.place`` spans, the pageable copies of both
modalities' batches to the device, the median of the device-only traced
segment's steps (port_bench/spans.py).  Moves train_samples_per_s."""

from port_bench.spans import per_unit_ms

UNIT = "ms"


def read(run):
    return per_unit_ms(run, "train", "uml.step.place")
