"""Train loop, the step's diagnostics (train/supervised.py::make_train_step's
``torch.no_grad()`` block): host ms a step in the ``uml.step.metrics`` span,
the median of the device-only traced segment's steps (port_bench/spans.py).
Moves train_samples_per_s."""

from port_bench.spans import per_unit_ms

UNIT = "ms"


def read(run):
    return per_unit_ms(run, "train", "uml.step.metrics")
