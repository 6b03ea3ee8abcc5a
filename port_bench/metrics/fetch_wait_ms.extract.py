"""Host output (models/encoders.py::PendingOutput.result): host ms a batch in
the ``uml.extract.fetch`` span, the host blocked on the device until an
output reaches pinned memory, the median of the device-only traced segment's
batches that fetch one (port_bench/spans.py).  Moves extract_img_per_s."""

from port_bench.spans import per_unit_ms

UNIT = "ms"


def read(run):
    return per_unit_ms(run, "extract", "uml.extract.fetch")
