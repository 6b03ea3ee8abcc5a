"""Model forward, the MoE layers (models/deepseek_v2.py::MoE under
TextModel.encode_ids): device ms a call of the work launched inside the
program's ``uml.text.moe`` spans (the gate, the routing, the expert
products, the combine, the shared experts), in the traced segment of the
device alone.  Moves extract_text_rows_per_s."""

from port_bench.metrics._text_spans import device_ms

UNIT = "ms"


def read(run):
    return device_ms(run, "uml.text.moe")
