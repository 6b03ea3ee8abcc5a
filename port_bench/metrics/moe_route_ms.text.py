"""Model dispatch, the MoE's routing (models/deepseek_v2.py::MoE.route):
host ms a call in the program's ``uml.text.moe.route`` spans, which
enqueue the gate, top-k, sort and count (and would wait there, were the
experts' row counts read to the host), in the traced segment of the
device alone.  Moves extract_text_rows_per_s."""

from port_bench.metrics._text_spans import host_ms

UNIT = "ms"


def read(run):
    return host_ms(run, "uml.text.moe.route")
