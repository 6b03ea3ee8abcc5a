"""Model forward, multi-head latent attention (models/deepseek_v2.py::MLA
under TextModel.encode_ids): device ms a call of the work launched inside
the program's ``uml.text.mla`` spans (the input RMSNorm, the four
projections, the rotary, the attention core), in the traced segment of
the device alone.  Moves extract_text_rows_per_s."""

from port_bench.metrics._text_spans import device_ms

UNIT = "ms"


def read(run):
    return device_ms(run, "uml.text.mla")
