"""Model forward, device side (models/llama.py::LlamaEncoder under
TextModel.encode_ids): device ms a call of the kernels in the traced
window, memcpys left out.  Moves extract_text_rows_per_s."""

from port_bench.metrics._common import traced

UNIT = "ms"


def read(run):
    t = traced(run, "text")
    return None if t is None else t["kernel_s"] / t["n_spans"] * 1e3
