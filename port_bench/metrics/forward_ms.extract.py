"""Model forward, device side (models/clip.py, rows 1-3): device ms a
batch of the kernels in the traced window, memcpys left out.  Moves
extract_img_per_s."""

from port_bench.metrics._common import traced

UNIT = "ms"


def read(run):
    t = traced(run, "extract")
    return None if t is None else t["kernel_s"] / t["n_spans"] * 1e3
