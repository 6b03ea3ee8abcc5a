"""Device (H100): 100 x (1 - busy / traced window) in the extraction
cell.  Moves extract_img_per_s."""

from port_bench.metrics._common import idle

UNIT = "%"


def read(run):
    return idle(run, "extract")
