"""Device (H100): 100 x (1 - busy / traced window) in the text cell.
Moves extract_text_rows_per_s."""

from port_bench.metrics._common import idle

UNIT = "%"


def read(run):
    return idle(run, "text")
