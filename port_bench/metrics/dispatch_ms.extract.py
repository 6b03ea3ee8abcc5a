"""Model forward, host side (ClipEncoder.encode_staged): host ms of the
call a batch, the median of the window's batches, timed by the traffic loop.
Moves extract_img_per_s."""

UNIT = "ms"


def read(run):
    return run.get("dispatch_ms") if run.get("kind") == "extract" else None
