"""Host input (models/encoders.py: ClipEncoder.stage_images and its
pinned ring): host ms of the call a batch, the median of the window's
batches, timed by the traffic loop.  Moves extract_img_per_s."""

UNIT = "ms"


def read(run):
    return run.get("stage_ms") if run.get("kind") == "extract" else None
