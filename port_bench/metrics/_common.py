"""Shared arithmetic of the per-layer readers."""

from __future__ import annotations

# the forward / backward / optimizer split is reported only where the
# trace attributes all but this share of the busy time to a launch
MAX_UNATTRIBUTED = 0.01


def traced(run: dict, kind: str):
    """The traced window's summary of a run of ``kind``, or None."""
    t = run.get("trace")
    if run.get("kind") != kind or not t or t["busy_s"] <= 0 or t["n_spans"] <= 0:
        return None
    return t


def split_ms(run: dict, kind: str, cls: str):
    """Device ms per span of one class of the split, where it holds."""
    t = traced(run, kind)
    if t is None or t["split_s"]["unattributed"] > MAX_UNATTRIBUTED * t["split_busy_s"]:
        return None
    return t["split_s"][cls] / t["n_spans"] * 1e3


def roofline(run: dict, kind: str):
    """The least time of the traced spans' work over the device's busy
    time in the traced window, in %."""
    t = traced(run, kind)
    if t is None:
        return None
    return 100.0 * run["least_s"] * t["n_spans"] / t["busy_s"]


def mfu(run: dict, kind: str):
    """Model FLOPs of the window's completed spans over the window's
    seconds at the peak of the run's compute type (``peak_flops``), in %."""
    if run.get("kind") != kind or not run.get("steps"):
        return None
    return 100.0 * run["model_flops"] * run["steps"] / (run["window_s"] * run["peak_flops"])


def idle(run: dict, kind: str):
    t = traced(run, kind)
    if t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
