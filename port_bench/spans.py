"""The program's own spans in a traced run: those of the segment of the
device alone, the host ms a step (or batch) in each, and the device's
idle time named by the innermost span that covers it.

The program (``uml_tpu_torch/utils/profiling.py``) records its spans
while a ``torch.profiler`` recording runs, so both traced segments of
``harness.trace_spans`` record them, and the window none: ``uml.step``
and its ``place`` / ``forward`` / ``backward`` / ``optimizer`` /
``metrics`` children around each train step, ``uml.extract.stage`` (with
``slot_wait`` inside), ``encode`` and ``fetch`` around each batch.
``trace_spans`` keeps the first segment's, the device alone (there the
host pays CUPTI's cost only, not the host ops' profiling, which doubles
a step's host time in the second), with that segment's chrome trace; the
readers and the ``[spans]`` notes, which ``port_bench.run`` prints in
every ``--trace 1`` run, take them from the run's ``trace``.  A program
that records no spans, or a run whose path has none (the text encoder's),
gives every reader None.
"""

from __future__ import annotations

import bisect
import json
import statistics
from collections import defaultdict

# the span that opens each step or batch, by a run's kind
ROOT = {"train": "uml.step", "extract": "uml.extract.stage"}
OUTSIDE = "outside the program"


def take() -> list:
    """The spans the program recorded since the last take ([] from a
    program without spans)."""
    try:
        from uml_tpu_torch.utils.profiling import take_spans
    except ImportError:
        return []
    return take_spans()


def device_segment(run: dict, kind: str):
    """The spans of the first traced segment (the device alone), or None:
    the segment runs ``n`` steps or batches, so it holds ``n`` root
    spans."""
    t = run.get("trace")
    if run.get("kind") != kind or kind not in ROOT or not t or t["n_spans"] <= 0:
        return None
    got = t.get("spans") or []
    if sum(s.name == ROOT[kind] for s in got) != t["n_spans"]:
        return None
    return got


def per_unit_ms(run: dict, kind: str, name: str):
    """Host ms in the spans called ``name`` a step or batch (each span
    counted in the step or batch whose root opened last before it): the
    median over those of the device-only segment that hold one, or None."""
    segment = device_segment(run, kind)
    if not segment:
        return None
    starts = sorted(s.start_ns for s in segment if s.name == ROOT[kind])
    sums = defaultdict(float)
    for s in segment:
        if s.name == name:
            sums[bisect.bisect_right(starts, s.start_ns) - 1] += (s.end_ns - s.start_ns) / 1e6
    return statistics.median(sums.values()) if sums else None


def self_ms(segment, n: int) -> dict:
    """{span name: host ms a step in the span less the spans inside it}."""
    by_id = {s.id: s for s in segment}
    out = defaultdict(float)
    for s in segment:
        ms = (s.end_ns - s.start_ns) / 1e6
        out[s.name] += ms / n
        if s.parent in by_id:
            out[by_id[s.parent].name] -= ms / n
    return dict(out)


def idle_by_span(events, base_ns: int, segment, n: int, root: str) -> dict:
    """{span name: device idle ms a step} in one chrome trace of the
    device alone (``baseTimeNanoseconds`` ``base_ns``): each idle gap
    within the trace's extent (as port_bench/trace.py's ``summarize``
    takes it without a span name) is named by the innermost span on the
    thread of the ``root`` spans that covers its middle, else
    ``OUTSIDE``.  The values add up to the trace's idle time over ``n``."""
    from port_bench import trace
    from uml_tpu_torch.utils.profiling import trace_us

    timed = [e for e in events if e.get("ph") == "X" and "ts" in e]
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in timed)
    busy = trace.merged(trace.clip([(s, t) for s, t, *_ in trace.device_events(events)],
                                   lo, hi))
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    tids = {s.tid for s in segment if s.name == root}
    ranges = [(trace_us(s.start_ns, base_ns), trace_us(s.end_ns, base_ns), s.name)
              for s in segment if s.tid in tids]
    out = defaultdict(float)
    for (s, t), name in zip(gaps, trace.innermost(ranges, [(s + t) / 2 for s, t in gaps],
                                                  OUTSIDE)):
        out[name] += (t - s) / 1e3 / n
    return dict(out)


def notes(run: dict) -> list:
    """The ``[spans]`` notes of a traced run, from the device-only
    segment's spans and chrome trace."""
    kind = run.get("kind")
    segment = device_segment(run, kind)
    if not segment:
        return ["[spans] the traced segments hold no program spans"]
    device_trace = run["trace"]["device_trace"]
    n = run["trace"]["n_spans"]
    own = self_ms(segment, n)
    idle = idle_by_span(device_trace["traceEvents"], device_trace["baseTimeNanoseconds"],
                        segment, n, ROOT[kind])
    t = run["trace"]
    return [
        "[spans] host ms a step by span (self): "
        + json.dumps({k: round(v, 4) for k, v in sorted(own.items(), key=lambda kv: -kv[1])}),
        "[spans] device idle ms a step by span: "
        + json.dumps({k: round(v, 4) for k, v in sorted(idle.items(), key=lambda kv: -kv[1])})
        + f"; sum {sum(idle.values()):.4f}, the segment's idle "
        f"{(t['window_s'] - t['busy_s']) * 1e3 / n:.4f}",
    ]
