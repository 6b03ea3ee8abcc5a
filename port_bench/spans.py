"""The program's own spans in a traced run: those of the segment of the
device alone, the host ms a step (or batch) in each, and the device's
idle time named by the innermost span that covers it.

The program (``uml_tpu_torch/utils/profiling.py``) records its spans
while a ``torch.profiler`` recording runs, so both traced segments of
``harness.trace_spans`` record them, and the window none: ``uml.step``
and its ``place`` / ``forward`` / ``backward`` / ``optimizer`` /
``metrics`` children around each train step, ``uml.extract.stage`` (with
``slot_wait`` inside), ``encode`` and ``fetch`` around each batch.  The
readers take the spans of the first segment, the device alone: there the
host pays CUPTI's cost only, not the host ops' profiling, which doubles
a step's host time in the second.  A program that records no spans gives
every reader None.

    python3 -m port_bench.spans --workload clip_vit_b16.train_bs64 \\
        --seed 1234 --seconds 51

runs the cell as ``port_bench.run --trace 1`` does, keeps the device-only
segment's chrome trace as it is read, and prints the ``[spans]`` notes
after the result line: host ms a step by span (self), and that
segment's device idle ms a step by the span the host was in.
"""

from __future__ import annotations

import bisect
import json
import statistics
import sys
from collections import defaultdict

# the span that opens each step or batch, by a run's kind
ROOT = {"train": "uml.step", "extract": "uml.extract.stage"}
OUTSIDE = "outside the program"


def spans(run: dict) -> list:
    """The program's spans of the run's traced segments: taken from the
    program by the first reader and kept in ``run["spans"]`` for the
    others ([] from a program without spans)."""
    if "spans" not in run:
        try:
            from uml_tpu_torch.utils.profiling import take_spans
        except ImportError:
            run["spans"] = []
        else:
            run["spans"] = take_spans()
    return run["spans"]


def device_segment(run: dict, kind: str):
    """The spans of the first traced segment (the device alone), or None:
    the segments run ``n`` steps or batches each, so the run holds 2n
    root spans, and the first segment runs from the first root to the
    (n+1)-th."""
    t = run.get("trace")
    if run.get("kind") != kind or not t or t["n_spans"] <= 0:
        return None
    n = t["n_spans"]
    got = spans(run)
    roots = sorted(s.start_ns for s in got if s.name == ROOT[kind])
    if len(roots) != 2 * n:
        return None
    lo, hi = roots[0], roots[n]
    return [s for s in got if lo <= s.start_ns < hi]


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
    for s, t in gaps:
        mid = (s + t) / 2
        inner = [r for r in ranges if r[0] <= mid <= r[1]]
        name = min(inner, key=lambda r: r[1] - r[0])[2] if inner else OUTSIDE
        out[name] += (t - s) / 1e3 / n
    return dict(out)


def notes(run: dict, device_trace: dict) -> list:
    """The ``[spans]`` notes of a traced run, given the device-only
    segment's chrome trace (the whole file)."""
    kind = run.get("kind")
    segment = device_segment(run, kind) if kind in ROOT else None
    if not segment:
        return ["[spans] the traced segments hold no program spans"]
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


def main(argv=None) -> int:
    """A --trace 1 run of one cell (port_bench.run.main) that keeps the
    device-only segment's trace and the readers' run as they pass, then
    prints the [spans] notes on standard error."""
    from port_bench import harness, run, trace

    argv = list(sys.argv[1:] if argv is None else argv)
    kept = {}
    load, per_layer = trace.load, harness.per_layer

    def keep_trace(path):
        with open(path) as f:
            data = json.load(f)
        kept.setdefault("trace", data)          # the first segment's
        return data["traceEvents"]

    def keep_run(layer):
        kept["run"] = layer
        return per_layer(layer)

    trace.load, harness.per_layer = keep_trace, keep_run
    try:
        rc = run.main([*argv, "--trace", "1"])
    finally:
        trace.load, harness.per_layer = load, per_layer
    if rc == 0 and "trace" in kept and "run" in kept:
        for note in notes(kept["run"], kept["trace"]):
            print(note, file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
