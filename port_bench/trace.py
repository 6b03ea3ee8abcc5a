"""Reading a torch.profiler chrome trace: device intervals, their union,
who launched each, and where the device idled.

Device work is chosen by its kind (kernels, memcpys, memsets), never by
its name.  A device event is joined to the host call that launched it by
its ``correlation`` (CUDA runtime and driver calls alike, so the kernels
the program's C library launches through ctypes are joined as any
other), and the launch is classed by the host ranges around it on its
own thread:

* ``optimizer``: inside a range whose name starts with ``Optimizer.``
  (torch.optim's ``Optimizer.step#AdamW.step`` and
  ``Optimizer.zero_grad#AdamW.zero_grad``);
* ``backward``: inside an ``autograd::engine::evaluate_function`` range
  (autograd's backward runs its nodes there, on its own thread);
* ``forward``: every other launch;
* ``unattributed``: a device event whose launch is not in the trace.

The classes split the busy time (the union of device intervals, so
streams that overlap count once): each instant covered by device work is
shared equally among the classes of the events covering it, so the
classes add up to the busy time.
"""

from __future__ import annotations

import bisect
import heapq
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
CLASSES = ("forward", "backward", "optimizer", "unattributed")


def load(path: str) -> dict:
    """A chrome trace file: ``traceEvents`` and ``baseTimeNanoseconds``."""
    with open(path) as f:
        return json.load(f)


def _span(e):
    ts = float(e["ts"])
    return ts, ts + float(e.get("dur", 0.0))


def device_events(events) -> list:
    """[(start_us, end_us, name, cat, correlation)] of the device work."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, t = _span(e)
            out.append((s, t, e.get("name", ""), e["cat"],
                        (e.get("args") or {}).get("correlation")))
    return out


def merged(intervals) -> list:
    """Disjoint sorted intervals covering the same instants."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(t, hi)) for s, t in intervals if t > lo and s < hi]


def union_us(intervals, lo: float = float("-inf"), hi: float = float("inf")) -> float:
    return sum(t - s for s, t in merged(clip(intervals, lo, hi)))


class _Ranges:
    """Host ranges of one class, per thread, merged for bisection."""

    def __init__(self, ranges_by_tid):
        self.by_tid = {tid: merged(r) for tid, r in ranges_by_tid.items()}
        self.starts = {tid: [s for s, _ in r] for tid, r in self.by_tid.items()}

    def holds(self, tid, ts) -> bool:
        starts = self.starts.get(tid)
        if not starts:
            return False
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts <= self.by_tid[tid][i][1]


def classify(events) -> list:
    """[(start, end, name, class)] for every device event."""
    launches = {}
    opt, bwd = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        if cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat in ("cpu_op", "user_annotation"):
            if name.startswith("Optimizer."):
                opt[e.get("tid")].append(_span(e))
            elif name.startswith("autograd::engine::evaluate_function"):
                bwd[e.get("tid")].append(_span(e))
    opt, bwd = _Ranges(opt), _Ranges(bwd)
    out = []
    for s, t, name, _, corr in device_events(events):
        launch = launches.get(corr)
        if launch is None:
            cls = "unattributed"
        elif opt.holds(*launch):
            cls = "optimizer"
        elif bwd.holds(*launch):
            cls = "backward"
        else:
            cls = "forward"
        out.append((s, t, name, cls))
    return out


def split_busy(classed, lo: float, hi: float) -> dict:
    """{class: us} within [lo, hi]: each covered instant shared equally
    among the classes of the events covering it; the values add up to
    the union of the device intervals."""
    edges = []
    for s, t, _, cls in classed:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            edges.append((s, 1, cls))
            edges.append((t, -1, cls))
    edges.sort(key=lambda x: (x[0], x[1]))
    out = dict.fromkeys(CLASSES, 0.0)
    live = defaultdict(int)
    prev = None
    for x, d, cls in edges:
        if prev is not None and x > prev:
            active = [c for c, n in live.items() if n > 0]
            for c in active:
                out[c] += (x - prev) / len(active)
        live[cls] += d
        prev = x
    return out


def top_ops(classed, lo: float, hi: float, n: int = 10) -> list:
    """[(name, seconds)] of the device operations that took most time."""
    agg = defaultdict(float)
    for s, t, name, _ in classed:
        s, t = max(s, lo), min(t, hi)
        if t > s:
            agg[name] += t - s
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in rows]


def host_ranges(events, tid) -> list:
    """[(start, end, name)] of the host ranges on thread ``tid``."""
    return [(*_span(e), e.get("name", "")) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATS
            and e.get("tid") == tid]


def idle_gaps(classed, host, lo: float, hi: float, n: int = 10) -> list:
    """[(what the host thread was doing, seconds)]: the idle gaps of the
    device within [lo, hi], each named by the innermost host range that
    covers its middle (``idle: host outside any range`` where none does),
    summed by name, the longest first."""
    busy = merged(clip([(s, t) for s, t, _, _ in classed], lo, hi))
    gaps, cur = [], lo
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if hi > cur:
        gaps.append((cur, hi))
    names = innermost(host, [(s + t) / 2 for s, t in gaps], "idle: host outside any range")
    agg = defaultdict(float)
    for (s, t), name in zip(gaps, names):
        agg[name] += t - s
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in rows]


def innermost(ranges, points, outside: str) -> list:
    """For each point, the name of the shortest of ``ranges`` ([(start,
    end, name)]) that covers it (the first in their order among equals),
    else ``outside``: one sweep over the points in order, the ranges begun
    by then on a heap by length, those ended before the point dropped."""
    order = sorted(range(len(ranges)), key=lambda k: ranges[k][0])
    heap, i, out = [], 0, [outside] * len(points)
    for p in sorted(range(len(points)), key=points.__getitem__):
        x = points[p]
        while i < len(order) and ranges[order[i]][0] <= x:
            k = order[i]
            heapq.heappush(heap, (ranges[k][1] - ranges[k][0], k))
            i += 1
        while heap and ranges[heap[0][1]][1] < x:
            heapq.heappop(heap)
        if heap:
            out[p] = ranges[heap[0][1]][2]
    return out


def summarize(events, n_spans: int, span_name: str | None = None) -> dict | None:
    """The traced window's numbers.  With ``span_name`` the window runs
    from the start of the first host range of that name (the traffic loop's
    own span around a step or a batch) to the end of the last; without
    it (a trace of the device alone) it is the extent of the trace's
    events, from the first launch to the end of the last wait.  None
    when the trace holds no such window or no device work."""
    if span_name is not None:
        spans = [e for e in events if e.get("ph") == "X" and e.get("name") == span_name
                 and e.get("cat") in ("user_annotation", "cpu_op")]
    else:
        spans = [e for e in events if e.get("ph") == "X" and "ts" in e]
    if not spans:
        return None
    lo = min(float(e["ts"]) for e in spans)
    hi = max(_span(e)[1] for e in spans)
    classed = classify(events)
    if not classed:
        return None
    split = split_busy(classed, lo, hi)
    main_tid = spans[0].get("tid")
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(split.values()) / 1e6,
        "split_s": {k: v / 1e6 for k, v in split.items()},
        "n_spans": n_spans,
        "kernel_s": _kernel_seconds(events, lo, hi),
        "device_events": len(classed),
        "top_ops": top_ops(classed, lo, hi),
        "idle_gaps": idle_gaps(classed, host_ranges(events, main_tid), lo, hi),
    }


def _kernel_seconds(events, lo, hi) -> float:
    """The union of the kernels alone (memcpys and memsets left out)."""
    return union_us([(s, t) for s, t, _, cat, _ in device_events(events)
                     if cat == "kernel"], lo, hi) / 1e6
