"""What the text cell's span readers share: the program's spans of the
traced segment of the device alone (``harness.trace_spans`` keeps them
with that segment's chrome trace), their host time, and the device work
launched inside them.

A device event is joined to its launch by ``correlation`` (the CUDA
runtime and driver calls of the trace, as port_bench/trace.py joins them),
and the launch to the innermost program span that covers it on the
trace's clock (port_bench/trace.py::innermost; a span's wall-clock ns less
the trace's ``baseTimeNanoseconds``, in us, as port_bench/spans.py puts
it there).  The text path launches from one thread, so the spans of every
thread are taken.  A run whose program records no such span (the
LlamaEncoder's path), or whose trace holds no launch, gives None."""

from __future__ import annotations

from port_bench import trace
from port_bench.spans import OUTSIDE


def _segment(run: dict):
    t = run.get("trace")
    if run.get("kind") != "text" or not t or t.get("n_spans", 0) <= 0:
        return None
    return t


def _within(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def host_ms(run: dict, name: str):
    """Host ms a call in the spans called ``name``, or None."""
    t = _segment(run)
    got = [s for s in t.get("spans") or [] if s.name == name] if t else []
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) / 1e6 / t["n_spans"]


def device_ms(run: dict, prefix: str):
    """Device ms a call of the work launched inside the spans called
    ``prefix`` or ``prefix.<child>`` (the union of its intervals), or
    None."""
    t = _segment(run)
    if t is None or not t.get("device_trace"):
        return None
    spans = t.get("spans") or []
    if not any(_within(s.name, prefix) for s in spans):
        return None
    events = t["device_trace"]["traceEvents"]
    base = t["device_trace"]["baseTimeNanoseconds"]
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = float(e["ts"])
    if not launches:
        return None
    ranges = [((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3, s.name) for s in spans]
    work = [(s, e, launches[corr]) for s, e, _, _, corr in trace.device_events(events)
            if corr in launches]
    names = trace.innermost(ranges, [ts for _, _, ts in work], OUTSIDE)
    picked = [(s, e) for (s, e, _), name in zip(work, names) if _within(name, prefix)]
    return trace.union_us(picked) / 1e3 / t["n_spans"]
