"""The span readers and the idle attribution on synthetic spans and a
small synthetic chrome trace of the device alone."""

import pytest
import torch
from torch.profiler import ProfilerActivity

from port_bench import harness, spans, trace
from uml_tpu_torch.utils import profiling
from uml_tpu_torch.utils.profiling import Span

BASE = 1_000_000_000_000        # the trace's baseTimeNanoseconds
MAIN, OTHER = 11, 12
PHASES = [("uml.step.optimizer", 0, 8), ("uml.step.place", 8, 15),
          ("uml.step.forward", 15, 28), ("uml.step.place", 28, 31),
          ("uml.step.forward", 31, 40), ("uml.step.backward", 40, 70),
          ("uml.step.optimizer", 70, 80), ("uml.step.metrics", 80, 95)]


class _Ids:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return self.n


def _span(ids, name, start_us, end_us, parent=None, tid=MAIN):
    return Span(name, BASE + int(start_us * 1000), BASE + int(end_us * 1000), tid, ids(),
                parent)


def train_spans():
    """The device-only segment's two steps (0-100 and 100-199 us)."""
    ids, out = _Ids(), []
    for t0, t1 in [(0, 100), (100, 199)]:
        root = _span(ids, "uml.step", t0, t1)
        out.append(root)
        for name, a, b in PHASES:
            out.append(_span(ids, name, t0 + a, t0 + b, root.id))
    # a span on another thread covers the device segment
    out.append(_span(ids, "uml.elsewhere", 0, 210, tid=OTHER))
    return out


def x(cat, ts, dur, name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 7,
            "pid": 0}


def device_trace():
    """The device-only segment's trace: the extent 0-210 us, busy 111 us."""
    return {"baseTimeNanoseconds": BASE, "traceEvents": [
        x("cuda_runtime", 0, 1, "cudaLaunchKernel"),
        x("kernel", 10, 10), x("kernel", 45, 15), x("kernel", 72, 6),
        x("gpu_memcpy", 110, 80, "Memcpy HtoD (Pageable -> Device)"),
        x("cuda_runtime", 200, 10, "cudaDeviceSynchronize"),
        {"ph": "i", "name": "marker", "ts": 500}]}


def read(name, run):
    return harness.metric_readers()[name].read(run)


def train_run(got):
    return {"kind": "train", "trace": {"n_spans": 2, "window_s": 210e-6, "busy_s": 111e-6,
                                       "spans": got, "device_trace": device_trace()}}


def test_train_readers_take_the_device_segment():
    run = train_run(train_spans())
    names = ("dispatch_ms.train", "place_ms.train", "diagnostics_ms.train",
             "fetch_wait_ms.extract")
    got = {name: read(name, run) for name in names}
    # the median of 100 and 99 us; two place spans a step (7 + 3 us); the
    # diagnostics 15 us; no fetch in a train run
    assert got == pytest.approx({"dispatch_ms.train": 0.0995, "place_ms.train": 0.010,
                                 "diagnostics_ms.train": 0.015,
                                 "fetch_wait_ms.extract": None})
    assert all(harness.metric_readers()[name].UNIT == "ms" for name in got)


def extract_spans():
    """The device-only segment's three batches: stage (with a slot wait),
    encode, and the fetch of the batch before, from the second batch."""
    ids, out = _Ids(), []
    for b, t0 in enumerate([0, 100, 200]):
        stage = _span(ids, "uml.extract.stage", t0, t0 + 20)
        out += [stage, _span(ids, "uml.extract.slot_wait", t0 + 5, t0 + 9, stage.id),
                _span(ids, "uml.extract.encode", t0 + 20, t0 + 60)]
        if b:
            out.append(_span(ids, "uml.extract.fetch", t0 + 60, t0 + (90 if b < 2 else 99)))
    return out


def test_fetch_wait_is_the_median_fetch_of_the_device_segment():
    run = {"kind": "extract",
           "trace": {"n_spans": 3, "window_s": 1.0, "busy_s": 0.5, "spans": extract_spans()}}
    # the median of the two fetches, 30 and 39 us
    assert read("fetch_wait_ms.extract", run) == pytest.approx(0.0345)
    assert read("dispatch_ms.train", run) is None


@pytest.mark.parametrize("got", [[], train_spans()[:9]])
def test_without_the_segments_spans_no_number(got):
    """A program without spans (the parent of this benchmark's readers),
    or a run whose root spans are not the segment's steps."""
    run = train_run(got)
    for name in ("dispatch_ms.train", "place_ms.train", "diagnostics_ms.train"):
        assert read(name, run) is None


def test_trace_spans_keeps_the_device_segments_spans(monkeypatch):
    """trace_spans keeps the spans of its first segment and that segment's
    chrome trace, and drops the second's (the profiler on the host alone
    here, and the trace's summary stubbed: there is no device)."""
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities: real(activities=[ProfilerActivity.CPU]))
    monkeypatch.setattr(trace, "summarize", lambda events, n, name=None: {
        "busy_s": 1.0, "window_s": 2.0, "n_spans": n, "split_s": {"unattributed": 0.0},
        "idle_gaps": [], "top_ops": []})
    steps = []

    def one():
        with profiling.span("uml.step"):
            steps.append(len(steps))

    profiling.take_spans()
    with profiling.span("uml.step"):
        pass
    got = harness.trace_spans(one, 3, "port_bench.step", torch.device("cpu"))
    assert steps == [0, 1, 2, 3, 4, 5]
    assert [s.name for s in got["spans"]] == ["uml.step"] * 3
    # the kept trace is the first segment's: it holds the kept spans
    data = got["device_trace"]
    timed = [e for e in data["traceEvents"] if e.get("ph") == "X" and "ts" in e]
    lo = min(float(e["ts"]) for e in timed)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in timed)
    for s in got["spans"]:
        assert lo <= profiling.trace_us(s.start_ns, data["baseTimeNanoseconds"]) <= hi
    assert profiling.take_spans() == []


def test_idle_is_named_by_the_innermost_span_and_adds_up():
    run = train_run(train_spans())
    segment = spans.device_segment(run, "train")
    tr = device_trace()
    idle = spans.idle_by_span(tr["traceEvents"], BASE, segment, 2, "uml.step")
    # gaps 0-10 (middle 5: zero_grad), 20-45 (32.5: the text forward),
    # 60-72 (66: backward), 78-110 (94: the diagnostics), 190-210 (200:
    # after the second step); the other thread's span is not the step's
    assert idle == pytest.approx({
        "uml.step.optimizer": 0.010 / 2, "uml.step.forward": 0.025 / 2,
        "uml.step.backward": 0.012 / 2, "uml.step.metrics": 0.032 / 2,
        spans.OUTSIDE: 0.020 / 2})
    assert sum(idle.values()) == pytest.approx((210 - 111) / 1e3 / 2)


def test_self_ms_leaves_out_the_children():
    segment = spans.device_segment(train_run(train_spans()), "train")
    own = spans.self_ms(segment, 2)
    # the steps' 100 + 99 us less their phases' 95 us each
    assert own["uml.step"] == pytest.approx((100 + 99 - 2 * 95) / 1e3 / 2)
    assert own["uml.step.backward"] == pytest.approx(0.030)
    assert own["uml.elsewhere"] == pytest.approx(0.210 / 2)


def test_notes_name_both_sums():
    lines = spans.notes(train_run(train_spans()))
    assert lines[0].startswith("[spans] host ms a step by span (self): {")
    assert lines[1].startswith("[spans] device idle ms a step by span: {")
    assert lines[1].endswith("sum 0.0495, the segment's idle 0.0495")
    assert spans.notes(train_run([])) == [
        "[spans] the traced segments hold no program spans"]
    assert spans.notes({"kind": "text", "trace": {"n_spans": 10, "spans": []}}) == [
        "[spans] the traced segments hold no program spans"]
