"""Profiling helpers: device traces and top-kernel summaries.

The port of uml_tpu/utils/profiling.py over ``torch.profiler`` (CUPTI on
the card): ``trace_and_summarize`` profiles a block and writes its trace
with ``tensorboard_trace_handler(trace_dir, use_gzip=True)``
(``*.pt.trace.json.gz``, which uml_tpu's glob ``**/*.trace.json.gz``
also finds); ``summarize_trace`` digests the newest trace into per-kernel
device-time totals.  Device work is chosen by its kind, never by its
name: kernels, memcpys and memsets count; a ``record_function`` range's
device-side span, which covers kernels counted in their own rows, and
every CPU-side event do not.

Spans name the program's own phases (``train/supervised.py``'s step,
``models/encoders.py``'s extraction pipeline).  ``span(name)`` records
only while a ``torch.profiler`` recording runs (``trace_and_summarize``'s
or any other), and costs one check of the profiler's flag otherwise: it
returns a shared no-op context, reads no clock and allocates nothing.  A
recorded span opens a ``record_function`` range of its name, so the
trace shows the phase around the ops it holds, and goes into a bounded
in-memory buffer (``take_spans``, the last SPAN_CAPACITY) on the wall
clock.  ``trace_us`` puts a span on a chrome trace's clock.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import itertools
import json
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

from torch.autograd import profiler as _torch_profiler

# the chrome-trace categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_rows(events):
    """(name, self device time in us, count) of every event of a profile's
    ``key_averages()`` that ran on the card: kernels (PyTorch's elementwise
    lambdas, ``...{lambda(float)#1}``, among them), memcpys and memsets.
    Only device-side rows count (an aten op's own row would count its
    kernels a second time), and a ``record_function`` range
    (``Optimizer.step#AdamW.step``) is dropped: by ``is_user_annotation``
    where the torch build sets it, else by the name its CPU-side event in
    the same profile carries."""
    from torch.autograd import DeviceType

    cpu_names = {e.key for e in events if e.device_type != DeviceType.CUDA}

    def annotation(e):
        flag = getattr(e, "is_user_annotation", None)
        return e.key in cpu_names if flag is None else flag

    return [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not annotation(e)]


def summarize_trace(trace_dir: str, top: int = 15, per_iter: int = 1):
    """-> [(kernel name, total_ms/per_iter, count/per_iter)] sorted by
    time, from the newest ``*.trace.json.gz`` under ``trace_dir``."""
    files = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
    if not files:
        raise FileNotFoundError(f"no trace json under {trace_dir}")
    with gzip.open(sorted(files)[-1]) as f:
        data = json.load(f)
    agg = defaultdict(lambda: [0.0, 0])
    for e in data.get("traceEvents", []):
        if (e.get("ph") == "X" and e.get("dur")
                and e.get("cat") in DEVICE_CATEGORIES):
            agg[e["name"]][0] += e["dur"]
            agg[e["name"]][1] += 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return [(name, dur / 1e3 / per_iter, cnt // per_iter)
            for name, (dur, cnt) in rows]


@contextlib.contextmanager
def trace_and_summarize(trace_dir: str, iters: int = 1, top: int = 15,
                        quiet: bool = False):
    """Context manager: profile the body, print a top-kernel table.  The
    program's spans record meanwhile (the trace shows their ranges).

        with trace_and_summarize("/tmp/tr", iters=3):
            for _ in range(3):
                loss = float(step(...))
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir, use_gzip=True)):
        yield
    rows = summarize_trace(trace_dir, top=top, per_iter=iters)
    if not quiet:
        print(f"--- device top kernels ({trace_dir}, per-iter) ---")
        for name, ms, cnt in rows:
            print(f"{ms:9.2f} ms  x{cnt:4d}  {name}")


# ---------------------------------------------------------------- spans

SPAN_CAPACITY = 65536


class Span(NamedTuple):
    """One recorded span: wall-clock ns (``time.time_ns``'s clock) of its
    entry and exit, its thread (the OS thread id, as a chrome trace's
    ``tid``), its number (spans are numbered as they open) and the number
    of the span around it on its thread (None for an outermost one)."""

    name: str
    start_ns: int
    end_ns: int
    tid: int
    id: int
    parent: int | None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_buffer: deque = deque(maxlen=SPAN_CAPACITY)
_numbers = itertools.count()
# per thread: .stack, the numbers of its open spans, and .tid, its OS
# thread id (read once: get_native_id is a system call)
_open = threading.local()
# (time_ns, perf_counter_ns) taken together: spans are timed by
# perf_counter_ns and put on the wall clock through it; retaken at every
# outermost span, so the two clocks cannot drift apart over a long run
_anchor = (time.time_ns(), time.perf_counter_ns())


def span(name: str):
    """A context manager around one phase of the program; see the module
    docstring."""
    if not _torch_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


class _Span:
    __slots__ = ("name", "number", "parent", "start", "range")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        global _anchor
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
            _open.tid = threading.get_native_id()
        if stack:
            self.parent = stack[-1]
        else:
            self.parent = None
            _anchor = (time.time_ns(), time.perf_counter_ns())
        self.number = next(_numbers)
        stack.append(self.number)
        self.range = _torch_profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _open.stack.pop()
        wall, counter = _anchor
        # a plain tuple, which the garbage collector stops tracking (a
        # NamedTuple stays tracked, and every full collection scans it)
        _buffer.append((self.name, wall + self.start - counter, wall + end - counter,
                        _open.tid, self.number, self.parent))
        return False


def take_spans() -> list:
    """The recorded spans (``Span``) in the order they closed; empties the
    buffer (which keeps the last SPAN_CAPACITY)."""
    out = []
    while True:
        try:
            out.append(Span._make(_buffer.popleft()))
        except IndexError:
            return out


def trace_us(ns: int, base_ns: int) -> float:
    """A span's wall-clock ns on the clock of a chrome trace whose
    ``baseTimeNanoseconds`` is ``base_ns``: the trace's ``ts`` in us."""
    return (ns - base_ns) / 1e3
