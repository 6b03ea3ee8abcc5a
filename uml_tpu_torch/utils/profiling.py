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
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
from collections import defaultdict

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
    """Context manager: profile the body, print a top-kernel table.

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
