"""What every run shares: finding a cell's files by name, the per-layer
readers, the percentile, the device helpers, the traced segments, and
the guard against the JAX package.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``) and its driver (``drivers/<driver>.py``); a
configuration names its family (``families/<family>.py``).  Per-layer
metrics are the files of ``metrics/``, each a ``read(run)`` that returns
a number or None; the harness calls every one of them on a traced run and
keeps those that found something.  Nothing here lists a cell, a
configuration or a metric, so adding one adds files only.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)
# the top-level modules no run may hold (compared whole: the program's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "uml_tpu")


def _json(kind: str, name: str) -> dict:
    path = os.path.join(BENCH, kind, f"{name}.json")
    if not os.path.exists(path):
        raise SystemExit(f"port_bench: no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        data = json.load(f)
    if data.get("name") != name:
        raise SystemExit(f"port_bench: {path} names itself {data.get('name')!r}")
    return data


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def module(kind: str, name: str):
    """``port_bench.<kind>.<name>`` for a Python name, else the file
    ``<kind>/<name>.py`` loaded by path (metric names hold dots)."""
    if name.isidentifier():
        return importlib.import_module(f"port_bench.{kind}.{name}")
    path = os.path.join(BENCH, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_readers() -> dict:
    """{metric name: its reader module} for every file of ``metrics/``."""
    names = sorted(os.path.basename(p)[:-3]
                   for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))
                   if not os.path.basename(p).startswith("_"))
    return {n: module("metrics", n) for n in names}


def per_layer(run: dict) -> dict:
    """{name: {"value", "unit"}} of every reader that found its number."""
    out = {}
    for name, mod in metric_readers().items():
        value = mod.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout.  The program's
    own CUDA library builds into ``build/uml_tpu_torch/<hash>/`` under the
    checkout (uml_tpu_torch/ops/_build.py); these are for anything else
    that would cache compiled code."""
    root = os.path.join(CHECKOUT, "build", "port_bench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(root, "cuda_cache")
    # no library may load JAX into the process by itself
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def warm_profiler(device) -> None:
    """Start the profiler's device tracing once in set-up, so its first
    start is not paid by a traced step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def trace_spans(run_one, count: int, span: str, device) -> dict | None:
    """Profile ``count`` calls of ``run_one`` (one step or batch each) twice,
    right after the window, and read both traces (port_bench/trace.py).

    The first segment traces the device alone: its busy time, window,
    idle share and top operations, with the host paying only CUPTI's
    cost of each launch; its chrome trace (``device_trace``) and the
    program's spans recorded in it (``spans``, port_bench/spans.py) are
    kept for the span readers and notes.  The second adds the host's op
    ranges, which cost host time of every op: its device time is split by
    launch into forward, backward and optimizer, and its idle gaps are
    named by what the host thread was doing; its spans are dropped.  Each
    trace is written under TMPDIR and deleted once read."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench import spans, trace

    acts = {"device": [ProfilerActivity.CUDA],
            "host": [ProfilerActivity.CPU, ProfilerActivity.CUDA]}
    got, kept = {}, {}
    tmp = tempfile.mkdtemp(prefix="port_bench_trace_")
    try:
        for key, activities in acts.items():
            sync(device)
            spans.take()
            with profile(activities=activities) as prof:
                for _ in range(count):
                    with record_function(span):
                        run_one()
                sync(device)
            kept[key] = spans.take()
            path = os.path.join(tmp, f"{key}.json")
            prof.export_chrome_trace(path)
            data = trace.load(path)
            got[key] = trace.summarize(data["traceEvents"], count,
                                       span if key == "host" else None)
            if key == "device":
                kept["trace"] = data
            os.remove(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev, host = got["device"], got["host"]
    if dev is None or host is None or dev["busy_s"] <= 0:
        return None
    return {**dev, "split_s": host["split_s"], "split_busy_s": host["busy_s"],
            "idle_gaps": host["idle_gaps"], "spans": kept["device"],
            "device_trace": kept["trace"]}


def counter_delta(before: dict, after: dict, per: int) -> dict:
    return {k: (after[k] - before[k]) / max(per, 1) for k in after
            if after[k] != before[k]}


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The device's peak allocation since ``reset_peak`` (0 off the card)."""
    import torch

    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device)


def free(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
