"""``utils/profiling.py``: the trace summary keeps the card's work only.

``summarize_trace`` reads the newest ``*.trace.json.gz`` under a folder
and sums the device events (kernels, memcpys, memsets) by name; CPU ops,
``record_function`` ranges and their device-side spans do not count.
``trace_and_summarize`` writes a ``*.pt.trace.json.gz`` that uml_tpu's
glob finds (on the CPU the summary is empty: no device event).
"""

import gzip
import json
import os
import time

import pytest
import torch

from uml_tpu_torch.utils.profiling import summarize_trace, trace_and_summarize


def _write(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


def _ev(name, cat, dur, ph="X"):
    return {"name": name, "cat": cat, "dur": dur, "ph": ph, "ts": 0}


def test_summary_sums_device_events_by_name(tmp_path):
    _write(str(tmp_path / "old" / "a.pt.trace.json.gz"),
           [_ev("stale_kernel", "kernel", 1e6)])
    time.sleep(0.01)
    events = [
        _ev("wgmma_gemm_kernel<false, true, 9>", "kernel", 3000),
        _ev("wgmma_gemm_kernel<false, true, 9>", "kernel", 1000),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 500),
        _ev("Memset (Device)", "gpu_memset", 100),
        _ev("aten::mm", "cpu_op", 9000),
        _ev("Optimizer.step#AdamW.step", "user_annotation", 9000),
        _ev("Optimizer.step#AdamW.step", "gpu_user_annotation", 9000),
        _ev("cudaLaunchKernel", "cuda_runtime", 700),
        _ev("wgmma_gemm_kernel<false, true, 9>", "kernel", 0),
        _ev("flow", "kernel", 50, ph="f"),
    ]
    _write(str(tmp_path / "run" / "z.pt.trace.json.gz"), events)
    rows = summarize_trace(str(tmp_path), top=10, per_iter=2)
    assert rows == [("wgmma_gemm_kernel<false, true, 9>", 2.0, 1),
                    ("Memcpy HtoD (Pageable -> Device)", 0.25, 0),
                    ("Memset (Device)", 0.05, 0)]


def test_summary_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        summarize_trace(str(tmp_path))


def test_trace_and_summarize_writes_a_gzipped_trace(tmp_path, capsys):
    with trace_and_summarize(str(tmp_path), iters=2):
        for _ in range(2):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert any(f.endswith(".pt.trace.json.gz") for f in files), files
    assert "device top kernels" in capsys.readouterr().out
