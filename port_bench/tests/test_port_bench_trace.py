"""The trace arithmetic on a small synthetic chrome trace."""

import json

import pytest

from port_bench import trace

MAIN, AUTOGRAD = 1, 2


def x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "pid": 0}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """Two steps' worth: a forward kernel, a copy on another stream that
    overlaps it, a backward kernel launched from autograd's thread, an
    optimizer kernel (launched by the driver API), and a kernel whose
    launch is missing."""
    return [
        x("user_annotation", "port_bench.step", 0, 100),
        x("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        x("kernel", "fwd_gemm", 10, 20, tid=7, corr=1),
        x("cuda_runtime", "cudaMemcpyAsync", 2, 1, corr=2),
        x("gpu_memcpy", "Memcpy HtoD", 20, 20, tid=8, corr=2),       # overlaps 20-30
        x("cpu_op", "autograd::engine::evaluate_function: MlpBlockFnBackward",
          30, 20, tid=AUTOGRAD),
        x("cuda_runtime", "cudaLaunchKernel", 31, 1, tid=AUTOGRAD, corr=3),
        x("kernel", "bwd_kernel", 45, 15, tid=7, corr=3),
        x("user_annotation", "Optimizer.step#AdamW.step", 60, 10),
        x("cuda_driver", "cuLaunchKernel", 61, 1, corr=4),
        x("kernel", "multi_tensor_apply_kernel", 70, 10, tid=7, corr=4),
        x("kernel", "orphan", 85, 5, tid=7, corr=99),
        x("cpu_op", "aten::item", 80, 20),
        x("user_annotation", "port_bench.step", 100, 50),
    ]


def test_union_counts_overlapping_streams_once():
    devs = trace.device_events(synthetic())
    # fwd 10-30, copy 20-40, bwd 45-60, opt 70-80, orphan 85-90
    assert trace.union_us([(s, t) for s, t, *_ in devs]) == pytest.approx(30 + 15 + 10 + 5)
    assert trace.union_us([(0, 10), (5, 15)], lo=2, hi=12) == pytest.approx(10)


def test_classes_by_launch_and_split_adds_up_to_busy():
    classed = trace.classify(synthetic())
    cls = {name: c for _, _, name, c in classed}
    assert cls == {"fwd_gemm": "forward", "Memcpy HtoD": "forward",
                   "bwd_kernel": "backward", "multi_tensor_apply_kernel": "optimizer",
                   "orphan": "unattributed"}
    split = trace.split_busy(classed, 0, 150)
    assert sum(split.values()) == pytest.approx(60)
    assert split == pytest.approx({"forward": 30, "backward": 15, "optimizer": 10,
                                   "unattributed": 5})


def test_overlap_of_two_classes_is_shared():
    classed = [(0, 10, "a", "forward"), (5, 15, "b", "backward")]
    split = trace.split_busy(classed, 0, 20)
    assert split["forward"] == pytest.approx(7.5)
    assert split["backward"] == pytest.approx(7.5)
    assert sum(split.values()) == pytest.approx(15)


def test_summary_window_gaps_and_ops(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": synthetic()}))
    s = trace.summarize(trace.load(str(path))["traceEvents"], 2, "port_bench.step")
    assert s["window_s"] == pytest.approx(150e-6)
    assert s["busy_s"] == pytest.approx(60e-6)
    assert s["kernel_s"] == pytest.approx((20 + 15 + 10 + 5) * 1e-6)
    assert s["n_spans"] == 2
    assert s["top_ops"][0] == ["fwd_gemm", pytest.approx(20e-6)]
    gaps = dict(s["idle_gaps"])
    # 90-150 idle: its middle (120) lies in the second step's span only;
    # 0-10 in the first step's span; 60-70 in the optimizer's range
    assert gaps["port_bench.step"] == pytest.approx((10 + 5 + 60) * 1e-6)
    assert gaps["Optimizer.step#AdamW.step"] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(90e-6)


def test_summary_without_spans_is_none():
    assert trace.summarize(synthetic()[1:-1], 2, "port_bench.step") is None


def test_device_only_window_is_the_traces_extent():
    events = [e for e in synthetic() if e["cat"] not in ("user_annotation", "cpu_op")]
    s = trace.summarize(events, 2)
    # from the first launch (1) to the orphan kernel's end (90)
    assert s["window_s"] == pytest.approx(89e-6)
    assert s["busy_s"] == pytest.approx(60e-6)
