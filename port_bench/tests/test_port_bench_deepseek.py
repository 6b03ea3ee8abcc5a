"""The DeepSeek-V2-Lite text cell on the CPU: its configuration's size and
operations at the published widths, the driver's pool and reference at a
tiny size, its readers; and on the card its control and fault."""

import os
import subprocess
import sys
import time

import pytest
import torch

from port_bench import compare, flops, harness
from port_bench.drivers import extract_text
from port_bench.run import run_cell
from port_bench.tests import tiny
from uml_tpu_torch.utils.profiling import Span

CELL = "deepseek_v2_lite.text_cupl30"
CPU = torch.device("cpu")


def tiny_cfg() -> dict:
    """DeepSeek-V2-Lite's schema at hidden 64, 3 layers (the first dense),
    8 experts top-2 and 2 shared, kv_lora_rank 16, rope 8, nope 16, v 16."""
    cfg = harness.config("deepseek_v2_lite")
    cfg.update(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
               num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
               n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=16,
               qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, vocab_size=300,
               max_position_embeddings=128)
    return cfg


def tiny_cell() -> dict:
    wl = tiny.cell(CELL)
    wl["ids"] = {"low": 3, "bos": 1, "pad": 2}
    return wl


def test_published_schema_holds_the_published_parameters():
    cfg = harness.config("deepseek_v2_lite")
    fam = harness.module("families", cfg["family"])
    n = sum(int(torch.Size(shape).numel()) for _, shape, _, _ in fam.schema(cfg))
    assert n == 15_496_769_024
    assert cfg["reduced"] == [] and cfg["compute_dtype"] == "float32"
    keys = [k for k, *_ in fam.schema(cfg)]
    assert len(keys) == len(set(keys))
    assert "layers.26.mlp.experts.63.down_proj.weight" in keys
    assert "layers.0.mlp.gate_proj.weight" in keys and "layers.0.mlp.gate.weight" not in keys


def test_published_call_operations_and_weight_reads():
    """4.48 GFLOP of products a real token (MLA's projections, the dense
    layer, 26 x (gate, 6 experts, the shared experts)), and every weight
    but the embedding's read once a call: 61.2 GB."""
    cfg = harness.config("deepseek_v2_lite")
    fam = harness.module("families", cfg["family"])
    one = fam.forward_ops(cfg, [1])
    core = sum(f for name, f, _ in one if name.endswith("mla_core"))
    assert core == 27 * 2.0 * 16 * (192 + 128)
    per_token = flops.model_flops(one) - core
    assert per_token == pytest.approx(4.484e9, rel=1e-3)
    weights = sum(b for _, _, b in one)
    assert 61.1e9 < weights < 61.3e9
    # a call of 30 rows: the products scale with the real tokens alone
    lengths = list(range(2, 32))
    call = fam.forward_ops(cfg, lengths)
    call_core = sum(f for name, f, _ in call if name.endswith("mla_core"))
    pairs = sum(t * (t + 1) // 2 for t in lengths)
    assert call_core == pytest.approx(27 * 2.0 * pairs * 16 * 320)
    assert flops.model_flops(call) - call_core == pytest.approx(per_token * sum(lengths))


def test_tiny_pool_and_reference_agree_with_the_program():
    cfg = tiny_cfg()
    fam = harness.module("families", cfg["family"])
    wl = tiny_cell()
    calls = extract_text.pool(wl, fam.vocab(cfg), 5)
    ids, mask, lengths = calls[0]
    assert len(set(lengths)) > 1 and mask[:, 0].min() == 0 and mask[:, -1].min() == 1
    sd = fam.state_dict(cfg, 5, CPU)
    assert set(sd) == {k for k, *_ in fam.schema(cfg)}
    # each layer lies in storage of its own
    storages = {sd[f"layers.{i}.input_layernorm.weight"].untyped_storage().data_ptr()
                for i in range(3)}
    assert len(storages) == 3
    tm = fam.build_text_model(cfg, sd, CPU)
    got = torch.cat([torch.from_numpy(extract_text.encode(tm, c)) for c in calls])
    want = extract_text.reference(cfg, fam, 5, CPU, calls, range(len(calls)))
    assert got.shape == (len(calls) * 30, 64)
    assert compare.feature_numbers(got, want)["feature_gap"] < 1e-5
    assert torch.equal(fam.state_dict(cfg, 5, CPU)["norm.weight"], sd["norm.weight"])


def test_tiny_run_is_correct_and_counts_its_routes():
    cfg = tiny_cfg()
    out = run_cell(tiny_cell(), cfg, 2**31 + 3, 0.3, False, CPU, time.perf_counter())
    assert out["correct"], out["checks"]
    route = out["layer"]["route"]
    assert route["routed_rows"] > 0 and route["expert_launches"] % 3 == 0
    assert harness.per_layer(out["layer"])["expert_launches.text"]["value"] == \
        route["expert_launches"]


def test_tiny_readings_put_control_and_fault_above_the_program():
    cfg = tiny_cfg()
    fam = harness.module("families", cfg["family"])
    wl = tiny_cell()
    got = dict(extract_text.readings(wl, cfg, fam, 7, CPU, True))
    assert got["program"]["feature_nmse"] < 1e-10
    assert got["fault_pads_counted"]["feature_nmse"] > 1e-3
    # TF32 does not exist on the CPU: the control reads as the program
    assert got["control_tf32"]["feature_nmse"] < 1e-10


def _span(name, start_ms, end_ms, id_, parent=None):
    return Span(name, int(start_ms * 1e6), int(end_ms * 1e6), 1, id_, parent)


def spans_run(launch_events=True):
    """A text run whose device-only segment holds two calls of one MLA and
    one MoE span (with its route child), the kernels each launched."""
    spans, events, corr = [], [], 0
    for call in range(2):
        t0 = call * 100.0
        root = 10 * call
        spans += [_span("uml.text.encode", t0, t0 + 90, root),
                  _span("uml.text.mla", t0 + 1, t0 + 11, root + 1, root),
                  _span("uml.text.moe", t0 + 20, t0 + 60, root + 2, root),
                  _span("uml.text.moe.route", t0 + 21, t0 + 31, root + 3, root + 2)]
        # (launch ms, kernel start ms, kernel ms): 2 in MLA, 3 in the MoE
        # (one in its route), one outside both
        for launch, start, dur in ((t0 + 2, t0 + 3, 4.0), (t0 + 5, t0 + 7, 2.0),
                                   (t0 + 22, t0 + 24, 1.0), (t0 + 35, t0 + 36, 10.0),
                                   (t0 + 40, t0 + 46, 10.0), (t0 + 70, t0 + 71, 5.0)):
            corr += 1
            if launch_events:
                events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                               "ts": launch * 1e3, "dur": 5.0, "tid": 1,
                               "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel",
                           "name": "moe_gemm_kernel" if launch == t0 + 35 else f"k{corr}",
                           "ts": start * 1e3, "dur": dur * 1e3,
                           "args": {"correlation": corr, "grid": [64 + 85, 22, 1]}})
    trace = {"n_spans": 2, "busy_s": 0.1, "window_s": 0.2, "kernel_s": 0.1, "spans": spans,
             "device_trace": {"traceEvents": events, "baseTimeNanoseconds": 0}}
    return {"kind": "text", "steps": 5, "window_s": 1.0, "model_flops": 1e12,
            "peak_flops": flops.PEAK_TF32_FLOPS, "least_s": 0.01, "trace": trace,
            "route": {"expert_launches": 4992.0, "routed_rows": 6840.0,
                      "moe_gemm_flops": 1.0e12, "moe_gemm_bytes": 6.7e9,
                      "moe_gemm_weight_bytes": 5.7e9, "moe_gemm_tiles": 64.0 + 170,
                      "moe_gemm_groups": 64.0}}


def read(name, run):
    return harness.metric_readers()[name].read(run)


NEW = ("moe_ms.text", "mla_ms.text", "moe_route_ms.text", "expert_launches.text",
       "moe_gemm_roofline.text")


def test_new_readers_read_the_spans_and_counters():
    run = spans_run()
    got = {name: read(name, run) for name in NEW}
    # the grouped kernel: 10 ms a call; the traced grids hold 85 row tiles
    # a call to the warm-up's 170, so half the rows' work: 5.7 GB of
    # weights and 0.5 GB of rows at 3.35 TB/s (1.85 ms), above 0.5 TFLOP
    # at the TF32 peak (1.01 ms)
    assert got == pytest.approx({"moe_ms.text": 1.0 + 10.0 + 10.0, "mla_ms.text": 6.0,
                                 "moe_route_ms.text": 10.0, "expert_launches.text": 4992.0,
                                 "moe_gemm_roofline.text": 100 * 6.2e9 / 3.35e12 / 0.010})
    # the operations bound where they are the larger
    heavy = spans_run()
    heavy["route"]["moe_gemm_flops"] = 8.0e12
    assert read("moe_gemm_roofline.text", heavy) == pytest.approx(100 * 4.0e12 / 494.7e12 / 0.010)
    # a trace whose kernels hold no grid gives no rows: no share
    for e in heavy["trace"]["device_trace"]["traceEvents"]:
        e.get("args", {}).pop("grid", None)
    assert read("moe_gemm_roofline.text", heavy) is None
    # a trace without launch events joins nothing
    bare = spans_run(launch_events=False)
    assert read("moe_ms.text", bare) is None and read("mla_ms.text", bare) is None


def test_new_readers_read_nothing_on_other_runs():
    mistral = spans_run()
    mistral["trace"]["spans"] = [s for s in mistral["trace"]["spans"]
                                 if s.name == "uml.text.encode"]
    mistral["route"] = {}
    assert {name: read(name, mistral) for name in NEW} == dict.fromkeys(NEW)
    bare = {"kind": "text", "steps": 5, "window_s": 1.0, "model_flops": 1e12,
            "peak_flops": flops.PEAK_TF32_FLOPS, "least_s": 0.01,
            "trace": {"n_spans": 10, "busy_s": 3.0, "window_s": 3.2, "kernel_s": 2.9}}
    assert {name: read(name, bare) for name in NEW} == dict.fromkeys(NEW)
    for kind in ("train", "extract"):
        assert {name: read(name, {**spans_run(), "kind": kind})
                for name in NEW} == dict.fromkeys(NEW)
    assert read("moe_ms.text", {**spans_run(), "trace": None}) is None


SCRIPT = r"""
import sys, time, torch
from port_bench import harness
from port_bench.run import run_cell
from port_bench.tests.test_port_bench_deepseek import tiny_cell, tiny_cfg
run_cell(tiny_cell(), tiny_cfg(), 5, 0.2, False, torch.device("cpu"), time.perf_counter())
print("FORBIDDEN", harness.forbidden_modules())
"""


def test_cpu_path_loads_no_jax():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": harness.CHECKOUT}
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=harness.CHECKOUT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FORBIDDEN []" in proc.stdout


@pytest.mark.cuda
def test_control_and_fault_fail_the_limit_on_the_card():
    """At the cell's own size: the TF32 control and the pads-counted fault
    fail the limit on three seeds, the program passes it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    harness.cache_dirs()
    wl = harness.workload(CELL)
    cfg = harness.config(wl["config"])
    fam = harness.module("families", cfg["family"])
    readings = harness.module("drivers", wl["driver"]).readings
    for seed in (3300000001, 3300000002, 3300000003):
        for reading, numbers in readings(wl, cfg, fam, seed, torch.device("cuda", 0), True):
            ok, rows = compare.judge(numbers, wl["limits"])
            assert ok == (reading == "program"), (seed, reading, rows)
