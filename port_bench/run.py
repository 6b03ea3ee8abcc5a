"""Run one cell of the benchmark once and print its result line.

    python3 -m port_bench.run --workload clip_vit_b16.train_bs64 \\
        --seed 1234 --seconds 51 --trace 0

from the root of a checkout on a machine with the cell's cards.  The run
loads the program's kernel library (built into ``build/uml_tpu_torch/``
inside the checkout by the first run there), makes the weights and
inputs from ``--seed``, warms up the cell's own shapes, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``.  The numbers compared for ``correct`` and their limits
are the last lines on standard error and the ``checks`` key of the line.
Without a CUDA device, or with fewer than the cell asks for, it prints
no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_cell(wl: dict, cfg: dict, seed: int, seconds: float, trace: bool, device,
             t0: float) -> dict:
    """The driver's run of one cell -> the result line's parts."""
    from port_bench import compare, harness

    driver = harness.module("drivers", wl["driver"])
    fam = harness.module("families", cfg["family"])
    out = driver.run(wl, cfg, fam, seed, seconds, trace, device, t0)
    out["correct"], out["checks"] = compare.judge(out["numbers"], wl["limits"])
    return out


def result_line(out: dict, trace: bool, device) -> dict:
    import torch

    from port_bench import harness

    if trace:
        metrics = harness.per_layer(out["layer"])
    else:
        metrics = {k: {"value": v, "unit": u} for k, (v, u) in out["e2e"].items()}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    summary = out["layer"].get("trace")
    if trace and summary:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["top_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {name: {"value": value, "limit": limit}
                      for name, value, limit in out["checks"]}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    from port_bench import harness, spans

    harness.cache_dirs()
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    import torch

    chips = wl.get("chips", 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(wl, cfg, args.seed, args.seconds, bool(args.trace), device, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"port_bench: the run loaded {bad}: no result", file=sys.stderr)
        return 3
    line = result_line(out, bool(args.trace), device)
    summary = out["layer"].get("trace")
    notes = list(out["notes"])
    if args.trace:
        if summary is None:
            notes.append("[trace] the traced window holds no span: no per-layer numbers")
        else:
            split = summary["split_s"]
            notes.append(f"[trace] {summary['n_spans']} spans, busy "
                         f"{summary['busy_s']} s of {summary['window_s']} s; split "
                         f"{split}; unattributed share "
                         f"{split['unattributed'] / max(summary['split_busy_s'], 1e-30)}")
            notes += spans.notes(out["layer"])
    for note in notes:
        print(note, file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
