"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m port_bench.calibrate --workload clip_vit_b16.train_bs64 \\
        --seeds 101 102 ... --control-seeds 101 102 103

For each seed, at the cell's own sizes and through the cell's own timed
path (no measured window: the readings need none), the cell's driver's
``readings``: the program's (the lower readings) and, at the control
seeds, the control's and the faults'.

One JSON line per reading on standard output, and all of them in
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    p.add_argument("--out")
    args = p.parse_args(argv)
    harness.cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    wl = harness.workload(args.workload)
    cfg = harness.config(wl["config"])
    fam = harness.module("families", cfg["family"])
    readings = harness.module("drivers", wl["driver"]).readings
    rows = []
    for seed in args.seeds:
        t = time.perf_counter()
        for name, numbers in readings(wl, cfg, fam, seed, device,
                                      seed in args.control_seeds):
            row = {"workload": args.workload, "seed": seed, "reading": name, **numbers}
            rows.append(row)
            print(json.dumps(row), flush=True)
        print(f"[calibrate] seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
    for key in [k for k, v in rows[0].items() if k.endswith(("_gap", "_median", "_nmse"))]:
        for name in sorted({r["reading"] for r in rows}):
            vals = [r[key] for r in rows if r["reading"] == name]
            print(f"[calibrate] {key} {name}: min {min(vals)!r} max {max(vals)!r} "
                  f"n {len(vals)}", file=sys.stderr)
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
