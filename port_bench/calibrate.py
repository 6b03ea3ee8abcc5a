"""The readings the limits of ``correct`` are set from, on the card.

    python3 -m port_bench.calibrate --workload clip_vit_b16.train_bs64 \\
        --seeds 101 102 ... --control-seeds 101 102 103

For each seed, at the cell's own sizes and through the cell's own timed
path (no measured window: the readings need none):

* train cells: the program's first three steps against the plain
  reference (the lower readings); at the control seeds the reference in
  float8 e4m3 products put in the program's place (the control), and the
  reference with the mean taken over half of each image batch (the fault
  "half of the batch left out").  A state left unchanged reads 1 on
  ``change_gap`` by its measure and needs no run.
* the extraction cell: the program's features of a pass over the pool
  against the reference; at the control seeds the program's own int8
  serving path (``quant="int8"``, the features CLI's ``--quant int8``)
  and the float8 reference.

One JSON line per reading on standard output, and all of them in
``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from port_bench import compare, harness
from port_bench.drivers import extract, train_step
from port_bench.reference import precision
from port_bench.reference.uml import features


def train_readings(wl, cfg, fam, seed, device, control: bool) -> list:
    sd = fam.state_dict(cfg, seed, device)
    img_b, txt_b, rows, labels = train_step.pools(wl, cfg, fam, seed, device, sd)
    head, optimizer, step = train_step.build(wl, cfg, fam, seed, device, sd, rows, labels)
    del sd
    leaf_names = [k for k, p in head.named_parameters() if p.requires_grad]
    prog_units, ref_units = fam.units(leaf_names)
    prog = train_step.first_steps(head, optimizer, step, img_b, txt_b, 3, prog_units)
    del head, optimizer, step
    harness.free(device)
    args = (wl, cfg, fam, seed, device, img_b, txt_b, rows, labels, ref_units)
    ref = train_step.reference(*args)
    def numbers(got):
        return {**compare.train_numbers(got, ref), "losses": got["losses"],
                "ref_losses": ref["losses"]}

    out = [("program", numbers(prog))]
    if control:
        out.append(("control_fp8", numbers(train_step.reference(*args, mm="fp8"))))
        out.append(("fault_half_batch", numbers(
            train_step.reference(*args, rows=wl["batch"] // 2))))
    return out


def extract_readings(wl, cfg, fam, seed, device, control: bool) -> list:
    images = extract.pool(wl, cfg, fam, seed, device)
    sd = fam.state_dict(cfg, seed, device)
    model = fam.build_backbone(cfg, sd, device)
    del sd
    picked = list(range(len(images)))
    out = []
    for name, quant in (("program", "none"),) + ((("control_int8", "int8"),) if control else ()):
        enc = extract.encoder(model, device, quant)
        res = extract.pass_batches(enc, images, len(images))
        out.append((name, extract.reference_gaps(wl, cfg, fam, seed, device, images, res,
                                                 picked)))
    if control:
        sd = fam.image_tower_keys(fam.state_dict(cfg, seed, device))
        with precision.strict_fp32():
            fp8 = {i: features(fam.reference_features, cfg, sd, torch.from_numpy(images[i]).to(device),
                               precision.MATMULS["fp8"]).cpu().numpy() for i in picked}
        out.append(("control_fp8", extract.reference_gaps(
            wl, cfg, fam, seed, device, images, fp8, picked)))
    del model
    harness.free(device)
    return out


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
    readings = train_readings if wl["driver"] == "train_step" else extract_readings
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
