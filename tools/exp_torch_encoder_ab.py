#!/usr/bin/env python3
"""Parent-vs-change pairs of the port's end-to-end encoder rates.

Two checkouts of ``uml_tpu_torch`` (each a ``git archive`` under
``build/``) are measured in ``--pairs`` pairs of child processes, the
order alternating (parent first, then change first, ...), each child on
one checkout: the bf16 and the int8 ViT-B/16 image encoders' img/s at
batch 64 (random init, a staged batch, host work included as in
chip_smoke.py's ``_time_ms``), the text encoder's prompts/s at 64
prompts, and the device time of one bf16 batch (chip_smoke.py's
``_profile``), which separates the card's work from the host's.

    python3 tools/exp_torch_encoder_ab.py --parent build/parent \\
        --change build/final --pairs 10

Prints each child's JSON line, then per metric the medians, the parent's
interquartile range, and in how many pairs the change read better; needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# metric -> True where higher is better
METRICS = {"bf16 img/s": True, "int8 img/s": True, "text prompts/s": True,
           "bf16 device ms per batch": False}


def child(root: str) -> dict:
    """One checkout's rates, measured in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np

    from uml_tpu_torch.models.encoders import ClipEncoder

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    u8 = np.random.default_rng(0).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    prompts = [f"a photo of a class_{i}." for i in range(64)]
    out = {"root": os.path.abspath(root)}
    encoder = ClipEncoder("ViT-B/16", allow_random_init=True)
    staged, n = encoder.stage_images(u8)
    out["bf16 img/s"] = 64 / (harness._time_ms(lambda: encoder.encode_staged(staged, n),
                                               iters=20) / 1e3)
    out["text prompts/s"] = 64 / (harness._time_ms(lambda: encoder.encode_texts(prompts),
                                                   iters=20) / 1e3)
    rows = harness._profile("bf16 image encoder", lambda: encoder.encode_staged(staged, n),
                            reps=3, top=0)
    out["bf16 device ms per batch"] = sum(t for _, t, _ in rows) / 3 / 1e3
    del encoder
    encoder = ClipEncoder("ViT-B/16", allow_random_init=True, quant="int8")
    staged, n = encoder.stage_images(u8)
    out["int8 img/s"] = 64 / (harness._time_ms(lambda: encoder.encode_staged(staged, n),
                                               iters=20) / 1e3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the parent's checkout")
    ap.add_argument("--change", help="the change's checkout")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--child", help="measure this checkout in this process")
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_encoder_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    runs = {"parent": [], "change": []}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                                   getattr(args, side)], capture_output=True, text=True,
                                  check=True)
            line = proc.stdout.strip().splitlines()[-1]
            print(f"pair {i} {side} {line}", flush=True)
            runs[side].append(json.loads(line))
    for metric, higher in METRICS.items():
        p = [r[metric] for r in runs["parent"]]
        c = [r[metric] for r in runs["change"]]
        q = statistics.quantiles(p, n=4)
        wins = sum((cv > pv) if higher else (cv < pv) for pv, cv in zip(p, c))
        print(f"{metric}: parent median {statistics.median(p)!r} (interquartile "
              f"{q[0]!r} .. {q[2]!r}), change median {statistics.median(c)!r}; the change "
              f"better in {wins} of {len(p)} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
