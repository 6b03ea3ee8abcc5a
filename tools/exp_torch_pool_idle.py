#!/usr/bin/env python3
"""Do idle spawn decode pools slow the host's kernel launches?

The RN50 / RN101 image encoders launch many small kernels, so their rate
at batch 64 depends on the host.  This times both (random init, bf16, a
staged batch of 64, chip_smoke._time_ms: CUDA events around 20 calls,
host work included) in turns: with no decode pool, with idle
data/loader.py spawn pools of 1, 4 and 8 workers alive (each first
decodes a few batches of JPEGs, as the features CLI leaves them), after
``shutdown_proc_pools()``, and with the pools again.

    python3 tools/exp_torch_pool_idle.py

Needs a CUDA card; prints one line a measurement and a JSON line with
the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np

    import chip_smoke as cs
    from uml_tpu_torch.data import loader as ld
    from uml_tpu_torch.models.encoders import ClipEncoder

    gpu = cs._gpu_line()
    photos = cs._photo_fixture(os.path.join(tempfile.mkdtemp(), "photos"), n=16)
    items = [{"impath": photos[i % len(photos)], "label": 0} for i in range(512)]
    u8 = np.random.default_rng(0).integers(0, 256, (64, 224, 224, 3), dtype=np.uint8)
    encoders = {}
    for name in ("RN50", "RN101"):
        enc = ClipEncoder(name, allow_random_init=True)
        encoders[name] = (enc, enc.stage_images(u8))

    def pools_up():
        for workers in (1, 4, 8):
            for _ in ld.ImageBatchLoader(items, "crop", 64, num_workers=workers,
                                         worker_kind="process", prefetch=2 * workers):
                pass

    out = {}
    for turn, state in enumerate(("no pool", "idle pools", "idle pools", "no pool")):
        if state == "idle pools":
            pools_up()
        else:
            ld.shutdown_proc_pools()
        for name, (enc, (staged, n)) in encoders.items():
            ms = cs._time_ms(lambda: enc.encode_staged(staged, n))
            out.setdefault(f"{name} {state}", []).append(ms)
            print(f"[pool-idle] turn {turn}, {state:10s}: {name} {ms:.3f} ms per batch "
                  f"of 64 = {64 / ms * 1e3:.1f} img/s  [{gpu}]")
    ld.shutdown_proc_pools()
    print(json.dumps({"gpu": gpu, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
