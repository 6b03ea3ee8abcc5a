#!/usr/bin/env python3
"""The MLP rows of one checkout of ``uml_tpu_torch`` on the card, by their
bits and their times: do the quick_gelu training rows (CLIP) and the
exact-GELU inference products (DINO) of two checkouts compute the same?

* CLIP ViT-B/16 at B = 64 (S = 197, K 768, M 3072), quick_gelu, the
  wrappers' default activation: row 3 ``mlp_block``, row 9
  ``mlp_block_stash`` (out, pre), row 19 ``mlp_bwd`` (dx_ln, xn, dpre,
  yact) and row 20 ``mlp_bwd_dw`` (dx, dw1, db1, dw2).
* DINOv2-B/14 at B = 64 (S = 257, eps 1e-6), exact GELU: row 3
  ``mlp_block`` and row 14, the 2-d ``ln_matmul`` (the engine's
  OUT_GELU_EXACT without a stash); where the checkout has them (the
  ``activation`` of the training wrappers), rows 9, 19 and 20 with exact
  GELU, timed only.

Each output's sha256 (bf16 as its int16 bits): equal digests on two
checkouts, the same bits.  Each row graph-timed with the checkout's own
``chip_smoke._graph_time_ms`` (up to 100 calls in one CUDA graph over
input copies > 2 x L2).  Inputs are drawn from seeded generators on the
card, the same on every checkout.

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_mlp_bits.py --root build/parent
    python3 tools/exp_torch_mlp_bits.py

Needs a CUDA card; prints ``[bits]`` and ``[time]`` lines and one JSON
line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t):
    import torch

    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE, help="the checkout to measure")
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root",
                                                  os.path.join(root, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops import ln_matmul as lm

    if not torch.cuda.is_available():
        print("exp_torch_mlp_bits: no CUDA device", file=sys.stderr)
        return 2
    assert lm.__file__.startswith(root), (lm.__file__, root)
    _build.build()
    dev = torch.device("cuda")
    bf = torch.bfloat16
    rows = {}

    def layer(seed, s, k, m):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(64, s, k, generator=gen, device=dev).to(bf)
        g = torch.randn(64, s, k, generator=gen, device=dev).to(bf)
        return x, g, cs._block_weights(gen, k, m, k, dev)

    def run(name, fn, inputs, bits=True):
        out = fn(*inputs)
        torch.cuda.synchronize()
        out = out if isinstance(out, tuple) else (out,)
        ms = cs._graph_time_ms(fn, cs._input_copies(inputs))
        rows[name] = {"ms": ms, "sha256": [_digest(t) for t in out] if bits else None}
        if bits:
            print(f"[bits] {name}: " + " ".join(d[:16] for d in rows[name]["sha256"]))
        print(f"[time] {name}: {ms:.4f} ms")

    x, g, w = layer(0, 197, 768, 3072)
    mlp = (w["w1"], w["b1"], w["w2"], w["b2"])
    dy = torch.matmul(g, w["w2"].t())
    run("row3_mlp_block_clip", lm.mlp_block, (x, *mlp))
    run("row9_mlp_block_stash_clip", lm.mlp_block_stash, (x, *mlp))
    run("row19_mlp_bwd_clip", lm.mlp_bwd, (x, dy, w["b1"], w["w1"]))
    run("row20_mlp_bwd_dw_clip", lm.mlp_bwd_dw, (x, g, w["b1"], w["w1"], w["w2"]))

    x, g, w = layer(1, 257, 768, 3072)
    mlp = (w["w1"], w["b1"], w["w2"], w["b2"])
    dy = torch.matmul(g, w["w2"].t())
    gelu = dict(eps=1e-6, activation="gelu_exact")
    gen = torch.Generator(device=dev).manual_seed(2)
    ln = tuple(a + 0.1 * torch.randn(768, generator=gen, device=dev) for a in (1.0, 0.0))
    run("row3_mlp_block_dino", lambda *a: lm.mlp_block(*a, **gelu), (x, *mlp))
    run("row14_ln_matmul_gelu_exact_dino",
        lambda *a: lm.ln_matmul(*a, activation="gelu_exact"),
        (x.reshape(-1, 768), *ln, w["w1"], w["b1"]))
    if "activation" in inspect.signature(lm.mlp_bwd).parameters:
        run("row9_mlp_block_stash_dino", lambda *a: lm.mlp_block_stash(*a, **gelu),
            (x, *mlp), bits=False)
        run("row19_mlp_bwd_dino", lambda *a: lm.mlp_bwd(*a, **gelu),
            (x, dy, w["b1"], w["w1"]), bits=False)
        run("row20_mlp_bwd_dw_dino", lambda *a: lm.mlp_bwd_dw(*a, **gelu),
            (x, g, w["b1"], w["w1"], w["w2"]), bits=False)
    print(json.dumps({"root": root, "gpu": cs._gpu_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
