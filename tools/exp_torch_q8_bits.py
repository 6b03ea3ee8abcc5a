#!/usr/bin/env python3
"""Row 11 (the int8 MLP half) of one checkout of ``uml_tpu_torch`` on the
card, by its bits and its time: do the quick_gelu and exact-GELU instances
of two checkouts compute the same, and how does the identity instance
(no activation, uml_tpu's default of ``ln_mlp_block_q8``) compare?

* CLIP ViT-B/16 at B = 64 (S = 197, K 768, M 3072), quick_gelu: the
  output of ``mlp_block_q8``, and its int8 hidden, row scales and
  LN-quantized rows read from the launch's scratch; the 2-layer
  ``tower_q8`` (rows 10 + 11 in one call).
* DINOv2-B/14 at B = 64 (S = 257, eps 1e-6), exact GELU: the same.
* Where the checkout takes it (``None`` in ``ops.quant.Q8_MLP_ACT``), the
  identity instance at the ViT-B/16 widths: its digests, its int8 hidden
  against the plain version's (integers apart, largest difference) and
  its output's max |kernel - plain| / max |plain|.

Each digest is the sha256 of the tensor's bytes (bf16 as its int16 bits):
equal digests on two checkouts, the same bits.  Each call graph-timed
with the checkout's own ``chip_smoke._graph_time_ms`` (up to 100 calls in
one CUDA graph over input copies > 2 x L2).  Inputs and int8 weights are
drawn from seeded generators on the card, the same on every checkout.

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_q8_bits.py --root build/parent
    python3 tools/exp_torch_q8_bits.py

Needs a CUDA card; prints ``[bits]``, ``[time]`` and ``[identity]`` lines
and one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
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
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import tower_q8 as tq8

    if not torch.cuda.is_available():
        print("exp_torch_q8_bits: no CUDA device", file=sys.stderr)
        return 2
    assert q8.__file__.startswith(root), (q8.__file__, root)
    _build.build()
    dev = torch.device("cuda")
    rows = {}

    def inputs(seed, s, layers=None):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(64, s, 768, generator=gen, device=dev).to(torch.bfloat16)
        return x, cs._q8_case_weights(gen, 768, 3072, 768, dev, layers=layers)

    def run(name, fn, args, scratch=None):
        out = fn(*args)
        torch.cuda.synchronize()
        outs = [out] + (list(scratch()) if scratch is not None else [])
        ms = cs._graph_time_ms(fn, cs._input_copies(args))
        rows[name] = {"ms": ms, "sha256": [_digest(t) for t in outs]}
        print(f"[bits] {name}: " + " ".join(d[:16] for d in rows[name]["sha256"]))
        print(f"[time] {name}: {ms:.4f} ms")
        return out

    def hidden(x, w, eps, act):
        w1q, w1sc, b1, w2q, w2sc, b2 = w[6:]
        return lambda: q8._launch_mlp_block_q8(x, w1q.t(), w1sc, b1, w2q.t(), w2sc, b2,
                                               eps, act)[1:]

    x, w = inputs(0, 197)
    run("row11_quick_gelu_clip", lambda *a: q8.mlp_block_q8(*a), (x, *w[6:]),
        hidden(x, w, 1e-5, "quick_gelu"))
    xd, wd = inputs(1, 257)
    gelu = dict(eps=1e-6, activation="gelu_exact")
    run("row11_gelu_exact_dino", lambda *a: q8.mlp_block_q8(*a, **gelu), (xd, *wd[6:]),
        hidden(xd, wd, 1e-6, "gelu_exact"))
    xt, wt = inputs(2, 197, layers=2)
    run("row12_tower_q8_2_layers", lambda *a: tq8.tower_q8(*a, heads=12), (xt, *wt))

    if None in getattr(q8, "Q8_MLP_ACT", {}):
        ident = dict(activation=None)
        got = run("row11_identity_clip", lambda *a: q8.mlp_block_q8(*a, **ident),
                  (x, *w[6:]), hidden(x, w, 1e-5, None))
        want = q8.mlp_block_q8_plain(x, *w[6:], **ident)
        w1q, w1sc, b1 = w[6:9]
        hq = q8._launch_mlp_block_q8(x, w1q.t(), w1sc, b1, w[9].t(), w[10], w[11],
                                     1e-5, None)[1]
        xq, xs = q8.ln_quantize_rows(x.float().reshape(-1, 768), 1e-5)
        want_q = q8.quantize_rows(q8.q8_dot(xq, xs, w1q, w1sc) + b1)[0]
        torch.cuda.synchronize()
        diff = (hq[:want_q.numel()].view_as(want_q).int() - want_q.int()).abs()
        err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
        rows["row11_identity_clip"].update(
            int_differ=float((diff > 0).float().mean()), int_max_diff=int(diff.max()),
            rel_err=err, plain_ms=cs._time_ms(
                lambda: q8.mlp_block_q8_plain(x, *w[6:], **ident), iters=5, warmup=1))
        print(f"[identity] int8 hidden vs plain: {rows['row11_identity_clip']['int_differ']:.2e}"
              f" of the integers differ, largest difference {int(diff.max())}; output "
              f"max |kernel - plain| / max |plain| {err:.5f}")
    print(json.dumps({"root": root, "gpu": cs._gpu_line(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
