#!/usr/bin/env python3
"""Time the stand-alone ``layer_norm`` and ``flash_attention`` of one
checkout of ``uml_tpu_torch`` with ``chip_smoke.py``'s graph harness
(``_graph_time_ms``: calls captured in a CUDA graph over input copies
larger than the L2, no host work in the interval), beside the PyTorch
call that computes the same function.  Run it on two checkouts one after
the other on the same card to set an earlier commit's kernels beside the
current ones:

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_retime.py --root build/parent
    python3 tools/exp_torch_retime.py            # this checkout

Needs a CUDA card; prints one JSON line (milliseconds per call, and the
card's name and power limit).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose uml_tpu_torch is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_retime: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops.layer_norm import layer_norm

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    F = torch.nn.functional
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    scale = 1 + 0.1 * torch.randn(768, generator=gen, device=dev)
    bias = 0.1 * torch.randn(768, generator=gen, device=dev)
    scale_bf, bias_bf = scale.to(bf), bias.to(bf)

    def qkv(*shape):
        return tuple(torch.randn(*shape, generator=gen, device=dev).to(bf)
                     for _ in range(3))

    q197, q2048, q128 = qkv(64, 12, 197, 64), qkv(8, 16, 2048, 64), qkv(8, 8, 1024, 128)
    cases = {
        "layer_norm [64,197,768] bf16": (layer_norm, (x, scale, bias)),
        "F.layer_norm [64,197,768] bf16": (
            lambda t, *_: F.layer_norm(t, (768,), scale_bf, bias_bf), (x, scale, bias)),
        "layer_norm [64,197,768] fp32": (layer_norm, (x.float(), scale, bias)),
        "flash_attention [64,12,197,64]": (at.flash_attention, q197),
        "flash_attention [8,16,2048,64]": (at.flash_attention, q2048),
        "flash_attention [8,16,2048,64] causal": (
            lambda *a: at.flash_attention(*a, causal=True), q2048),
        "flash_attention [8,8,1024,128]": (at.flash_attention, q128),
        "sdpa [64,12,197,64]": (F.scaled_dot_product_attention, q197),
        "sdpa [8,16,2048,64]": (F.scaled_dot_product_attention, q2048),
    }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"card": card, "root": os.path.abspath(args.root)}
    for name, (fn, inputs) in cases.items():
        out[name] = harness._graph_time_ms(fn, harness._input_copies(inputs))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
