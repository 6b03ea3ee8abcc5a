#!/usr/bin/env python3
"""Rows 11 and 12 of one checkout of ``uml_tpu_torch`` on the card (the
int8 MLP half and the 11-layer int8 tower at ViT-B/16, B = 64, S = 197),
and the int8 attention half's integer check on 8 draws:

* F6: the checkout's own ``chip_smoke.py::_int8_flips`` on 8 draws of the
  int8 case weights, each from a generator of its own (seeds 1000-1007),
  the input of ``chip_smoke.py`` phase 2: the share of activation
  integers that differ from the plain version's and the largest
  difference, for the attention output and the MLP hidden.  Beside it,
  the card's attention integers and row scales against two plain
  quantizations of the attention output, of the bf16 output
  (``attention_plain``) and of the fp32 one (the same P.V before its
  rounding): the share of rows whose scale differs, the integers 2 or
  more steps apart, and how many of those sit in a row whose scale
  differs.
* bits: the sha256 of the int8 hidden, its row scales and the MLP half's
  output (``_launch_mlp_block_q8``), and of the tower's output, on seeded
  inputs: equal digests on two checkouts, the same bits.
* per launch: one call of row 11 and one of row 12 profiled (the device
  events by name: count and microseconds, the span and its idle time).
* graph-timed (``chip_smoke.py``'s ``_graph_time_ms``): rows 10, 11, 12.
* end to end: the bf16, int8 and ``UML_TOWER_Q8=1`` image encoders' img/s
  at batch 64 (random-init ViT-B/16, a staged batch, host work included)
  and the peak device memory of one encode
  (``torch.cuda.max_memory_allocated``, and its rise over the memory held
  before the call); the bs-256 full-model train step under the default
  gate.

Run it on two checkouts in one call to set a parent beside a change:

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_q8_mlp.py --root build/parent
    python3 tools/exp_torch_q8_mlp.py

Needs a CUDA card; prints one JSON line (ms per call, img/s, bytes,
digests, the card's name and power limit).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAW_SEEDS = range(1000, 1008)


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(t):
    import torch

    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def _attn_out_diagnosis(q8, fa, x, q8v, eps=1e-5):
    """The card's attention-output integers and row scales (the int8 half's
    launcher) against the plain quantization of the bf16 and of the fp32
    attention output -> {plain form: numbers}."""
    import torch

    wq, wsc, b_eff, woq, wosc, bo = q8v[:6]
    b, s, _ = x.shape
    _, got_q, got_s = q8._launch_attn_block_q8(x, wq.t(), wsc, b_eff, (woq.t(), wosc),
                                               bo, 12, False, True, eps)
    xq, xs = q8.ln_quantize_rows(x.float(), eps)
    qkv = (q8.q8_dot(xq, xs, wq, wsc) + b_eff).to(torch.bfloat16)
    q, k, v = (t.float() for t in fa._qkv_heads(qkv, 12))
    sc = (q @ k.transpose(-1, -2)) * 64 ** -0.5
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    o32 = (e.to(torch.bfloat16).float() @ v) * (1.0 / e.sum(-1, keepdim=True))
    out = {}
    for form, attn in (("bf16", o32.to(torch.bfloat16).float()), ("fp32", o32)):
        want_q, want_s = q8.quantize_rows(attn.transpose(1, 2).reshape(b * s, -1))
        got = got_q[:want_q.numel()].view_as(want_q).int()
        diff = (got - want_q.int()).abs()
        row_moved = got_s[:b * s] != want_s[:, 0]
        far = diff >= 2
        out[form] = {"share_differing": (diff > 0).float().mean().item(),
                     "largest_difference": diff.max().item(),
                     "rows_whose_scale_differs": row_moved.float().mean().item(),
                     "integers_2_or_more_apart": int(far.sum().item()),
                     "of_them_in_rows_whose_scale_differs":
                         int((far & row_moved[:, None]).sum().item())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose uml_tpu_torch is measured")
    ap.add_argument("--skip-e2e", action="store_true",
                    help="leave out the encoders and the train step")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_q8_mlp: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from uml_tpu_torch.models.encoders import ClipEncoder
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import tower_q8 as tq8

    harness = _module("chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    own = _module("chip_smoke_root", os.path.join(root, "chip_smoke.py"))
    launches = _module("tower_cls", os.path.join(HERE, "tools",
                                                 "exp_torch_tower_cls.py"))._launches

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    out = {"root": root, "card": card}
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    b, s, k, m = 64, 197, 768, 3072
    rows = b * s
    x = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
    q8v = harness._q8_case_weights(gen, k, m, k, dev)
    q8_tower = harness._q8_case_weights(gen, k, m, k, dev, layers=11)

    # F6: the integer check on 8 draws, each from a generator of its own
    for seed in DRAW_SEEDS:
        w = harness._q8_case_weights(torch.Generator(device=dev).manual_seed(seed),
                                     k, m, k, dev)
        for half, (share, worst) in own._int8_flips(x, w).items():
            out[f"draw {seed} {half}"] = [share, worst]
            print(f"[f6] draw {seed} {half}: {100 * share:.4f}% differ, largest "
                  f"difference {worst}")
        for form, nums in _attn_out_diagnosis(q8, fa, x, w).items():
            out[f"draw {seed} attn_out vs plain {form}"] = nums
            print(f"[f6] draw {seed} card vs plain of the {form} attention: {nums}")
        del w

    # the bits of the int8 MLP half and of the tower
    w1q, w1sc, b1, w2q, w2sc, b2 = q8v[6:]
    mlp_out, hidden, hscale = q8._launch_mlp_block_q8(x, w1q.t(), w1sc, b1, w2q.t(),
                                                      w2sc, b2, 1e-5)
    out["sha256 int8 hidden"] = _digest(hidden[:rows * m])
    out["sha256 hidden row scales"] = _digest(hscale[:rows])
    out["sha256 mlp_block_q8 out"] = _digest(mlp_out)
    out["sha256 tower_q8 out"] = _digest(tq8.tower_q8(x, *q8_tower, heads=12))
    for key in ("sha256 int8 hidden", "sha256 hidden row scales",
                "sha256 mlp_block_q8 out", "sha256 tower_q8 out"):
        print(f"[bits] {key} {out[key]}")
    del mlp_out, hidden, hscale

    cases = {
        "row 10 attn_block_q8": (
            lambda x_, wq, wsc, be, wo_, wosc, bo: q8.attn_block_q8(
                x_, wq, wsc, be, (wo_, wosc), bo, heads=12), (x, *q8v[:6])),
        "row 11 mlp_block_q8": (q8.mlp_block_q8, (x, *q8v[6:])),
        "row 12 tower_q8": (lambda *a: tq8.tower_q8(*a, heads=12), (x, *q8_tower))}
    for name, (fn, inputs) in cases.items():
        copies = harness._input_copies(inputs)
        out[name] = harness._graph_time_ms(fn, copies)
        print(f"[time] {name}: {out[name]:.4f} ms")
        del copies
        out[f"{name} launches"] = launches(name, lambda fn=fn, inputs=inputs: fn(*inputs))
    del cases
    torch.cuda.empty_cache()
    if args.skip_e2e:
        print(json.dumps(out))
        return 0

    u8 = np.random.default_rng(0).integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
    for tag, quant, tower in (("bf16", "none", "0"), ("int8", "int8", "0"),
                              ("int8 UML_TOWER_Q8=1", "int8", "1")):
        encoder = ClipEncoder("ViT-B/16", allow_random_init=True, quant=quant)
        staged, n = encoder.stage_images(u8)
        os.environ["UML_TOWER_Q8"] = tower
        try:
            ms = harness._time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            encoder.encode_staged(staged, n)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            os.environ.pop("UML_TOWER_Q8")
        out[f"encoder img/s bs64 {tag}"] = b / (ms / 1e3)
        out[f"encoder peak bytes {tag}"] = peak
        out[f"encoder peak rise bytes {tag}"] = peak - held
        print(f"[e2e] image encoder {tag}: {out[f'encoder img/s bs64 {tag}']:.1f} img/s, "
              f"peak {peak / 2 ** 20:.1f} MiB ({(peak - held) / 2 ** 20:.1f} MiB above "
              f"the {held / 2 ** 20:.1f} held)")
        del encoder, staged
        torch.cuda.empty_cache()
    out.update(harness._train_step_rates(256, [
        ("gate_default", {"UML_MLP_BWD": "unset"}, None)]))
    out["at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
