#!/usr/bin/env python3
"""Time rows 4 and 8 of one checkout of ``uml_tpu_torch`` on the card, per
call and per launch:

* row 4, ``text_tower``: the CLIP text tower (S = 77, K = 512, 8 heads,
  M = 2048, 12 layers) at B = 1 (the main path's shape: ``features``
  encodes one class's prompts a call) and B = 64, and at the ViT-L/14
  text widths (K = 768, 12 heads, M = 3072) at B = 64;
* row 8, ``attn_block_cls_bwd``: the CLS-only attention backward at
  ViT-B/16 (B = 64, S = 197, K = 768, 12 heads) and at S = 785 (B = 16);
* the text encoder (``ClipEncoder.encode_texts``, random-init ViT-B/16)
  at 1 and 64 prompts: prompts/s with the host included, and the device's
  busy share.

Each kernel is graph-timed with ``chip_smoke.py``'s harness
(``_graph_time_ms``).  One call of each is profiled (torch.profiler): its
device events by name (count, microseconds), the span from the first
event's start to the last one's end, and the idle time inside that span
(the span less the union of the events), printed as ``[launches]`` lines.

Run it on two checkouts in one call to set a parent beside a change:

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_tower_cls.py --root build/parent
    python3 tools/exp_torch_tower_cls.py

Needs a CUDA card; prints one JSON line (ms per call, prompts/s, busy
shares, the card's name and power limit).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launches(what, fn):
    """Profile one call of ``fn`` -> {name: [count, us]}, span us, idle us."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cpu_names = {e.name for e in events if e.device_type != DeviceType.CUDA}

    def annotation(e):
        flag = getattr(e, "is_user_annotation", None)
        return e.name in cpu_names if flag is None else flag

    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not annotation(e) and e.time_range.end > e.time_range.start]
    by_name = {}
    for e in dev:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur = 0.0, None
    for s, t in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, t]
        else:
            cur[1] = max(cur[1], t)
    if cur is not None:
        busy += cur[1] - cur[0]
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    print(f"[launches] {what}: {len(dev)} device events, span {span:.1f} us, "
          f"busy {busy:.1f} us, idle {span - busy:.1f} us")
    for name, (count, us) in sorted(by_name.items(), key=lambda r: -r[1][1]):
        print(f"[launches]   x{count:<3d} {us:9.1f} us  {name[:110]}")
    return {"events": len(dev), "span_us": span, "busy_us": busy,
            "idle_us": span - busy,
            "by_name": {k[:110]: v for k, v in by_name.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose uml_tpu_torch is timed")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_tower_cls: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from uml_tpu_torch.models.encoders import ClipEncoder
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import text_tower as tt

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[card] {card}")
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"root": os.path.abspath(args.root), "card": card}

    def tower_case(b, k, heads, m):
        layers = [harness._block_weights(gen, k, m, k, dev) for _ in range(12)]
        tower = tuple(torch.stack([layer[n] for layer in layers]) for n in
                      ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
        x = torch.randn(b, 77, k, generator=gen, device=dev).to(bf)
        return (lambda *a: tt.text_tower(*a, heads=heads)), (x, *tower)

    def cls_case(b, s):
        wv = harness._block_weights(gen, 768, 3072, 768, dev)
        attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
        x = torch.randn(b, s, 768, generator=gen, device=dev).to(bf)
        g = torch.randn(b, 1, 768, generator=gen, device=dev).to(bf)
        _, qkv, _ = fa.attn_block_stash_plain(x, *attn_v, heads=12, q_rows=1)
        return ((lambda *a: fa.attn_block_cls_bwd(*a, heads=12)),
                (x, g, qkv, wv["w_eff"], wv["wo"]))

    cases = {"row 4 text_tower B=1": tower_case(1, 512, 8, 2048),
             "row 4 text_tower B=64": tower_case(64, 512, 8, 2048),
             "row 4 text_tower ViT-L/14 text B=64": tower_case(64, 768, 12, 3072),
             "row 8 attn_block_cls_bwd S=197": cls_case(64, 197),
             "row 8 attn_block_cls_bwd S=785": cls_case(16, 785)}
    for name, (fn, inputs) in cases.items():
        copies = harness._input_copies(inputs)
        out[name] = harness._graph_time_ms(fn, copies)
        print(f"[time] {name}: {out[name]:.4f} ms")
        del copies
        out[f"{name} launches"] = _launches(name, lambda fn=fn, inputs=inputs: fn(*inputs))
    del cases
    torch.cuda.empty_cache()

    encoder = ClipEncoder("ViT-B/16", allow_random_init=True)
    for n in (1, 64):
        prompts = [f"a photo of a class_{i}." for i in range(n)]
        ms = harness._time_ms(lambda: encoder.encode_texts(prompts), iters=20)
        out[f"text prompts/s bs{n}"] = n / (ms / 1e3)
        rows = harness._profile(f"text encoder, {n} prompts",
                                lambda: encoder.encode_texts(prompts), reps=10)
        busy_ms = sum(t for _, t, _ in rows) / 10 / 1e3
        out[f"text busy ms bs{n}"] = busy_ms
        out[f"text busy share bs{n}"] = busy_ms / ms
        print(f"[text] {n} prompts: {ms:.3f} ms a call, {out[f'text prompts/s bs{n}']:.1f} "
              f"prompts/s, device busy {busy_ms:.3f} ms ({100 * busy_ms / ms:.1f}%)")
    out["at"] = time.strftime("%Y-%m-%d %H:%M:%S")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
