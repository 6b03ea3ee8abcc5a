#!/usr/bin/env python3
"""Time the work items of the one-launch text tower
(``uml_tpu_torch/csrc/text_tower.cu``) inside one launch.

Copies this checkout's ``uml_tpu_torch`` to ``build/tower_trace/``, adds
``%globaltimer`` stamps to the copy of the kernel, builds the copy and
runs the tower at the CLIP text widths (S = 77, K = 512, 8 heads, M =
2048, 12 layers) at B = 1 and B = 64.  Per item it stamps: the producer
starting the item, its stage's counter reached (the wait), the consumers
starting it, its first operands landed, its products (or LN rows, or
attention) done, and the item signalled.  Prints per stage (ln1, qkv,
attn, out, ln2, mlp_in, mlp_out) the mean of each phase over its items,
the consumers' idle time between items, each stage's span in three
layers, and the launch's span.  The copy's graph-timed ms is printed beside them.

    python3 tools/exp_torch_tower_trace.py      # on a machine with a card

The checkout itself is not modified.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DST = os.path.join(HERE, "build", "tower_trace")
MAX_ITEMS = 32768
STAMPS_PER_ITEM = 8

STAMPS = [
    # (anchor, text put before it, text put after it)
    ("namespace {\n\nusing bf16 = __nv_bfloat16;",
     f"__device__ unsigned long long tt_trace[{MAX_ITEMS} * {STAMPS_PER_ITEM}];\n"
     "static __device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     f"#define TR(slot) do {{ if (item < {MAX_ITEMS}) "
     f"tt_trace[item * {STAMPS_PER_ITEM} + (slot)] = gtime(); }} while (0)\n\n",
     ""),
    ("        if (l != pf_layer) {  // the next layer's", "        TR(0);\n", ""),
    ("        if (wait >= 0) tt_wait(a.counters + wait, f[TT_TARGET]);\n", "",
     "        TR(1);\n"),
    ("      if (op == OP_LN1 || op == OP_LN2) {\n        const int s = at % TT_ASTAGES;",
     "      if (tid == 0) TR(2);\n", ""),
    ("        ln_rows(op == OP_LN1 && l == 0", "        if (tid == 0) { TR(3); TR(4); }\n", ""),
    ("      } else if (op == OP_ATTN) {\n", "        if (tid == 0) TR(5);\n", ""),
    ("        const uint32_t sQ = sQKV[0], sK = sQKV[1], sV = sQKV[2];\n", "",
     "        if (tid == 0) { TR(3); TR(4); }\n"),
    ("        if (lane == 0)  // q, k, v are free\n", "        if (tid == 0) TR(5);\n", ""),
    ("          const uint32_t sa = aring + sa_ * TT_BOX + wg * 64 * 128;\n", "",
     "          if (tid == 0 && t == 0) { TR(3); TR(4); }\n"),
    ("        wgmma_wait<0>();\n        wgmma_fence_regs(acc);\n", "",
     "        if (tid == 0) TR(5);\n"),
    ("        atomicAdd(a.counters + f[TT_SIGNAL], 1);\n", "", "        TR(6);\n"),
]


def _patch(src: str) -> str:
    for anchor, before, after in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"text_tower.cu changed: anchor {anchor!r} not found once")
        src = src.replace(anchor, before + anchor + after)
    return src + ('\nextern "C" int uml_tt_trace(void* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, tt_trace, sizeof(tt_trace));\n}\n')


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_tower_trace: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(DST, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "uml_tpu_torch"), os.path.join(DST, "uml_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(DST, "uml_tpu_torch", "csrc", "text_tower.cu")
    with open(path) as f:
        src = _patch(f.read())
    with open(path, "w") as f:
        f.write(src)
    sys.path.insert(0, DST)
    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops import text_tower as tt

    spec = importlib.util.spec_from_file_location("chip_smoke_harness",
                                                  os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    lib = _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layers = [harness._block_weights(gen, 512, 2048, 512, dev) for _ in range(12)]
    tower = tuple(torch.stack([layer[n] for layer in layers]) for n in
                  ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
    print(harness._gpu_line())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = np.zeros(MAX_ITEMS * STAMPS_PER_ITEM, dtype=np.uint64)
    names = ("wait", "to consumers", "operands", "-", "compute", "epilogue + signal")
    for b in (1, 64):
        x = torch.randn(b, 77, 512, generator=gen, device=dev).to(torch.bfloat16)
        fn = lambda: tt.text_tower(x, *tower, heads=8)  # noqa: E731
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        buf[:] = 0
        lib.uml_tt_trace(ctypes.c_void_p(buf.ctypes.data))  # clear nothing: read after one call
        fn()
        torch.cuda.synchronize()
        lib.uml_tt_trace(ctypes.c_void_p(buf.ctypes.data))
        items, _, grid, _ = tt.tower_plan(b, 77, sms)
        n = len(items)
        t = buf.reshape(MAX_ITEMS, STAMPS_PER_ITEM)[:n, :7].astype(np.int64)
        t0 = t[:, 0].min()
        t = (t - t0) / 1e3  # us from the first stamp
        ops = np.array([it[0] for it in items])
        print(f"[trace] B={b}: {n} items on {grid} blocks, span {t[:, 6].max():.1f} us")
        for code, op in enumerate(tt.TOWER_OPS):
            sel = ops == code
            d = np.diff(t[sel], axis=1).mean(axis=0)
            print(f"[trace] B={b} {op:8s} x{sel.sum():5d}: " + ", ".join(
                f"{nm} {v:.2f}" for nm, v in zip(names, d))
                + f"; item {(t[sel, 6] - t[sel, 2]).mean():.2f} us")
        # the consumers' idle time between a block's items
        idle = []
        for blk in range(grid):
            mine = t[blk::grid]
            idle.append((mine[1:, 2] - mine[:-1, 6]).sum() if len(mine) > 1 else 0.0)
        print(f"[trace] B={b}: consumer idle between items, mean per block "
              f"{np.mean(idle):.1f} us of {t[:, 6].max():.1f}")
        # per layer: the span of each stage (first wait passed .. last signal)
        for l in (0, 1, 11):
            parts = []
            for code, op in enumerate(tt.TOWER_OPS):
                sel = np.array([it[0] == code and it[1] == l for it in items])
                parts.append(f"{op} {t[sel, 1].min():.1f}-{t[sel, 6].max():.1f}")
            print(f"[trace] B={b} layer {l}: " + ", ".join(parts))
        print(f"[trace] B={b} traced copy graph-timed "
              f"{harness._graph_time_ms(lambda *_: fn(), [()]):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
