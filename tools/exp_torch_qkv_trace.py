#!/usr/bin/env python3
"""Time the phases of the fused QKV + attention kernel
(``uml_tpu_torch/csrc/qkv_attention.cu``) inside one launch.

Copies this checkout's ``uml_tpu_torch`` to ``build/qkv_trace/``, adds
``%globaltimer`` stamps to the copy of the kernel (thread 0 of each
consumer warpgroup, the first two work items of every block), builds the
copy and runs the kernel at ViT-B/16 B=64 (bf16, bf16 with the stash,
int8).  Prints per item the mean over blocks and warpgroups of: the two
128-row QKV passes and their epilogues, the barrier before the attention,
the attention phase and the barrier after it; and, for each warpgroup's
first query tile, the score chain, the wait for its softmax turn, the
softmax and P V.  The stamps cost a few global stores per phase; the
graph-timed ms of the traced copy is printed beside them.

    python3 tools/exp_torch_qkv_trace.py      # on a machine with a card

The checkout itself is not modified.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DST = os.path.join(HERE, "build", "qkv_trace")

STAMPS = [
    # (anchor, text put before it, text put after it)
    ("namespace {\n\nconstexpr int QA_CONSUMERS",
     "__device__ unsigned long long qa_trace[132 * 2 * 32];\n"
     "static __device__ __forceinline__ unsigned long long gtime() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"
     "#define TR(slot) do { if ((tid & 127) == 0 && nitem < 2 && blockIdx.x < 132) "
     "qa_trace[(blockIdx.x * 2 + wg) * 32 + nitem * 16 + (slot)] = gtime(); } while (0)\n\n",
     ""),
    ("  for (int item = blockIdx.x; item < items; item += gridDim.x) {\n"
     "    const int b = item / a.H, h = item % a.H;\n    // the head's",
     "  int nitem = -1;\n", ""),
    ("    // the head's b_eff (and int8", "    ++nitem;\n    TR(0);\n", ""),
    ("        if (active) qkv_epilogue<Q8, 3>", "        TR(1 + 2 * c);\n", ""),
    ("      } else {\n        qkv_pass<Q8, 2>", "        TR(2 + 2 * c);\n", ""),
    ("    if (a.qkv != nullptr) {\n      // the stash", "    TR(5);\n", ""),
    ("      take_turn();\n\n", "      if (qt == wg) TR(11);\n", "      if (qt == wg) TR(8);\n"),
    ("      pass_turn(turn);\n      // O = P V", "      if (qt == wg) TR(9);\n", ""),
    ("      if (!live) continue;\n\n      // out = O", "      if (qt == wg) TR(10);\n", ""),
    ("    // both warpgroups are done with q, k, v", "    TR(6);\n", ""),
    ("  }\n}\n\ntemplate <bool Q8, int NC, bool CAUSAL>\ncudaError_t launch_qa",
     "    TR(7);\n", ""),
]


def _patch(src: str) -> str:
    for anchor, before, after in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"qkv_attention.cu changed: anchor {anchor!r} not found once")
        src = src.replace(anchor, before + anchor + after)
    return src + ('\nextern "C" int uml_qa_trace(void* out) {\n'
                  '  return (int)cudaMemcpyFromSymbol(out, qa_trace, sizeof(qa_trace));\n}\n')


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_qkv_trace: no CUDA device", file=sys.stderr)
        return 2
    shutil.rmtree(DST, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "uml_tpu_torch"), os.path.join(DST, "uml_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(DST, "uml_tpu_torch", "csrc", "qkv_attention.cu")
    with open(path) as f:
        src = _patch(f.read())
    with open(path, "w") as f:
        f.write(src)
    sys.path.insert(0, DST)
    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import quant as q8

    spec = importlib.util.spec_from_file_location("chip_smoke_harness",
                                                  os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)
    lib = _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(64, 197, 768, generator=gen, device=dev).to(torch.bfloat16)
    wv = harness._block_weights(gen, 768, 3072, 768, dev)
    q8v = harness._q8_case_weights(gen, 768, 3072, 768, dev)
    print(harness._gpu_line())
    buf = np.zeros(132 * 2 * 32, dtype=np.uint64)
    phases = ("QKV pass 0", "epilogue 0", "QKV pass 1", "epilogue 1", "barrier",
              "attention", "barrier after")
    for tag, fn in (
            ("bf16", lambda: fa.qkv_attention(x, wv["w_eff"], wv["b_eff"], heads=12)),
            ("bf16 stash", lambda: fa.qkv_attention(x, wv["w_eff"], wv["b_eff"], heads=12,
                                                    stash=True)),
            ("int8", lambda: q8.qkv_attention_q8(x, *q8v[:3], heads=12))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        lib.uml_qa_trace(ctypes.c_void_p(buf.ctypes.data))
        t = buf.reshape(132, 2, 2, 16).astype(np.int64)
        for item in range(2):
            a = t[:, :, item, :]
            d = np.diff(a[..., :8], axis=-1).mean(axis=(0, 1)) / 1e3
            print(f"[trace] {tag} item {item}: " + ", ".join(
                f"{p} {v:.2f} us" for p, v in zip(phases, d))
                  + f"; item {(a[..., 7] - a[..., 0]).mean() / 1e3:.2f} us")
            print(f"[trace] {tag} item {item}, first query tile: score chain "
                  f"{(a[..., 11] - a[..., 5]).mean() / 1e3:.2f} us, turn wait "
                  f"{(a[..., 8] - a[..., 11]).mean() / 1e3:.2f}, softmax "
                  f"{(a[..., 9] - a[..., 8]).mean() / 1e3:.2f}, P V "
                  f"{(a[..., 10] - a[..., 9]).mean() / 1e3:.2f}")
        print(f"[trace] {tag} traced copy graph-timed "
              f"{harness._graph_time_ms(lambda *_: fn(), [()]):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
