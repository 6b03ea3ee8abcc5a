#!/usr/bin/env python3
"""Build variants of ``uml_tpu_torch/csrc/flash_attention.cu`` (the K/V
ring depth, the key tile at D = 64) side by side and time each in one
process, against the plain version and with ``chip_smoke.py``'s graph
harness, so the design choices of the kernel can be checked on a card:

    python3 tools/exp_torch_flash_variants.py

Each variant is the source with one text substitution, compiled with the
package's own nvcc flags into its own library under
``build/flash_variants/``.  Prints, per shape, each variant's max
|kernel - plain| / max |plain| and its time, in two rounds.  Needs a CUDA
card and nvcc.
"""

from __future__ import annotations

import ctypes
import importlib.util
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = "constexpr int FA_STAGES = 4;"
BK = "static constexpr int BK = D == 64 ? 128 : 64;"
VARIANTS = {
    "stages4 (as committed)": {},
    "stages3": {STAGES: "constexpr int FA_STAGES = 3;"},
    "stages2": {STAGES: "constexpr int FA_STAGES = 2;"},
    "bk64": {BK: "static constexpr int BK = 64;"},
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops.attention import attention_plain

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    with open(os.path.join(_build.CSRC, "flash_attention.cu")) as f:
        source = f.read()
    out_root = os.path.join(HERE, "build", "flash_variants")
    shutil.rmtree(out_root, ignore_errors=True)
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = source
        for old, new in subs.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        d = os.path.join(out_root, str(i))
        os.makedirs(d)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared",
               "-o", os.path.join(d, "lib.so"), os.path.join(d, "flash_attention.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    entries = {}
    for name, (d, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{report}")
        regs = [line.strip() for line in report.splitlines()
                if "registers" in line or "spill stores" in line]
        print(f"{name}: {' | '.join(regs)}", flush=True)
        fn = ctypes.CDLL(os.path.join(d, "lib.so")).uml_flash_attention
        fn.argtypes = _build.SIGNATURES["uml_flash_attention"]
        fn.restype = ctypes.c_int
        entries[name] = fn

    def call(fn, causal):
        def run(q, k, v):
            out = torch.empty_like(q)
            strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     *q.shape, int(causal), *strides,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"uml_flash_attention: cudaError_t {err}")
            return out
        return run

    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, causal in (((8, 16, 2048, 64), False), ((8, 16, 2048, 64), True),
                          ((64, 12, 197, 64), False), ((8, 8, 1024, 128), False)):
        qkv = tuple(torch.randn(*shape, generator=gen, device="cuda")
                    .to(torch.bfloat16) for _ in range(3))
        want = attention_plain(*qkv, causal=causal).float()
        copies = harness._input_copies(qkv)
        row = []
        for _ in range(2):
            for name, fn in entries.items():
                got = call(fn, causal)(*qkv).float()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                ms = harness._graph_time_ms(call(fn, causal), copies)
                row.append(f"{name} {ms:.4f} ms (rel {rel:.4f})")
        print(f"{list(shape)} causal={causal}: " + "; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
