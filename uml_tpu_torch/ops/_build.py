"""Build and load the hand-written Hopper kernels (``uml_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` into an object, one process per
source, all started together, and links them into one shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The build runs at first use, never at import, into
``build/uml_tpu_torch/<hash of the sources>/`` under the repository root;
a changed source gets a new directory, and a finished build is reused.
The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
is kept beside the library as ``build.log``.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                          "uml_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes; every function returns a cudaError_t as int
SIGNATURES = {
    # a, w0 table, w1 table (or null), offsets, c, groups, tiles, N, K,
    # swiglu, stream
    "uml_moe_gemm": [_P] * 5 + [_I] * 5 + [_P],
    # x, w_eff, b_eff, wo, bo, xn, qkv, attn, out, B, S, K, H, causal,
    # q_rows, eps, stream
    "uml_attn_block": [_P] * 9 + [_I] * 6 + [_F, _P],
    # x, w_eff, b_eff, wo, bo, xn, qkv, attn, out, B, S, K, H, causal, eps,
    # stream
    "uml_attn_block_stash": [_P] * 9 + [_I] * 5 + [_F, _P],
    # x, g, qkv, w_eff, wo, dattn, stats, dxn, dqkv, dx, xn, B, S, K, H,
    # causal, eps, stream
    "uml_attn_block_bwd": [_P] * 11 + [_I] * 5 + [_F, _P],
    # x, g, qkv, w_eff, wo, dattn, coef, proj, dqkv, dx, xn, B, S, K, H,
    # eps, stream
    "uml_attn_block_cls_bwd": [_P] * 11 + [_I] * 4 + [_F, _P],
    # x, g, w_eff, b_eff, wo, qkv, attn, dattn, stats, dxn, dqkv, dx, xn,
    # B, S, K, H, causal, eps, stream
    "uml_attn_block_bwd_recompute": [_P] * 13 + [_I] * 5 + [_F, _P],
    # x, dy, b1, w1, dpre, yact, dxn, dx_ln, xn, rows, K, M, act, eps,
    # stream
    "uml_mlp_bwd": [_P] * 9 + [_I] * 4 + [_F, _P],
    # x, g, b1, w1, w2, dy, dpre, yact, dxn, db1_part, dx, xn, dw1, db1,
    # dw2, rows, K, M, act, eps, stream
    "uml_mlp_bwd_dw": [_P] * 15 + [_I] * 4 + [_F, _P],
    # x, g, pre, w1, w2, dpre, yact, dxn, db1_part, dx, xn, dw1, db1, dw2,
    # rows, K, M, act, eps, stream
    "uml_mlp_bwd_stash": [_P] * 14 + [_I] * 4 + [_F, _P],
    # x, w1, b1, w2, b2, xn, hidden, out, rows, K, M, act, eps, stream
    "uml_mlp_block": [_P] * 8 + [_I] * 4 + [_F, _P],
    # x, w1, b1, w2, b2, pre, xn, hidden, out, rows, K, M, act, eps, stream
    "uml_mlp_block_stash": [_P] * 9 + [_I] * 4 + [_F, _P],
    # qkv, dattn, stats, dqkv, B, S, H, causal, passes, stream
    "uml_attn_bwd": [_P] * 4 + [_I] * 5 + [_P],
    # x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, xn, qkv, attn, hidden, mid,
    # out, plan, counters, partial, B, S, K, H, M, L, n_items, n_counters,
    # grid, bn, eps, stream
    "uml_text_tower": [_P] * 18 + [_I] * 10 + [_F, _P],
    # x, w_eff, b_eff, xn, qkv (or null), attn, B, S, K, H, causal, q_rows,
    # eps, stream
    "uml_qkv_attention": [_P] * 6 + [_I] * 6 + [_F, _P],
    # x, wq, wsc, b_eff, q8, qscale, attn, B, S, K, H, causal, eps, stream
    "uml_qkv_attention_q8": [_P] * 7 + [_I] * 5 + [_F, _P],
    # x, wq, wsc, b_eff, wo, wosc, bo, q8, qscale, qkv, attn, out, B, S, K,
    # H, causal, q8_out, eps, stream
    "uml_attn_block_q8": [_P] * 12 + [_I] * 6 + [_F, _P],
    # x, w1q, w1sc, b1, w2q, w2sc, b2, q8, qscale, rowmax, out, rows, K,
    # M, act, eps, stream
    "uml_mlp_block_q8": [_P] * 11 + [_I] * 4 + [_F, _P],
    # x, wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2, q8,
    # qscale, qkv, attn, rowmax, mid, out, B, S, K, H, M, L, eps, stream
    "uml_tower_q8": [_P] * 20 + [_I] * 6 + [_F, _P],
    # x, scale, bias, w, b, xn, out, rows, K, M, act, eps, stream
    "uml_ln_matmul": [_P] * 7 + [_I] * 4 + [_F, _P],
    # x, delta, scale, bias, w, b, xn, t, out, rows, K, M, act, eps, stream
    "uml_add_ln_matmul": [_P] * 9 + [_I] * 4 + [_F, _P],
    # x, scale, bias, w, b, xn, qkv, out, B, S, K, H, causal, eps, stream
    "uml_ln_qkv_attention": [_P] * 8 + [_I] * 5 + [_F, _P],
    # x, scale, bias, out, rows, K, is_f32, eps, stream
    "uml_layer_norm": [_P] * 4 + [_L, _I, _I, _F, _P],
    # a, w, bias, res, out, aux, colsum_part, xn, ln_scale, ln_bias, delta,
    # t, M, N, K, ldres, pro, epi, trans_b, eps, stream
    "uml_ln_gemm": [_P] * 12 + [_I] * 3 + [_L] + [_I] * 3 + [_F, _P],
    # a, b, c, ws, ws_floats, R, P, N, splits, stream
    "uml_gemm_at": [_P] * 4 + [_L] + [_I] * 4 + [_P],
    # a, w, row_scale, col_scale, bias, res, out, rowmax, qscale, M, N, K,
    # epi, stream
    "uml_q8_gemm": [_P] * 9 + [_I] * 4 + [_P],
    # q, k, v, out, B, H, S, D, causal, then the batch, head and row
    # strides of q, k, v and out (elements), stream
    "uml_flash_attention": [_P] * 4 + [_L, _I, _I, _I, _I] + [_L] * 12 + [_P],
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels of uml_tpu_torch build on a machine with the "
                       "CUDA toolkit")


def build() -> str:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  A failed compile raises with nvcc's messages."""
    out_dir = os.path.join(BUILD_ROOT, source_hash())
    lib_path = os.path.join(out_dir, "libuml_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    # build under temporary names and rename: a concurrent build never
    # loads a half-written library
    tmp_dir = tempfile.mkdtemp(dir=out_dir)
    nvcc = _nvcc()
    log = []
    procs = []
    for src in (p for p in _sources() if p.endswith(".cu")):
        obj = os.path.join(tmp_dir, os.path.basename(src) + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for cmd, _, proc in procs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        tmp_lib = os.path.join(tmp_dir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp_lib, *(obj for _, obj, _ in procs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stderr)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp_lib, lib_path)
    shutil.rmtree(tmp_dir, ignore_errors=True)
    return lib_path


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream's arguments; raise on
    a nonzero cudaError_t (a refused launch never runs, and a later
    synchronize would not report it)."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


def ptr(t):
    """A tensor's device pointer for a C entry point, or None (NULL) for a
    buffer the call does not take."""
    return None if t is None else t.data_ptr()


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what the C entry points assume of every pointer."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_dims(**dims: int) -> None:
    """The kernels tile the model width and the MLP width by 64."""
    for name, v in dims.items():
        if v % 64 != 0:
            raise ValueError(f"{name}={v}: the CUDA kernels need a multiple of 64")


def wants_kernel(impl: str, x) -> bool:
    """The ``impl`` knob of the stand-alone ops.  "pallas" (uml_tpu's name
    for the hand-written kernel) and "auto" on a CUDA tensor take the op's
    kernel wrapper, which launches or raises where the kernel does not take
    the shape or dtype: a tensor on the card never runs the plain version
    unasked.  "auto" on a CPU tensor, and any other value ("reference"),
    is the plain version."""
    return impl == "pallas" or (impl == "auto" and x.is_cuda)
