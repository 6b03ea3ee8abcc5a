"""The routed experts' grouped products of a MoE layer (``csrc/moe_gemm.cu``).

Replaces no TPU kernel (uml_tpu has no mixture of experts): it carries
``models/deepseek_v2.py``'s routed experts on the card in two launches a
layer, SwiGLU's gate and up products with the activation, then the down
product, each over every expert at once, the experts' row counts read on
the device.  ``moe_gemm_plain`` is the same arithmetic, one product a
projection an expert, sized by host counts; the CPU takes it.

``moe_gemm.launches`` counts the launches; ``moe_gemm.flops`` and
``moe_gemm.bytes`` the work the launches were given, from the shapes the
host holds (every expert's weights read once, the rows in and out once),
``moe_gemm.weight_bytes`` the weights' part of the bytes, the same in
every call; ``moe_gemm.tiles`` the row tiles of the launches' grids
(ceil(R / 64) + G each) and ``moe_gemm.groups`` their experts (G each),
so that a device trace's grids give the rows of the calls it holds.  The
benchmark's ``moe_gemm_roofline`` reads them.  ``moe_gemm_plain.launches``
counts the plain version's products.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from uml_tpu_torch.ops import _build

ROWS_A_TILE = 64        # the kernel's rows a block (csrc/moe_gemm.cu, MG_BM)
MAX_GROUPS = 256


def expert_table(weights) -> torch.Tensor:
    """The device array of the experts' weight pointers ([N, K] fp32,
    contiguous, 16-byte aligned each) that ``moe_gemm`` takes."""
    for w in weights:
        if w.dtype != torch.float32 or not w.is_contiguous() or w.data_ptr() % 16:
            raise ValueError(f"moe_gemm: an expert weight {w.dtype} {tuple(w.shape)} must be "
                             "contiguous float32 at a 16-byte aligned address")
    return torch.tensor([w.data_ptr() for w in weights], dtype=torch.int64,
                        device=weights[0].device)


def moe_gemm(a, offsets, table0, n: int, table1=None):
    """a [R, K] fp32 (rows sorted by expert, expert g's rows offsets[g] ..
    offsets[g + 1]), offsets [G + 1] int32 on the device, ``table0`` (and
    ``table1``) from ``expert_table`` of G weights [n, K] -> [R, n]:
    a w0_g^T, or with ``table1`` silu(a w0_g^T) * (a w1_g^T), row by row."""
    r, k = a.shape
    groups = table0.numel()
    swiglu = table1 is not None
    if a.device.type == "cpu":
        raise ValueError("moe_gemm: the kernel takes CUDA tensors (moe_gemm_plain on the CPU)")
    _build.check_tensor("a", a, torch.float32, (r, k), a.device)
    _build.check_tensor("offsets", offsets, torch.int32, (groups + 1,), a.device)
    if groups > MAX_GROUPS or k % 16 or n % (64 if swiglu else 128):
        raise ValueError(f"moe_gemm: {groups} experts, K={k}, N={n}: the kernel takes at most "
                         f"{MAX_GROUPS} experts, K a multiple of 16, N of "
                         f"{64 if swiglu else 128}")
    out = a.new_empty(r, n)
    tiles = (r + ROWS_A_TILE - 1) // ROWS_A_TILE + groups if r else 0
    with torch.cuda.device(a.device):
        _build.launch("uml_moe_gemm", a.data_ptr(), table0.data_ptr(),
                      _build.ptr(table1), offsets.data_ptr(), out.data_ptr(), groups, tiles,
                      n, k, int(swiglu), torch.cuda.current_stream(a.device).cuda_stream)
    products = 2 if swiglu else 1
    weight_bytes = 4.0 * groups * n * k * products
    moe_gemm.launches += 1
    moe_gemm.flops += 2.0 * r * n * k * products
    moe_gemm.bytes += weight_bytes + 4.0 * (r * k + r * n)
    moe_gemm.weight_bytes += weight_bytes
    moe_gemm.tiles += tiles
    moe_gemm.groups += groups
    return out


moe_gemm.launches = 0
moe_gemm.flops = 0.0
moe_gemm.bytes = 0.0
moe_gemm.weight_bytes = 0.0
moe_gemm.tiles = 0
moe_gemm.groups = 0


def moe_gemm_plain(a, sizes, weights0, weights1=None):
    """``moe_gemm`` with the experts' row counts ``sizes`` as host ints and
    the weights as tensors: one product a projection an expert, into its
    slice of one buffer; the SwiGLU on all rows at once."""
    n = weights0[0].shape[0]
    hit = [g for g, size in enumerate(sizes) if size]
    ins = a.split(sizes)
    first = a.new_empty(a.shape[0], n)
    parts = first.split(sizes)
    for g in hit:
        torch.mm(ins[g], weights0[g].t(), out=parts[g])
    moe_gemm_plain.launches += len(hit)
    if weights1 is None:
        return first
    second = torch.empty_like(first)
    parts = second.split(sizes)
    for g in hit:
        torch.mm(ins[g], weights1[g].t(), out=parts[g])
    moe_gemm_plain.launches += len(hit)
    return F.silu(first) * second


moe_gemm_plain.launches = 0
