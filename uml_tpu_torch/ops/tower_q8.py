"""Every full int8 (W8A8) layer of a tower in one call.

The port of uml_tpu/ops/tower_q8.py::_tower_q8_kernel, which runs all L
full (non-causal) int8 layers of the image tower in one Pallas program
with the residual stream resident in VMEM.  On a CPU tensor ``tower_q8``
runs ``tower_q8_plain``, the per-layer plain int8 halves composed over
the layers with the bf16 residual between halves and between layers
(tower_q8.py:83-86, 204-205); on a CUDA tensor it launches
``csrc/tower_q8.cu``, one C call that loops over the layers and makes the
same launches as ``attn_block_q8`` + ``mlp_block_q8``, so on the card its
output equals the per-layer int8 path bit for bit; each layer's int8
fused QKV + attention kernel (S <= 256) counts on
``qkv_attention_q8.launches`` too, the chain's flash_attention.cu (S >
256) on ``attention.flash_attention.launches``.  Inference-only.

Weights are stacked per layer, LN-folded and pre-quantized
(``quantize_weight`` on the fp32 folded weights, as the per-layer path
quantizes them):

    wq   int8 [L,K,3HD], wsc fp32 [L,3HD], b_eff fp32 [L,3HD]
    woq  int8 [L,HD,K],  wosc fp32 [L,K],  bo fp32 [L,K]
    w1q  int8 [L,K,M],   w1sc fp32 [L,M],  b1 fp32 [L,M]
    w2q  int8 [L,M,K],   w2sc fp32 [L,K],  b2 fp32 [L,K]

The kernels read each int8 weight K-major ([L, out, in]) as
``w.transpose(1, 2).contiguous()``, free for a transposed view of a
K-major stack (``models/clip.py::stacked_q8``), a copy otherwise.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.fused_attention import (HEAD_DIM, check_head_dim,
                                               count_attention,
                                               qkv_scratch)
from uml_tpu_torch.ops.quant import (attn_block_q8_plain, check_inference,
                                     mlp_block_q8_plain, mlp_q8_scratch,
                                     qkv_attention_q8)


def supports_tower_q8(k: int, heads: int, head_dim: int, s: int, m: int) -> bool:
    """The shapes the CUDA kernels take: head dim 64, widths a multiple of
    64; any S (the attention streams K/V)."""
    return (head_dim == HEAD_DIM and k % 64 == 0 and m % 64 == 0
            and heads * head_dim % 64 == 0)


def tower_q8_plain(x, wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc,
                   b2, *, heads: int, eps: float = 1e-5):
    for l in range(wq.shape[0]):
        x = attn_block_q8_plain(x, wq[l], wsc[l], b_eff[l], (woq[l], wosc[l]),
                                bo[l], heads=heads, eps=eps)
        x = mlp_block_q8_plain(x, w1q[l], w1sc[l], b1[l], w2q[l], w2sc[l],
                               b2[l], eps=eps)
    return x


def tower_q8(x, wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2, *,
             heads: int, eps: float = 1e-5):
    """x [B,S,K] bf16 through the L stacked int8 layers -> [B,S,K]."""
    check_inference("tower_q8", x, b_eff, bo, b1, b2)
    if x.device.type == "cpu":
        return tower_q8_plain(x, wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1,
                              w2q, w2sc, b2, heads=heads, eps=eps)
    b, s, k = x.shape
    layers, m = w1q.shape[0], w1q.shape[2]
    hd = heads * HEAD_DIM
    check_head_dim(wq.shape[-1], heads, "tower_q8 kernel")
    _build.check_dims(K=k, M=m)
    if layers < 1:
        raise ValueError("tower_q8 needs at least one layer")
    # the int8 weights K-major, [L, out, in]
    wq, woq, w1q, w2q = (t.transpose(1, 2).contiguous()
                         for t in (wq, woq, w1q, w2q))
    i8, f32, dev = torch.int8, torch.float32, x.device
    for name, t, dtype, shape in (
            ("x", x, torch.bfloat16, (b, s, k)),
            ("wq", wq, i8, (layers, 3 * hd, k)),
            ("wsc", wsc, f32, (layers, 3 * hd)),
            ("b_eff", b_eff, f32, (layers, 3 * hd)),
            ("woq", woq, i8, (layers, k, hd)),
            ("wosc", wosc, f32, (layers, k)),
            ("bo", bo, f32, (layers, k)),
            ("w1q", w1q, i8, (layers, m, k)),
            ("w1sc", w1sc, f32, (layers, m)),
            ("b1", b1, f32, (layers, m)),
            ("w2q", w2q, i8, (layers, k, m)),
            ("w2sc", w2sc, f32, (layers, k)),
            ("b2", b2, f32, (layers, k))):
        _build.check_tensor(name, t, dtype, shape, dev)
    rows = b * s
    with torch.cuda.device(dev):
        # the MLP half's scratch also serves the attention half's int8
        # rows ([rows, max(K, HD)] <= [rows, M + K]) and scales
        q8, qscale, rowmax = mlp_q8_scratch(rows, max(k, hd), m, dev)
        qkv = qkv_scratch(b, s, hd, dev)
        attn = torch.empty((rows, hd), dtype=f32, device=dev)
        mid = torch.empty_like(x)
        out = torch.empty_like(x)
        _build.launch("uml_tower_q8", *map(_build.ptr, (
            x, wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2,
            q8, qscale, qkv, attn, rowmax, mid, out)), b, s, k, heads, m, layers,
            eps, torch.cuda.current_stream(dev).cuda_stream)
    tower_q8.launches += 1
    count_attention(s, layers, fused_counter=qkv_attention_q8)
    return out


tower_q8.launches = 0
