"""CLIP text tower: L causal pre-LN layers over stacked, LN-folded weights.

The port of uml_tpu/ops/text_tower.py::_tower_kernel.  On a CPU tensor
``text_tower`` runs the plain version (the per-layer plain half-blocks,
as the jnp twin ``text_tower_reference`` composes the per-layer twins); on
a CUDA tensor it launches ``csrc/text_tower.cu``, one C call that loops
over the layers and launches the causal attention half and the MLP half
of each, or raises.  The residual is rounded to the activation dtype
between halves and between layers, as in the TPU kernel.

    w_eff [L,K,3*H*64], b_eff [L,3*H*64]  ln_1-folded QKV
    wo [L,H*64,K], bo [L,K]                attention out-projection
    w1 [L,K,M], b1 [L,M]                   ln_2-folded c_fc (M = 4K)
    w2 [L,M,K], b2 [L,K]                   c_proj
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.fused_attention import HEAD_DIM, MAX_SEQ, attn_block_plain
from uml_tpu_torch.ops.ln_matmul import mlp_block_plain


def text_tower_plain(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, *, heads: int,
                     eps: float = 1e-5):
    for l in range(w_eff.shape[0]):
        x = attn_block_plain(x, w_eff[l], b_eff[l], wo[l], bo[l], heads=heads,
                             causal=True, eps=eps)
        x = mlp_block_plain(x, w1[l], b1[l], w2[l], b2[l], eps=eps)
    return x


def text_tower(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, *, heads: int,
               eps: float = 1e-5):
    """x [B,S,K] bf16 through the L stacked layers -> [B,S,K]."""
    if x.device.type == "cpu":
        return text_tower_plain(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2,
                                heads=heads, eps=eps)
    b, s, k = x.shape
    layers, m = w1.shape[0], w1.shape[2]
    hd = heads * HEAD_DIM
    _build.check_dims(K=k, M=m)
    if layers < 1:
        raise ValueError("text_tower needs at least one layer")
    if s > MAX_SEQ:
        raise ValueError(f"S={s}: the attention kernel takes S <= {MAX_SEQ}")
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    for name, t, dtype, shape in (
            ("x", x, bf16, (b, s, k)),
            ("w_eff", w_eff, bf16, (layers, k, 3 * hd)),
            ("b_eff", b_eff, f32, (layers, 3 * hd)),
            ("wo", wo, bf16, (layers, hd, k)),
            ("bo", bo, f32, (layers, k)),
            ("w1", w1, bf16, (layers, k, m)),
            ("b1", b1, f32, (layers, m)),
            ("w2", w2, bf16, (layers, m, k)),
            ("b2", b2, f32, (layers, k))):
        _build.check_tensor(name, t, dtype, shape, dev)
    with torch.cuda.device(dev):
        qkv = torch.empty((b * s, 3 * hd), dtype=bf16, device=dev)
        attn = torch.empty((b * s, hd), dtype=bf16, device=dev)
        hidden = torch.empty((b * s, m), dtype=bf16, device=dev)
        mid = torch.empty_like(x)
        out = torch.empty_like(x)
        _build.launch("uml_text_tower", *(t.data_ptr() for t in (
            x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, qkv, attn, hidden, mid,
            out)), b, s, k, heads, m, layers, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    text_tower.launches += 1
    return out


text_tower.launches = 0
