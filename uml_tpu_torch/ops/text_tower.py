"""CLIP text tower: L causal pre-LN layers over stacked, LN-folded weights.

The port of uml_tpu/ops/text_tower.py::_tower_kernel.  On a CPU tensor
``text_tower`` runs the plain version (the per-layer plain half-blocks,
as the jnp twin ``text_tower_reference`` composes the per-layer twins); on
a CUDA tensor it launches ``csrc/text_tower.cu``, one C call that loops
over the layers and launches the causal attention half and the MLP half
of each, or raises; each layer's fused QKV + attention kernel (S <= 256)
counts on ``qkv_attention.launches`` too.  The residual is rounded to the activation dtype
between halves and between layers, as in the TPU kernel.

``TextTowerFn`` gives the tower a gradient as uml_tpu's custom_vjp does
(text_tower.py:246-264): the kernel forward, the backward by autograd
through ``text_tower_plain``, recomputed from the saved inputs.
``supports_text_tower`` is the shape gate of the model's UML_TEXT_TOWER
switch.

    w_eff [L,K,3*H*64], b_eff [L,3*H*64]  ln_1-folded QKV
    wo [L,H*64,K], bo [L,K]                attention out-projection
    w1 [L,K,M], b1 [L,M]                   ln_2-folded c_fc (M = 4K)
    w2 [L,M,K], b2 [L,K]                   c_proj
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp
from uml_tpu_torch.ops.fused_attention import (HEAD_DIM, attn_block_plain,
                                               qkv_attention, qkv_scratch)
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
        xn = torch.empty_like(x)
        qkv = qkv_scratch(b, s, hd, dev)
        attn = torch.empty((b * s, hd), dtype=bf16, device=dev)
        hidden = torch.empty((b * s, m), dtype=bf16, device=dev)
        mid = torch.empty_like(x)
        out = torch.empty_like(x)
        _build.launch("uml_text_tower", *map(_build.ptr, (
            x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, xn, qkv, attn, hidden,
            mid, out)), b, s, k, heads, m, layers, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    text_tower.launches += 1
    if qkv is None:
        qkv_attention.launches += layers
    return out


text_tower.launches = 0


def supports_text_tower(k: int, heads: int, head_dim: int, s: int,
                        m: int) -> bool:
    """What the tower's kernels take: head dim 64, K and M multiples of the
    64-wide GEMM tiles; any S (the attention streams K/V)."""
    return head_dim == HEAD_DIM and k % 64 == 0 and m % 64 == 0


class TextTowerFn(torch.autograd.Function):
    """text_tower with a gradient to x and every stacked weight."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, heads, eps):
        ctx.cfg = (heads, eps)
        ctx.save_for_backward(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2)
        return text_tower(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2,
                          heads=heads, eps=eps)

    @staticmethod
    def backward(ctx, g):
        heads, eps = ctx.cfg
        return (*plain_vjp(
            lambda *a: text_tower_plain(*a, heads=heads, eps=eps),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[:9]), None, None)
