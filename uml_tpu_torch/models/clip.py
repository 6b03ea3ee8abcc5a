"""CLIP in PyTorch: image tower on uint8 pixels, causal text tower.

The port of uml_tpu/models/clip.py: the ViT configs here, the RN50 /
RN101 image towers in models/clip_resnet.py behind ``ClipResNetModel``
(the same text tower).  Parameter names and shapes follow
the OpenAI CLIP state_dict schema (``visual.conv1.weight``,
``visual.transformer.resblocks.0.attn.in_proj_weight``, ...), the schema
that uml_tpu/models/port_torch.py reads, so an OpenAI ``.pt`` loads as is.

Parameters are kept in fp32; the forward runs in the model's compute
``dtype`` (bf16 for serving) through the ops of ``uml_tpu_torch.ops``:

* image tower: uint8 patch embedding with the normalization folded in,
  class token + positional embedding, ``ln_pre``, L-1 full layers
  (attn_block + mlp_block), a last layer that keeps only the CLS row
  (attn_block_cls + mlp_block), ``ln_post`` and ``proj``
  (clip.py:460-525); ``return_tokens`` runs every layer in full and
  returns all tokens;
* text tower: token + positional embedding, the causal layers (all
  through text_tower under the ``UML_TEXT_TOWER`` gate, else one by one),
  the EOT row (argmax of the token ids) pooled BEFORE ``ln_final``
  (clip.py:556-574), ``text_projection``.

``attn_impl`` / ``ln_matmul_impl`` (uml_tpu's knobs, clip.py:272,
:305-334) pick a layer's route: ``attn_impl`` "auto" or "fused" with
``ln_matmul_impl`` anything but "reference" is the fused half-block path
above; anything else takes the non-fused branch: ``ln_matmul`` for the
QKV product, the attention ``attn_impl`` names ("dense_bshd", "pallas" =
the streaming kernel, "reference" and any other value = the plain dense
attention), a plain out-projection, ``add_ln_matmul`` for the residual
add, ln_2, c_fc and the QuickGELU, a plain c_proj; ``ln_matmul_impl`` is
the ``impl`` of those two ops (on the card "auto" is their kernels, which
take bf16: an fp32 non-fused model raises there rather than run the plain
versions unasked, as the fused path does).  Both branches declare the same
parameters, and both train: the non-fused ops' backwards differentiate
their plain versions.

Training (the full-model finetune): when autograd needs a gradient
(grad mode on and a parameter that requires one), the image tower derives
the LN-folded weights with autograd on every call, and each layer runs
through the autograd Functions of the ops (AttnBlockFn, AttnBlockClsFn,
MlpBlockFn), so the gradient reaches every parameter of the tower: patch
embedding, class and positional embeddings, ln_pre, the layers, ln_post
and proj.  Which kernels a layer runs is the ops' choice, under uml_tpu's
switches: by default the stash forwards and the backwards from their
stashes; with UML_BWD_STASH=0 the full attention halves run the
inference forward and the recompute backward; with the MLP stash off
(UML_MLP_STASH=0, or the memory gate from ViT-B/16 batch 212 up) the MLP
halves run the inference forward and the backward UML_MLP_BWD picks
(kernel, dw, or any other value the plain twin's VJP; unset, kernel on
the card and the plain VJP on the CPU); the CLS layer always keeps the
qkv its forward computed.  The towers have no dropout or BatchNorm, so
``model.train()`` and ``model.eval()`` compute the same; freezing is
``requires_grad_(False)``.

Inference (``torch.no_grad()``, or frozen parameters): the folded,
compute-dtype weights are derived once and cached; the cache is keyed on
every source parameter's storage and version counter, so loading a
state_dict, an optimizer step or moving the model rebuilds it.

The text tower gate (``Transformer._use_tower``, clip.py:440-457):
``UML_TEXT_TOWER=0`` runs the text layers one by one, "1" through
text_tower wherever the shapes allow, "auto" (the default) through
text_tower on the card only.  Under autograd the tower runs through
``TextTowerFn`` (the kernel forward, the backward through the plain
tower, as uml_tpu's custom_vjp), the per-layer route through the
half-blocks' Functions.

Int8 serving (``quant``, clip.py:204-263, 351-438): ``int8`` runs both
half-blocks of every full layer W8A8 (ops.quant), ``int8_mlp`` /
``int8_attn`` one half with the other bf16, ``int8_qkv`` the int8 MLP and
an attention half whose out-projection stays bf16.  The last image layer
(CLS row only), ``ln_post`` and ``proj`` stay bf16 in every mode.  The
text tower runs per layer, causal, through the same halves (never
text_tower).  The int8 path folds the LN into the fp32 QKV and c_fc
weights and quantizes those; out_proj and c_proj are cast to the compute
dtype first (clip.py:192-199, 234-257); the quantized weights are cached
like the folded ones, K-major ([out, in], the layout the card's int8
GEMM reads) and handed to the ops as [in, out] views, so no call
transposes them.  ``UML_TOWER_Q8=1`` runs the L-1 full int8 image
layers through tower_q8 in one call ("0" and "auto": per layer, as
uml_tpu's gate has it).  Inference-only: a quant mode raises when autograd
would want a gradient.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from uml_tpu_torch.ops.attention import (dense_attention_bshd,
                                         multi_head_attention)
from uml_tpu_torch.ops.fused_attention import (AttnBlockClsFn, AttnBlockFn,
                                               attn_block, attn_block_cls,
                                               attn_block_plain,
                                               fold_ln_into_matmul)
from uml_tpu_torch.ops.ln_matmul import (MlpBlockFn, add_ln_matmul, ln_matmul,
                                         mlp_block, mlp_block_plain,
                                         raw_layer_norm)
from uml_tpu_torch.ops.patch_embed import patch_embed_u8
from uml_tpu_torch.ops.quant import (attn_block_q8, attn_block_q8_plain,
                                     check_inference, mlp_block_q8,
                                     mlp_block_q8_plain, quantize_weight)
from uml_tpu_torch.ops.text_tower import (TextTowerFn, supports_text_tower,
                                          text_tower)
from uml_tpu_torch.ops.tower_q8 import supports_tower_q8, tower_q8

# which half-blocks run W8A8 in each serving mode (clip.py:209-212):
# "attn_qkv" is the int8 QKV with a bf16 out-projection (q8_out=False)
Q8_HALVES = {"none": (), "int8": ("attn", "mlp"), "int8_mlp": ("mlp",),
             "int8_attn": ("attn",), "int8_qkv": ("attn_qkv", "mlp")}


@dataclass(frozen=True)
class ClipConfig:
    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_patch_size: int
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12

    @property
    def vision_heads(self) -> int:
        return self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


CLIP_CONFIGS = {
    "ViT-B/16": ClipConfig(512, 224, 12, 768, 16),
    "ViT-B/32": ClipConfig(512, 224, 12, 768, 32),
    "ViT-L/14": ClipConfig(768, 224, 24, 1024, 14,
                           transformer_width=768, transformer_heads=12),
}


def layer_norm_fp32(x, weight, bias, eps: float = 1e-5):
    """LayerNorm with fp32 statistics, cast back to x's dtype
    (uml_tpu FP32LayerNorm)."""
    y = raw_layer_norm(x.float(), eps) * weight.float() + bias.float()
    return y.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x):
        return layer_norm_fp32(x, self.weight, self.bias)


class Linear(nn.Module):
    """Weight [out, in] + bias [out], the torch Linear layout of the
    OpenAI schema; only a parameter holder (the ops read the weights)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))


class MultiheadAttention(nn.Module):
    """Parameter names of torch nn.MultiheadAttention (packed in_proj)."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)


def _needs_grad(*tensors) -> bool:
    """Autograd will want a gradient through these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _Cached:
    """One derived value, rebuilt when any source parameter was replaced
    (storage) or modified in place (version counter), or the dtype
    changed.  For the inference path only: the value carries no autograd
    history."""

    def __init__(self):
        self._key = None
        self._value = None

    def get(self, params, dtype, fn):
        key = (dtype, tuple((p.data_ptr(), p._version) for p in params))
        if key != self._key:
            with torch.no_grad():
                self._value = fn()
            self._key = key
        return self._value


def _in_out(q8_weights):
    """The cached int8 weights, K-major, as [in, out] views: the layout the
    int8 ops take, which the card's kernels read in place."""
    return tuple(t.transpose(-2, -1) if t.dtype == torch.int8 else t
                 for t in q8_weights)


def _is_fused(attn_impl: str, ln_matmul_impl: str) -> bool:
    """The half-block kernels run the layers (clip.py:272); otherwise the
    non-fused branch does."""
    return attn_impl in ("auto", "fused") and ln_matmul_impl != "reference"


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, attn_impl: str = "auto",
                 ln_matmul_impl: str = "auto"):
        super().__init__()
        self.heads = heads
        self.attn_impl = attn_impl
        self.ln_matmul_impl = ln_matmul_impl
        self.fused = _is_fused(attn_impl, ln_matmul_impl)
        self.attn = MultiheadAttention(width)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)
        self._folded = _Cached()
        self._q8 = _Cached()
        self._cast = _Cached()

    def _fold(self, dtype):
        w_eff, b_eff = fold_ln_into_matmul(
            self.ln_1.weight, self.ln_1.bias,
            self.attn.in_proj_weight.to(dtype).t(), self.attn.in_proj_bias)
        w1_eff, b1_eff = fold_ln_into_matmul(
            self.ln_2.weight, self.ln_2.bias,
            self.mlp.c_fc.weight.to(dtype).t(), self.mlp.c_fc.bias)
        return (w_eff.contiguous(), b_eff,
                self.attn.out_proj.weight.to(dtype).t().contiguous(),
                self.attn.out_proj.bias.float(),
                w1_eff.contiguous(), b1_eff,
                self.mlp.c_proj.weight.to(dtype).t().contiguous(),
                self.mlp.c_proj.bias.float())

    def folded(self, dtype):
        """(w_eff, b_eff, wo, bo, w1_eff, b1_eff, w2, b2): weights in the
        JAX [in, out] layout, cast to ``dtype`` before the fold as uml_tpu
        does (clip.py:192-199), biases fp32.  With autograd (training)
        they are derived anew, with a gradient to the parameters;
        otherwise from the cache."""
        params = list(self.parameters())
        if _needs_grad(*params):
            return self._fold(dtype)
        return self._folded.get(params, dtype, lambda: self._fold(dtype))

    def _quantize(self, dtype):
        """The int8 path's weights: the LN folded into the fp32 QKV and
        c_fc weights, out_proj and c_proj cast to ``dtype``, each
        quantized per output column (quant.py:480-535)."""
        w_eff, b_eff = fold_ln_into_matmul(
            self.ln_1.weight, self.ln_1.bias, self.attn.in_proj_weight.t(),
            self.attn.in_proj_bias)
        w1_eff, b1_eff = fold_ln_into_matmul(
            self.ln_2.weight, self.ln_2.bias, self.mlp.c_fc.weight.t(),
            self.mlp.c_fc.bias)
        quantized = (quantize_weight(w_eff)
                     + quantize_weight(self.attn.out_proj.weight.to(dtype).t())
                     + quantize_weight(w1_eff)
                     + quantize_weight(self.mlp.c_proj.weight.to(dtype).t()))
        # each int8 weight stored once K-major, the scales as they are
        wq, wsc, woq, wosc, w1q, w1sc, w2q, w2sc = (
            t.t().contiguous() if t.dtype == torch.int8 else t for t in quantized)
        return (wq, wsc, b_eff, woq, wosc, self.attn.out_proj.bias.float(),
                w1q, w1sc, b1_eff, w2q, w2sc, self.mlp.c_proj.bias.float())

    def quantized(self, dtype):
        """(wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2):
        int8 weights K-major ([out, in]: ``quantize_weight(w)[0].t()`` of
        the [in, out] weight) with fp32 column scales, fp32 biases;
        cached, and inference-only."""
        params = list(self.parameters())
        check_inference("the int8 serving modes", *params)
        return self._q8.get(params, dtype, lambda: self._quantize(dtype))

    def _forward_q8(self, x, causal: bool, halves):
        """A full layer with the int8 halves of ``halves`` (Q8_HALVES); the
        other half, and the bf16 out-projection of int8_qkv, run on the
        bf16 folded weights.  "reference" on either impl knob is the
        caller's request for the plain math (clip.py:225-227): every half
        then runs its plain version, wherever the tensor lies."""
        (wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc,
         b2) = _in_out(self.quantized(x.dtype))
        folded = None if halves == Q8_HALVES["int8"] else self.folded(x.dtype)
        plain = "reference" in (self.attn_impl, self.ln_matmul_impl)
        attn_q8, attn, mlp_q8, mlp = (
            (attn_block_q8_plain, attn_block_plain, mlp_block_q8_plain,
             mlp_block_plain) if plain else
            (attn_block_q8, attn_block, mlp_block_q8, mlp_block))
        if "attn" in halves:
            x = attn_q8(x, wq, wsc, b_eff, (woq, wosc), bo,
                        heads=self.heads, causal=causal)
        elif "attn_qkv" in halves:
            wo = folded[2].to(torch.bfloat16)  # bf16 whatever the dtype
            x = attn_q8(x, wq, wsc, b_eff, (wo,), bo,
                        heads=self.heads, causal=causal, q8_out=False)
        else:
            x = attn(x, *folded[:4], heads=self.heads, causal=causal)
        if "mlp" in halves:
            return mlp_q8(x, w1q, w1sc, b1, w2q, w2sc, b2)
        return mlp(x, *folded[4:])

    def _cast_weights(self, dtype):
        return (self.attn.in_proj_weight.to(dtype).t().contiguous(),
                self.attn.out_proj.weight.to(dtype),
                self.attn.out_proj.bias.to(dtype),
                self.mlp.c_fc.weight.to(dtype).t().contiguous(),
                self.mlp.c_proj.weight.to(dtype),
                self.mlp.c_proj.bias.to(dtype))

    def cast_weights(self, dtype):
        """(wqkv [K, 3K], wo [K, K], bo, w1 [K, 4K], w2 [K, 4K], b2) in
        ``dtype`` for the non-fused branch: the QKV and c_fc weights in the
        JAX [in, out] layout the ops take, out_proj and c_proj as torch
        keeps them ([out, in], for F.linear).  Cached like ``folded``."""
        params = list(self.parameters())
        if _needs_grad(*params):
            return self._cast_weights(dtype)
        return self._cast.get(params, dtype, lambda: self._cast_weights(dtype))

    def _forward_unfused(self, x, cls_only: bool, causal: bool):
        """The non-fused branch (clip.py:305-334): ln_matmul for the QKV
        product, the attention ``attn_impl`` names ("dense_bshd" the
        layout-preserving dense one, "pallas" the streaming kernel,
        anything else multi_head_attention's choice), a plain
        out-projection, add_ln_matmul for the residual, ln_2, c_fc and
        the QuickGELU, a plain c_proj.  ``cls_only`` computes the whole
        layer and keeps row 0."""
        wqkv, wo, bo, w1, w2, b2 = self.cast_weights(x.dtype)
        b, s, width = x.shape
        h = self.heads
        qkv = ln_matmul(x, self.ln_1.weight, self.ln_1.bias, wqkv,
                        self.attn.in_proj_bias, impl=self.ln_matmul_impl)
        qkv = qkv.reshape(b, s, 3, h, width // h)
        if self.attn_impl == "dense_bshd":
            attn = dense_attention_bshd(qkv[:, :, 0], qkv[:, :, 1],
                                        qkv[:, :, 2], causal=causal)
        else:
            q, k, v = qkv.permute(2, 0, 3, 1, 4)
            attn = multi_head_attention(q, k, v, causal=causal,
                                        impl=self.attn_impl).transpose(1, 2)
        delta = F.linear(attn.reshape(b, s, width), wo, bo)
        x, y = add_ln_matmul(x, delta, self.ln_2.weight, self.ln_2.bias, w1,
                             self.mlp.c_fc.bias, gelu=True,
                             impl=self.ln_matmul_impl)
        out = x + F.linear(y, w2, b2)
        return out[:, :1] if cls_only else out

    def forward(self, x, cls_only: bool = False, causal: bool = False,
                quant: str = "none"):
        """One layer.  ``cls_only``: the attention half keeps only the
        CLS row, so the output is [B, 1, K] (row 0 of the full layer).
        ``causal``: the text tower's mask (the per-layer text routes).
        ``quant``: a serving mode of Q8_HALVES for a full layer; the CLS
        layer stays bf16."""
        if Q8_HALVES[quant] and not cls_only:
            return self._forward_q8(x, causal, Q8_HALVES[quant])
        if not self.fused:
            return self._forward_unfused(x, cls_only, causal)
        w_eff, b_eff, wo, bo, w1, b1, w2, b2 = self.folded(x.dtype)
        if _needs_grad(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2):
            if cls_only:
                x = AttnBlockClsFn.apply(x, w_eff, b_eff, wo, bo, self.heads,
                                         1e-5)
            else:
                x = AttnBlockFn.apply(x, w_eff, b_eff, wo, bo, self.heads,
                                      causal, 1e-5)
            return MlpBlockFn.apply(x, w1, b1, w2, b2, 1e-5)
        if cls_only:
            x = attn_block_cls(x, w_eff, b_eff, wo, bo, heads=self.heads)
        else:
            x = attn_block(x, w_eff, b_eff, wo, bo, heads=self.heads,
                           causal=causal)
        return mlp_block(x, w1, b1, w2, b2)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 attn_impl: str = "auto", ln_matmul_impl: str = "auto"):
        super().__init__()
        self.heads = heads
        self.fused = _is_fused(attn_impl, ln_matmul_impl)
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, attn_impl, ln_matmul_impl)
             for _ in range(layers)])
        self._stacked = _Cached()
        self._stacked_q8 = _Cached()

    def forward(self, x, cls_only_last: bool = False, causal: bool = False,
                quant: str = "none"):
        """The per-layer path, or tower_q8 over the full int8 layers under
        ``UML_TOWER_Q8=1``, or text_tower over every layer of a causal
        tower under the ``UML_TEXT_TOWER`` gate."""
        last = len(self.resblocks) - 1
        if self._use_tower_q8(x, causal, cls_only_last, quant):
            n_full = len(self.resblocks) - (1 if cls_only_last else 0)
            x = tower_q8(x, *_in_out(self.stacked_q8(x.dtype, n_full)),
                         heads=self.heads)
            if cls_only_last:
                x = self.resblocks[last](x, cls_only=True)
            return x
        if self._use_tower(x, causal, cls_only_last, quant):
            stacked = self.stacked(x.dtype)
            if _needs_grad(x, *stacked):
                return TextTowerFn.apply(x, *stacked, self.heads, 1e-5)
            return text_tower(x, *stacked, heads=self.heads)
        for i, block in enumerate(self.resblocks):
            x = block(x, cls_only=cls_only_last and i == last, causal=causal,
                      quant=quant)
        return x

    def _use_tower_q8(self, x, causal, cls_only_last, quant) -> bool:
        """uml_tpu's UML_TOWER_Q8 gate (clip.py:411-438): "1" runs the
        tower when the mode is int8, the tower non-causal, a full layer
        exists and the kernels take the shape; "0" and "auto" (the
        default) keep the per-layer path."""
        if os.environ.get("UML_TOWER_Q8", "auto") != "1":
            return False
        width = x.shape[-1]
        return (not causal and quant == "int8" and self.fused and x.ndim == 3
                and len(self.resblocks) > (1 if cls_only_last else 0)
                and supports_tower_q8(width, self.heads, width // self.heads,
                                      x.shape[1], 4 * width))

    def _use_tower(self, x, causal, cls_only_last, quant) -> bool:
        """uml_tpu's UML_TEXT_TOWER gate (clip.py:440-457): "0" keeps the
        per-layer path; "1" runs text_tower when the tower is causal, every
        layer full, no quant mode, the fused path selected and the kernels
        take the shape; "auto" (the default) also wants the tensor on the
        card (on the CPU the per-layer plain halves compute the same)."""
        env = os.environ.get("UML_TEXT_TOWER", "auto")
        if env == "0":
            return False
        width = x.shape[-1]
        ok = (causal and not cls_only_last and quant == "none" and self.fused
              and x.ndim == 3
              and supports_text_tower(width, self.heads, width // self.heads,
                                      x.shape[1], 4 * width))
        return ok if env == "1" else ok and x.is_cuda

    def stacked_q8(self, dtype, n_layers: int):
        """The first ``n_layers`` layers' int8 weights (K-major, as
        ``quantized`` holds them) stacked on a leading layer axis — the
        operands of tower_q8 (cached)."""
        def build():
            per_layer = [b.quantized(dtype) for b in self.resblocks[:n_layers]]
            return tuple(torch.stack(t) for t in zip(*per_layer))
        params = list(self.parameters())
        check_inference("the int8 serving modes", *params)
        return self._stacked_q8.get(params, (dtype, n_layers), build)

    def stacked(self, dtype):
        """Every layer's folded weights stacked on a leading layer axis —
        the operands of text_tower.  With autograd they are derived anew,
        with a gradient to the parameters; otherwise from the cache."""
        def build():
            per_layer = [b.folded(dtype) for b in self.resblocks]
            return tuple(torch.stack(t) for t in zip(*per_layer))
        params = list(self.parameters())
        if _needs_grad(*params):
            return build()
        return self._stacked.get(params, dtype, build)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig, attn_impl: str = "auto",
                 ln_matmul_impl: str = "auto"):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(torch.empty(w, 3, p, p))
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.grid_size ** 2 + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads,
                                       attn_impl, ln_matmul_impl)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images_u8, dtype, return_tokens: bool = False,
                quant: str = "none"):
        """uint8 [B, H*W*3] (flat) or [B, H, W, 3] -> features [B, E] fp32,
        or with ``return_tokens`` all tokens [B, g*g+1, W] in ``dtype``."""
        cfg = self.cfg
        b = images_u8.shape[0]
        r = cfg.image_resolution
        pixels = images_u8.reshape(b, r, r, 3)
        kernel = self.conv1.weight.permute(2, 3, 1, 0)   # OIHW -> HWIO
        x = patch_embed_u8(pixels, kernel, dtype=dtype)
        cls = self.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        x = self.transformer(x, cls_only_last=not return_tokens, quant=quant)
        if return_tokens:
            return x
        x = self.ln_post(x[:, 0])
        return (x.float() @ self.proj.to(dtype).float()).to(dtype).float()


class CLIP(nn.Module):
    """Image tower ``visual`` + the text tower's parameters at the top
    level, as in the OpenAI schema."""

    def __init__(self, config: ClipConfig, dtype=torch.float32,
                 attn_impl: str = "auto", ln_matmul_impl: str = "auto",
                 quant: str = "none", visual: nn.Module | None = None):
        super().__init__()
        if quant not in Q8_HALVES:
            raise ValueError(f"Unknown quant mode {quant!r}; have "
                             f"{'/'.join(Q8_HALVES)}")
        self.config = config
        self.dtype = dtype
        self.quant = quant
        cfg = config
        self.visual = (VisionTransformer(cfg, attn_impl, ln_matmul_impl)
                       if visual is None else visual)
        self.transformer = Transformer(cfg.transformer_width,
                                       cfg.transformer_layers,
                                       cfg.transformer_heads, attn_impl,
                                       ln_matmul_impl)
        self.token_embedding = nn.Embedding(cfg.vocab_size,
                                            cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.transformer_width))
        self.ln_final = LayerNorm(cfg.transformer_width)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.transformer_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    @property
    def embed_dim(self) -> int:
        return self.config.embed_dim

    def init_random(self, generator: torch.Generator) -> "CLIP":
        """Random init with the distributions of uml_tpu's flax init
        (lecun-normal kernels, zero biases, unit LN scales, normal
        embeddings), drawn from ``generator``."""
        def normal_(p, std):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * std)

        cfg = self.config
        for name, p in self.named_parameters():
            if name.endswith(("in_proj_weight", "out_proj.weight",
                              "c_fc.weight", "c_proj.weight")) and (
                                  name.startswith(("visual.transformer.",
                                                   "transformer."))):
                normal_(p, p.shape[1] ** -0.5)           # [out, in]
        if isinstance(self.visual, VisionTransformer):
            normal_(self.visual.conv1.weight,
                    (3 * cfg.vision_patch_size ** 2) ** -0.5)
            normal_(self.visual.class_embedding, cfg.vision_width ** -0.5)
            normal_(self.visual.positional_embedding, cfg.vision_width ** -0.5)
            normal_(self.visual.proj, cfg.vision_width ** -0.5)
        else:
            self.visual.init_random(generator)
        normal_(self.token_embedding.weight, 0.02)
        normal_(self.positional_embedding, 0.01)
        normal_(self.text_projection, cfg.transformer_width ** -0.5)
        return self

    def encode_image_u8(self, images_u8, return_tokens: bool = False):
        """uint8 images: CLIP normalization folded into the patch embed."""
        return self.visual(images_u8, self.dtype, return_tokens=return_tokens,
                           quant=self.quant)

    def encode_text(self, tokens, return_eot: bool = False,
                    return_tokens: bool = False):
        """int tokens [N, S] -> features [N, E] fp32 (or all tokens after
        ln_final with ``return_tokens``); ``return_eot`` also returns the
        pooled row index of each prompt."""
        dt = self.dtype
        s = tokens.shape[1]
        # gather, then cast: the same values as casting the whole table
        x = (self.token_embedding.weight[tokens].to(dt)
             + self.positional_embedding[:s].to(dt))
        # text_tower under the UML_TEXT_TOWER gate, else layer by layer,
        # causal (a quant mode, the non-fused branch, UML_TEXT_TOWER=0)
        x = self.transformer(x, causal=True, quant=self.quant)
        eot = tokens.argmax(dim=-1)
        if return_tokens:
            x = self.ln_final(x)
            return (x, eot) if return_eot else x
        # pool the EOT row BEFORE ln_final: LN is per row, so this equals
        # LN-then-pool over [N, K] instead of [N, S, K]
        pooled = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        out = (pooled.float() @ self.text_projection.to(dt).float()).to(dt).float()
        return (out, eot) if return_eot else out


class ClipResNetModel(CLIP):
    """CLIP with a ModifiedResNet image tower (RN50 / RN101,
    models/clip_resnet.py) and the text tower of CLIP (clip.py:623-684).
    It has no int8 mode: both towers serve in the compute dtype, as
    uml_tpu's RN models do whatever ``--quant`` says."""

    def __init__(self, resnet_config, text_config: ClipConfig,
                 dtype=torch.float32, attn_impl: str = "auto",
                 ln_matmul_impl: str = "auto"):
        from uml_tpu_torch.models.clip_resnet import ModifiedResNet

        super().__init__(text_config, dtype, attn_impl, ln_matmul_impl,
                         visual=ModifiedResNet(resnet_config))
        self.resnet_config = resnet_config

    def encode_image_u8(self, images_u8, return_tokens: bool = False,
                        bn_updates: list | None = None):
        """uint8 flat [B, H*W*3] (square images) or [B, H, W, 3]:
        normalized, then the ResNet tower (clip.py:652); ``bn_updates``: a
        list for BatchNorm's train form (uml_tpu's ``train_bn=True``,
        models/clip_resnet.py)."""
        from uml_tpu_torch.ops.image_norm import normalize_images

        if images_u8.ndim == 2:
            r = int(round((images_u8.shape[1] // 3) ** 0.5))
            images_u8 = images_u8.reshape(images_u8.shape[0], r, r, 3)
        return self.visual(normalize_images(images_u8, self.dtype), self.dtype,
                           return_tokens=return_tokens, bn_updates=bn_updates)


def resnet_text_config(rn) -> ClipConfig:
    """The text tower of an RN model: width 512, 8 heads, 12 layers,
    projecting to the tower's output width (clip.py:697-705)."""
    return ClipConfig(embed_dim=rn.output_dim, image_resolution=rn.image_resolution,
                      vision_layers=0, vision_width=rn.width, vision_patch_size=0,
                      transformer_width=512, transformer_heads=8,
                      transformer_layers=12)


def clip_embed_dim(name: str) -> int:
    """The feature width of a named encoder, without building it
    (clip.py:686-694)."""
    from uml_tpu_torch.models.clip_resnet import CLIP_RESNET_CONFIGS

    if name in CLIP_CONFIGS:
        return CLIP_CONFIGS[name].embed_dim
    if name in CLIP_RESNET_CONFIGS:
        return CLIP_RESNET_CONFIGS[name].output_dim
    raise ValueError(f"Unknown CLIP encoder {name!r}")


def build_clip(name: str, dtype=torch.float32, attn_impl: str = "auto",
               ln_matmul_impl: str = "auto", quant: str = "none") -> CLIP:
    """An uninitialised CLIP of a named config (fill it with
    ``init_random`` or ``load_state_dict``).  ``attn_impl`` /
    ``ln_matmul_impl`` as in uml_tpu's build_clip: ("auto" | "fused",
    anything but "reference") keeps the fused half-block path, anything
    else the non-fused branch; ``quant`` a serving mode of Q8_HALVES
    (unknown modes raise), which RN50 / RN101 ignore (clip.py:697-711)."""
    from uml_tpu_torch.models.clip_resnet import CLIP_RESNET_CONFIGS

    if name in CLIP_RESNET_CONFIGS:
        rn = CLIP_RESNET_CONFIGS[name]
        return ClipResNetModel(rn, resnet_text_config(rn), dtype=dtype,
                               attn_impl=attn_impl, ln_matmul_impl=ln_matmul_impl)
    if name not in CLIP_CONFIGS:
        raise ValueError(f"Unknown CLIP encoder {name!r}; have "
                         f"{list(CLIP_CONFIGS) + list(CLIP_RESNET_CONFIGS)}")
    return CLIP(CLIP_CONFIGS[name], dtype=dtype, attn_impl=attn_impl,
                ln_matmul_impl=ln_matmul_impl, quant=quant)
