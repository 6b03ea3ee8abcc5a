"""CLIP ViT in PyTorch: image tower on uint8 pixels, causal text tower.

The port of uml_tpu/models/clip.py for the ViT configs (the RN towers and
the int8 serving modes come later).  Parameter names and shapes follow
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
* text tower: token + positional embedding, all layers through
  text_tower, the EOT row (argmax of the token ids) pooled BEFORE
  ``ln_final`` (clip.py:556-574), ``text_projection``.

Training (the full-model finetune): when autograd needs a gradient
(grad mode on and a parameter that requires one), the image tower derives
the LN-folded weights with autograd on every call, and each layer runs
through the autograd Functions of the ops (AttnBlockFn, AttnBlockClsFn,
MlpBlockFn: the stash forward kernels and their backward kernels), so the
gradient reaches every parameter of the tower: patch embedding, class
and positional embeddings, ln_pre, the layers, ln_post and proj.  The
towers have no dropout or BatchNorm, so ``model.train()`` and
``model.eval()`` compute the same; freezing is ``requires_grad_(False)``.

Inference (``torch.no_grad()``, or frozen parameters): the folded,
compute-dtype weights are derived once and cached; the cache is keyed on
every source parameter's storage and version counter, so loading a
state_dict, an optimizer step or moving the model rebuilds it.  The text
tower runs forward only (text_tower has no backward yet) and raises if a
gradient is asked of it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from uml_tpu_torch.ops.fused_attention import (AttnBlockClsFn, AttnBlockFn,
                                               attn_block, attn_block_cls,
                                               fold_ln_into_matmul)
from uml_tpu_torch.ops.ln_matmul import MlpBlockFn, mlp_block, raw_layer_norm
from uml_tpu_torch.ops.patch_embed import patch_embed_u8
from uml_tpu_torch.ops.text_tower import text_tower


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


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attn = MultiheadAttention(width)
        self.ln_1 = LayerNorm(width)
        self.mlp = MLP(width)
        self.ln_2 = LayerNorm(width)
        self._folded = _Cached()

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

    def forward(self, x, cls_only: bool = False):
        """Non-causal layer (image tower; the causal text layers run
        through text_tower).  ``cls_only``: the attention half keeps only
        the CLS row, so the output is [B, 1, K] (row 0 of the full
        layer)."""
        w_eff, b_eff, wo, bo, w1, b1, w2, b2 = self.folded(x.dtype)
        if _needs_grad(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2):
            if cls_only:
                x = AttnBlockClsFn.apply(x, w_eff, b_eff, wo, bo, self.heads,
                                         1e-5)
            else:
                x = AttnBlockFn.apply(x, w_eff, b_eff, wo, bo, self.heads,
                                      False, 1e-5)
            return MlpBlockFn.apply(x, w1, b1, w2, b2, 1e-5)
        if cls_only:
            x = attn_block_cls(x, w_eff, b_eff, wo, bo, heads=self.heads)
        else:
            x = attn_block(x, w_eff, b_eff, wo, bo, heads=self.heads)
        return mlp_block(x, w1, b1, w2, b2)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.heads = heads
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads) for _ in range(layers)])
        self._stacked = _Cached()

    def forward(self, x, cls_only_last: bool = False):
        """The image tower's per-layer path."""
        last = len(self.resblocks) - 1
        for i, block in enumerate(self.resblocks):
            x = block(x, cls_only=cls_only_last and i == last)
        return x

    def stacked(self, dtype):
        """Every layer's folded weights stacked on a leading layer axis —
        the operands of text_tower (forward only)."""
        if _needs_grad(*self.parameters()):
            raise NotImplementedError(
                "the text tower has no backward in uml_tpu_torch yet (the "
                "causal backward kernel comes with the unfrozen text tower); "
                "run encode_text under torch.no_grad() or freeze its "
                "parameters")

        def build():
            per_layer = [b.folded(dtype) for b in self.resblocks]
            return tuple(torch.stack(t) for t in zip(*per_layer))
        return self._stacked.get(list(self.parameters()), dtype, build)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        w, p = cfg.vision_width, cfg.vision_patch_size
        self.conv1 = nn.Module()
        self.conv1.weight = nn.Parameter(torch.empty(w, 3, p, p))
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.grid_size ** 2 + 1, w))
        self.ln_pre = LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, cfg.embed_dim))

    def forward(self, images_u8, dtype, return_tokens: bool = False):
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
        x = self.transformer(x, cls_only_last=not return_tokens)
        if return_tokens:
            return x
        x = self.ln_post(x[:, 0])
        return (x.float() @ self.proj.to(dtype).float()).to(dtype).float()


class CLIP(nn.Module):
    """Image tower ``visual`` + the text tower's parameters at the top
    level, as in the OpenAI schema."""

    def __init__(self, config: ClipConfig, dtype=torch.float32):
        super().__init__()
        self.config = config
        self.dtype = dtype
        cfg = config
        self.visual = VisionTransformer(cfg)
        self.transformer = Transformer(cfg.transformer_width,
                                       cfg.transformer_layers,
                                       cfg.transformer_heads)
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

        for name, p in self.named_parameters():
            if name.endswith(("in_proj_weight", "out_proj.weight",
                              "c_fc.weight", "c_proj.weight")):
                normal_(p, p.shape[1] ** -0.5)           # [out, in]
        cfg = self.config
        normal_(self.visual.conv1.weight, (3 * cfg.vision_patch_size ** 2) ** -0.5)
        normal_(self.visual.class_embedding, cfg.vision_width ** -0.5)
        normal_(self.visual.positional_embedding, cfg.vision_width ** -0.5)
        normal_(self.visual.proj, cfg.vision_width ** -0.5)
        normal_(self.token_embedding.weight, 0.02)
        normal_(self.positional_embedding, 0.01)
        normal_(self.text_projection, cfg.transformer_width ** -0.5)
        return self

    def encode_image_u8(self, images_u8, return_tokens: bool = False):
        """uint8 images: CLIP normalization folded into the patch embed."""
        return self.visual(images_u8, self.dtype, return_tokens=return_tokens)

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
        x = text_tower(x, *self.transformer.stacked(dt),
                       heads=self.transformer.heads)
        eot = tokens.argmax(dim=-1)
        if return_tokens:
            x = self.ln_final(x)
            return (x, eot) if return_eot else x
        # pool the EOT row BEFORE ln_final: LN is per row, so this equals
        # LN-then-pool over [N, K] instead of [N, S, K]
        pooled = self.ln_final(x[torch.arange(x.shape[0], device=x.device), eot])
        out = (pooled.float() @ self.text_projection.to(dt).float()).to(dt).float()
        return (out, eot) if return_eot else out


def build_clip(name: str, dtype=torch.float32) -> CLIP:
    """An uninitialised CLIP of a named ViT config (fill it with
    ``init_random`` or ``load_state_dict``)."""
    if name not in CLIP_CONFIGS:
        raise ValueError(f"Unknown CLIP encoder {name!r}; the port has "
                         f"{list(CLIP_CONFIGS)} (RN50/RN101 come later)")
    return CLIP(CLIP_CONFIGS[name], dtype=dtype)
