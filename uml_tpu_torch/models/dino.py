"""DINOv2 / DINO ViT image encoders in PyTorch.

The port of uml_tpu/models/dino.py: the reference's timm vision-model
choices vit_{small,base,large}_patch14_dinov2.lvd142m (DINOv2: LayerScale,
LN eps 1e-6, patch 14, trained at 518 with the position embeddings
interpolated to the 224 grid) and vit_base_patch{8,16}_224_dino (DINO
v1: no LayerScale).  Output contract of timm ``create_model(...,
num_classes=0)``: the CLS token after the final LayerNorm, dim
``num_features``; ``pool="mean"`` averages the patch tokens instead, and
``return_tokens`` returns every token.

Parameters are kept in fp32 under timm-like names (``patch_embed``,
``cls_token``, ``position_embeddings``, ``blocks.{i}.norm1 / qkv /
attn_out / layerscale1 / norm2 / fc1 / fc2 / layerscale2``, ``norm``; the
Linear weights [out, in], the separate q / k / v projections of the HF
checkpoints packed into one ``qkv``).  The forward runs in the model's
compute ``dtype`` through the ops of ``uml_tpu_torch.ops``, as uml_tpu's
DinoBlock calls its kernels:

* each block is an attention half (``attn_block``; the CLS-only
  ``attn_block_cls`` for the last block of a token-pooled forward) and an
  MLP half with exact GELU (``mlp_block(activation="gelu_exact")``), on
  the LN-folded weights; LayerScale is folded into ``attn_out`` and
  ``fc2`` (attn @ wo * ls == attn @ (wo * ls)) in fp32 before the cast;
* ``quant="int8"`` runs every full block W8A8 (``attn_block_q8``,
  ``mlp_block_q8`` with exact GELU): the LN folds into the fp32 QKV and
  fc1 weights, the LayerScale into attn_out and fc2, all before the int8
  quantization (whose per-column scales absorb the LayerScale exactly);
  attn_out and fc2 are cast to the compute dtype first (dino.py:130-151);
  the CLS-only last block stays bf16;
* the folded and the quantized weights are derived once and cached (the
  cache of models/clip.py, keyed on every parameter's storage and
  version); the int8 weights are cached K-major ([out, in]) and handed to
  the ops as [in, out] views, which the card's kernels read in place;
* training (the full-model finetune, when autograd needs a gradient):
  the LN and LayerScale folds are derived with autograd on every call,
  never from the cache, and each block runs through the ops' autograd
  Functions (``AttnBlockFn``, ``AttnBlockClsFn`` for the CLS-only last
  block, ``MlpBlockFn`` with exact GELU), each with eps 1e-6, as
  models/clip.py's layers do; so the gradient reaches every parameter:
  the patch embedding (through ``patch_embed_u8``), the class token, the
  position embeddings, each block's LN, QKV, out-projection, fc1, fc2 and
  LayerScales, and the final LN.  Which kernels run is the ops' choice
  under uml_tpu's switches (UML_BWD_STASH, UML_MLP_STASH, UML_MLP_BWD);
  ``quant="int8"`` stays inference-only (``check_inference``);
* the uint8 path folds the CLIP normalization into the patch embedding
  (ops/patch_embed.py, patch 14, 16 or 8); the float path is a strided
  convolution of normalized NHWC pixels;
* the final LayerNorm has fp32 statistics with flax's variance,
  E[x^2] - E[x]^2, and eps 1e-6 (``raw_layer_norm``).

Sequence lengths: S = 257 for the DINOv2 configs at 224 / 14, one past the
fused QKV + attention kernel's route (S <= 256), so every DINOv2 attention
half takes the chain (the engine's QKV product, then flash_attention.cu);
S = 785 for DINO ViT-B/8.

Weights: ``port_dinov2_state_dict`` reads an HF ``Dinov2Model`` /
``ViTModel`` state_dict; ``load_dino`` loads the HF checkpoint from the
local cache, or with ``allow_random_init`` draws the weights from a
seeded ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from uml_tpu_torch.models.clip import (LayerNorm, Linear, _Cached, _in_out,
                                       _needs_grad)
from uml_tpu_torch.ops.fused_attention import (AttnBlockClsFn, AttnBlockFn,
                                               attn_block, attn_block_cls,
                                               fold_ln_into_matmul)
from uml_tpu_torch.ops.ln_matmul import MlpBlockFn, mlp_block, raw_layer_norm
from uml_tpu_torch.ops.patch_embed import patch_embed_u8
from uml_tpu_torch.ops.quant import (attn_block_q8, check_inference,
                                     mlp_block_q8, quantize_weight)

QUANT_MODES = ("none", "int8")


@dataclass(frozen=True)
class DinoConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    patch_size: int
    image_size: int = 224
    mlp_ratio: int = 4
    layerscale: bool = True          # DINOv2 yes, DINO v1 no
    ln_eps: float = 1e-6
    pretrain_image_size: int = 518   # grid the checkpoint's pos-emb was trained at

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_features(self) -> int:
        return self.hidden_size


# reference vision-model names -> config + HF checkpoint repo (dino.py:49-62)
DINO_CONFIGS = {
    "vit_small_patch14_dinov2.lvd142m": (
        DinoConfig(384, 12, 6, 14), "facebook/dinov2-small"),
    "vit_base_patch14_dinov2.lvd142m": (
        DinoConfig(768, 12, 12, 14), "facebook/dinov2-base"),
    "vit_large_patch14_dinov2.lvd142m": (
        DinoConfig(1024, 24, 16, 14), "facebook/dinov2-large"),
    "vit_base_patch16_224_dino": (
        DinoConfig(768, 12, 12, 16, layerscale=False, ln_eps=1e-6,
                   pretrain_image_size=224), "facebook/dino-vitb16"),
    "vit_base_patch8_224_dino": (
        DinoConfig(768, 12, 12, 8, layerscale=False, ln_eps=1e-6,
                   pretrain_image_size=224), "facebook/dino-vitb8"),
}


class DinoBlock(nn.Module):
    def __init__(self, config: DinoConfig):
        super().__init__()
        dim = config.hidden_size
        self.config = config
        self.norm1 = LayerNorm(dim)
        self.qkv = Linear(dim, 3 * dim)
        self.attn_out = Linear(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Linear(dim, config.mlp_ratio * dim)
        self.fc2 = Linear(config.mlp_ratio * dim, dim)
        if config.layerscale:
            self.layerscale1 = nn.Parameter(torch.ones(dim))
            self.layerscale2 = nn.Parameter(torch.ones(dim))
        self._folded = _Cached()
        self._q8 = _Cached()

    def _scaled_out(self):
        """(attn_out [in, out], its bias, fc2 [in, out], its bias) in fp32,
        the LayerScale folded in (dino.py:125-128, 168-172)."""
        wo, bo = self.attn_out.weight.t(), self.attn_out.bias
        w2, b2 = self.fc2.weight.t(), self.fc2.bias
        if self.config.layerscale:
            wo, bo = wo * self.layerscale1[None, :], bo * self.layerscale1
            w2, b2 = w2 * self.layerscale2[None, :], b2 * self.layerscale2
        return wo, bo.float(), w2, b2.float()

    def _fold(self, dtype):
        w_eff, b_eff = fold_ln_into_matmul(
            self.norm1.weight, self.norm1.bias, self.qkv.weight.to(dtype).t(),
            self.qkv.bias)
        w1_eff, b1_eff = fold_ln_into_matmul(
            self.norm2.weight, self.norm2.bias, self.fc1.weight.to(dtype).t(),
            self.fc1.bias)
        wo, bo, w2, b2 = self._scaled_out()
        return (w_eff.contiguous(), b_eff, wo.to(dtype).contiguous(), bo,
                w1_eff.contiguous(), b1_eff, w2.to(dtype).contiguous(), b2)

    def folded(self, dtype):
        """(w_eff, b_eff, wo, bo, w1_eff, b1_eff, w2, b2): the LN-folded
        weights in the JAX [in, out] layout, cast to ``dtype`` before the
        fold as uml_tpu does (the LayerScale folded in fp32 first), biases
        fp32.  With autograd (training) they are derived anew, with a
        gradient to the parameters; otherwise from the cache."""
        params = list(self.parameters())
        if _needs_grad(*params):
            return self._fold(dtype)
        return self._folded.get(params, dtype, lambda: self._fold(dtype))

    def _quantize(self, dtype):
        w_eff, b_eff = fold_ln_into_matmul(
            self.norm1.weight, self.norm1.bias, self.qkv.weight.t(),
            self.qkv.bias)
        w1_eff, b1_eff = fold_ln_into_matmul(
            self.norm2.weight, self.norm2.bias, self.fc1.weight.t(),
            self.fc1.bias)
        wo, bo, w2, b2 = self._scaled_out()
        quantized = (quantize_weight(w_eff) + quantize_weight(wo.to(dtype))
                     + quantize_weight(w1_eff) + quantize_weight(w2.to(dtype)))
        # each int8 weight stored once K-major, the scales as they are
        wq, wsc, woq, wosc, w1q, w1sc, w2q, w2sc = (
            t.t().contiguous() if t.dtype == torch.int8 else t for t in quantized)
        return (wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1_eff, w2q, w2sc, b2)

    def quantized(self, dtype):
        """(wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2):
        the int8 weights K-major with fp32 column scales, fp32 biases;
        cached, inference-only."""
        params = list(self.parameters())
        check_inference("the int8 serving mode", *params)
        return self._q8.get(params, dtype, lambda: self._quantize(dtype))

    def forward(self, x, cls_only: bool = False, quant: str = "none"):
        """One block; ``cls_only`` keeps the CLS row ([B, 1, K], row 0 of
        the full block) and runs bf16 whatever ``quant``."""
        cfg = self.config
        heads, eps = cfg.num_heads, cfg.ln_eps
        if quant == "int8" and not cls_only:
            (wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc,
             b2) = _in_out(self.quantized(x.dtype))
            x = attn_block_q8(x, wq, wsc, b_eff, (woq, wosc), bo, heads=heads,
                              eps=eps)
            return mlp_block_q8(x, w1q, w1sc, b1, w2q, w2sc, b2, eps=eps,
                                activation="gelu_exact")
        w_eff, b_eff, wo, bo, w1, b1, w2, b2 = self.folded(x.dtype)
        if _needs_grad(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2):
            if cls_only:
                x = AttnBlockClsFn.apply(x, w_eff, b_eff, wo, bo, heads, eps)
            else:
                x = AttnBlockFn.apply(x, w_eff, b_eff, wo, bo, heads, False, eps)
            return MlpBlockFn.apply(x, w1, b1, w2, b2, eps, "gelu_exact")
        if cls_only:
            x = attn_block_cls(x, w_eff, b_eff, wo, bo, heads=heads, eps=eps)
        else:
            x = attn_block(x, w_eff, b_eff, wo, bo, heads=heads, eps=eps)
        return mlp_block(x, w1, b1, w2, b2, eps=eps, activation="gelu_exact")


class DinoViT(nn.Module):
    """forward(pixels, return_tokens=False, pool="token", from_uint8=False)
    -> fp32 features [B, K] (or tokens [B, S, K]); pixels are uint8 [B,
    H*W*3] / [B, H, W, 3] with ``from_uint8``, else normalized float NHWC
    (uml_tpu's layout)."""

    def __init__(self, config: DinoConfig, dtype=torch.float32,
                 quant: str = "none"):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"Unknown DINO quant mode {quant!r}; have "
                             f"{'/'.join(QUANT_MODES)}")
        self.config = config
        self.dtype = dtype
        self.quant = quant
        dim, p = config.hidden_size, config.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(torch.empty(dim, 3, p, p))
        self.patch_embed.bias = nn.Parameter(torch.zeros(dim))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.position_embeddings = nn.Parameter(
            torch.empty(1, config.grid_size ** 2 + 1, dim))
        self.blocks = nn.ModuleList(DinoBlock(config)
                                    for _ in range(config.num_layers))
        self.norm = LayerNorm(dim)

    @property
    def num_features(self) -> int:
        return self.config.num_features

    def init_random(self, generator: torch.Generator) -> "DinoViT":
        """Random init with the distributions of uml_tpu's flax init
        (lecun-normal kernels, zero biases and class token, unit LN scales
        and LayerScales, position embeddings normal(0.02)), drawn from
        ``generator``."""
        def normal_(p, std):
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator) * std)

        for name, p in self.named_parameters():
            if name.endswith(("qkv.weight", "attn_out.weight", "fc1.weight",
                              "fc2.weight")):
                normal_(p, p.shape[1] ** -0.5)           # [out, in]
        p = self.config.patch_size
        normal_(self.patch_embed.weight, (3 * p * p) ** -0.5)
        normal_(self.position_embeddings, 0.02)
        return self

    def _embed(self, pixels, from_uint8: bool):
        cfg, dt = self.config, self.dtype
        b = pixels.shape[0]
        if from_uint8:
            if pixels.ndim == 2:   # flat [B, H*W*3]: square RGB
                r = int(round((pixels.shape[1] // 3) ** 0.5))
                pixels = pixels.reshape(b, r, r, 3)
            kernel = self.patch_embed.weight.permute(2, 3, 1, 0)   # OIHW -> HWIO
            x = patch_embed_u8(pixels, kernel, dtype=dt)
            return (x.float() + self.patch_embed.bias.float()).to(dt)
        # VALID, stride = patch size, in the compute dtype (dino.py:218-224)
        x = F.conv2d(pixels.permute(0, 3, 1, 2).to(dt),
                     self.patch_embed.weight.to(dt), stride=cfg.patch_size)
        x = x.flatten(2).transpose(1, 2)
        return x + self.patch_embed.bias.to(dt)

    def forward(self, pixels, return_tokens: bool = False, pool: str = "token",
                from_uint8: bool = False):
        if pool not in ("token", "mean"):
            raise ValueError(f"unknown pool {pool!r}")
        x = self._embed(pixels, from_uint8)
        b, dt = x.shape[0], self.dtype
        cls = self.cls_token.to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embeddings.to(dt)
        cls_only_last = not return_tokens and pool == "token"
        last = len(self.blocks) - 1
        for i, block in enumerate(self.blocks):
            x = block(x, cls_only=cls_only_last and i == last, quant=self.quant)
        x = (raw_layer_norm(x.float(), self.config.ln_eps)
             * self.norm.weight.float() + self.norm.bias.float())
        if return_tokens:
            return x
        if pool == "token":
            return x[:, 0]
        return x[:, 1:].mean(1)

    def encode_image_u8(self, images_u8, return_tokens: bool = False):
        """uint8 images (flat or NHWC): the encoder API of ClipEncoder's
        model."""
        return self(images_u8, return_tokens=return_tokens, from_uint8=True)


def interpolate_pos_embeddings(pos: np.ndarray, src_grid: int, dst_grid: int):
    """Bicubic-resample patch position embeddings [1, 1+src^2, D] to
    [1, 1+dst^2, D] (what timm/HF do when img_size differs from pretrain),
    with PIL's bicubic filter, as uml_tpu resamples them."""
    if src_grid == dst_grid:
        return pos
    from PIL import Image

    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    d = patch_pos.shape[-1]
    grid = patch_pos.reshape(src_grid, src_grid, d)
    out = np.zeros((dst_grid, dst_grid, d), np.float32)
    for c in range(d):
        img = Image.fromarray(grid[:, :, c].astype(np.float32), mode="F")
        out[:, :, c] = np.asarray(
            img.resize((dst_grid, dst_grid), Image.BICUBIC))
    return np.concatenate([cls_pos, out.reshape(1, dst_grid ** 2, d)], axis=1)


def port_dinov2_state_dict(sd, config: DinoConfig) -> dict:
    """HF Dinov2Model / ViTModel (DINO v1) state_dict -> the state_dict of
    the port's DinoViT (fp32; q, k, v packed into one qkv; the position
    embeddings resampled to the config's grid)."""

    def f32(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return np.asarray(t, np.float32)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32))

    out = {}

    def copy(dst, src):
        out[f"{dst}.weight"] = tensor(f32(sd[f"{src}.weight"]))
        out[f"{dst}.bias"] = tensor(f32(sd[f"{src}.bias"]))

    for i in range(config.num_layers):
        p, q = f"encoder.layer.{i}", f"blocks.{i}"
        a = f"{p}.attention.attention"
        out[f"{q}.qkv.weight"] = tensor(np.concatenate(
            [f32(sd[f"{a}.{n}.weight"]) for n in ("query", "key", "value")]))
        out[f"{q}.qkv.bias"] = tensor(np.concatenate(
            [f32(sd[f"{a}.{n}.bias"]) for n in ("query", "key", "value")]))
        copy(f"{q}.attn_out", f"{p}.attention.output.dense")
        v2 = f"{p}.norm1.weight" in sd     # Dinov2Model; ViTModel otherwise
        copy(f"{q}.norm1", f"{p}.norm1" if v2 else f"{p}.layernorm_before")
        copy(f"{q}.norm2", f"{p}.norm2" if v2 else f"{p}.layernorm_after")
        copy(f"{q}.fc1", f"{p}.mlp.fc1" if v2 else f"{p}.intermediate.dense")
        copy(f"{q}.fc2", f"{p}.mlp.fc2" if v2 else f"{p}.output.dense")
        if config.layerscale:
            out[f"{q}.layerscale1"] = tensor(f32(sd[f"{p}.layer_scale1.lambda1"]))
            out[f"{q}.layerscale2"] = tensor(f32(sd[f"{p}.layer_scale2.lambda1"]))
    pos = f32(sd["embeddings.position_embeddings"])
    src_grid = round((pos.shape[1] - 1) ** 0.5)
    out["position_embeddings"] = tensor(
        interpolate_pos_embeddings(pos, src_grid, config.grid_size))
    out["cls_token"] = tensor(f32(sd["embeddings.cls_token"]))
    out["patch_embed.weight"] = tensor(
        f32(sd["embeddings.patch_embeddings.projection.weight"]))
    out["patch_embed.bias"] = tensor(
        f32(sd["embeddings.patch_embeddings.projection.bias"]))
    copy("norm", "layernorm")
    return out


def load_dino(name: str, dtype=torch.bfloat16, allow_random_init: bool = False,
              quant: str = "none") -> DinoViT:
    """-> DinoViT (fp32 parameters on the CPU, forward in ``dtype``,
    ``quant`` none or int8) with the HF weights from the local cache, else
    (``allow_random_init``) random weights from a generator seeded with 0."""
    if quant not in QUANT_MODES:
        raise ValueError(f"Unknown DINO quant mode {quant!r}; have "
                         f"{'/'.join(QUANT_MODES)}")
    cfg, repo = DINO_CONFIGS[name]
    model = DinoViT(cfg, dtype=dtype, quant=quant)
    try:
        from transformers import AutoModel

        hf = AutoModel.from_pretrained(repo, local_files_only=True)
        model.load_state_dict(port_dinov2_state_dict(hf.state_dict(), cfg))
        print(f"=> Loaded {name} weights from {repo}")
        return model
    except Exception as e:
        if not allow_random_init:
            raise FileNotFoundError(
                f"Could not load pretrained weights for {name} ({repo}): {e}. "
                "Populate the local HF cache or pass allow_random_init."
            ) from e
        print(f"=> [random-init] {name} ({e})")
        return model.init_random(torch.Generator().manual_seed(0))
