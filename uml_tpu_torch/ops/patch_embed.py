"""Patch embedding straight from uint8, the CLIP normalization folded in.

The counterpart of uml_tpu/ops/patch_embed.py (an XLA matmul there, not a
Pallas kernel, so a plain torch matmul here).  Normalization is an affine
per-channel map, so it folds into the patch-embedding weights:

    normalize(u8)[c] = u8[c] * a[c] + d[c],   a = 1/(255*std), d = -mean/std
    conv(normalize(u8)) = conv_{W*a}(u8) + bias,  bias_o = sum_hwc W[h,w,c,o]*d[c]

Patches are a reshape/permute of the uint8 batch; uint8 values are exact
in bf16, and the product accumulates in fp32.
"""

from __future__ import annotations

import torch

PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def fold_normalization(kernel):
    """conv kernel [p, p, 3, out] (HWIO) -> (scaled kernel fp32, bias [out])."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=kernel.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=kernel.device)
    a = 1.0 / (255.0 * std)
    d = -mean / std
    kf = kernel.float()
    scaled = kf * a[None, None, :, None]
    bias = torch.einsum("hwco,c->o", kf, d)
    return scaled, bias


def extract_patches(images, patch: int):
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] in (kh, kw, c) minor order,
    matching a [p, p, C, out] kernel reshaped to [p*p*C, out]."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def patch_embed_u8(images_u8, kernel, *, dtype=torch.bfloat16):
    """uint8 [B, H, W, 3] + conv kernel [p, p, 3, out] -> [B, N, out] in
    ``dtype``: conv(normalize(images), kernel), VALID, stride = patch."""
    p = kernel.shape[0]
    out = kernel.shape[-1]
    scaled, bias = fold_normalization(kernel)
    patches = extract_patches(images_u8, p).to(dtype)
    w = scaled.reshape(p * p * kernel.shape[2], out).to(dtype)
    y = torch.matmul(patches.float(), w.float())
    return (y + bias).to(dtype)
