"""What the plain ViT towers share: pixels to normalised patches,
LayerNorm and multi-head self-attention, in float32.  Each family's
tower is ``reference/<family>.py``.

Every product goes through ``mm`` (reference.precision), so the control
runs the same code one precision step down.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def normalized_patches(images_u8, resolution: int, patch: int):
    """uint8 [B, H*W*3] or [B, H, W, 3] -> normalised patches
    [B, N, 3*p*p] in (channel, row, column) order, conv weight order."""
    b = images_u8.shape[0]
    x = images_u8.reshape(b, resolution, resolution, 3).float() / 255.0
    mean = torch.tensor(PIXEL_MEAN, device=x.device)
    std = torch.tensor(PIXEL_STD, device=x.device)
    x = ((x - mean) / std).permute(0, 3, 1, 2)              # [B, 3, H, W]
    g = resolution // patch
    x = x.reshape(b, 3, g, patch, g, patch).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g * g, 3 * patch * patch)


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def attention(h, wq, bq, wk, bk, wv, bv, wo, bo, heads, mm):
    """Multi-head self-attention of h [B, S, D]; weights [out, in]."""
    b, s, d = h.shape
    dh = d // heads

    def split(t):
        return t.reshape(b, s, heads, dh).transpose(1, 2)

    q = split(mm(h, wq.t()) + bq)
    k = split(mm(h, wk.t()) + bk)
    v = split(mm(h, wv.t()) + bv)
    p = torch.softmax(mm(q, k.transpose(-2, -1)) / math.sqrt(dh), dim=-1)
    o = mm(p, v).transpose(1, 2).reshape(b, s, d)
    return mm(o, wo.t()) + bo
