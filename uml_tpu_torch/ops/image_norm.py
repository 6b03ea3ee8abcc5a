"""CLIP normalization of uint8 images on the device.

The counterpart of uml_tpu/ops/image_norm.py, which is jnp on purpose (an
elementwise pass that XLA fuses; not a Pallas kernel), so plain torch
here.  The ViT towers fold it into the patch embedding
(ops/patch_embed.py); the RN towers' stem is a 3x3 convolution with
padding, where the zero border is not the image of any pixel, so they
normalize first.
"""

from __future__ import annotations

import torch

PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize_images(batch_uint8, dtype=torch.float32):
    """uint8 [..., H, W, 3] -> CLIP-normalized ``dtype`` [..., H, W, 3]:
    (u8 / 255 - mean) / std in fp32, as uml_tpu computes it."""
    dev = batch_uint8.device
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=dev)
    inv_std = 1.0 / torch.tensor(PIXEL_STD, dtype=torch.float32, device=dev)
    x = batch_uint8.float() * (1.0 / 255.0)
    return ((x - mean) * inv_std).to(dtype)
