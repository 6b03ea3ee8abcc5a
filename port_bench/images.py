"""Images for the cells, made on the device from a generator.

Independent uniform noise makes every image alike to a ViT (the CLS
features of noise images lie at a pairwise cosine near 0.96), so every
row of a batch meets the same near-tie of a saturated softmax.  Each
image here is instead a mean colour, a smooth pattern (normal noise on a
``grid`` x ``grid`` lattice, upsampled bicubically) at its own contrast,
and fine noise at its own level, clipped to uint8: the features then
spread as those of distinct photographs do.  ``SPEC`` holds the ranges
every cell draws from."""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the lattice of the smooth pattern, and the ranges (in uint8 levels) of
# an image's mean colour, its pattern's contrast and its fine noise
SPEC = {"grid": 7, "mean": (48, 208), "contrast": (10, 60), "fine": (0, 20)}


def make(gen, count: int, resolution: int, device) -> torch.Tensor:
    """-> uint8 [count, resolution, resolution, 3] on ``device``."""
    def uniform(lo_hi, *shape):
        lo, hi = lo_hi
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    g = SPEC["grid"]
    smooth = F.interpolate(torch.randn((count, 3, g, g), generator=gen, device=device),
                           size=(resolution, resolution), mode="bicubic",
                           align_corners=False)
    fine = torch.randn((count, 3, resolution, resolution), generator=gen, device=device)
    x = (uniform(SPEC["mean"], count, 3, 1, 1)
         + uniform(SPEC["contrast"], count, 1, 1, 1) * smooth
         + uniform(SPEC["fine"], count, 1, 1, 1) * fine)
    return x.clamp_(0, 255).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
