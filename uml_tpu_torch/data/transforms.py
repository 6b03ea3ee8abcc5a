"""Image transforms: resize/crop/flip pipelines with CLIP normalization.

Capability parity with engine/transforms/default.py (224x224, bicubic,
CLIP mean/std), implemented with PIL + numpy — no torchvision.

Split of responsibilities, as in uml_tpu:
  * host side: JPEG decode + bicubic resize + crop -> uint8 HWC
    (:func:`load_uint8`), which is all the host must do per image;
  * device side: the normalization is folded into the patch-embedding
    weights (uml_tpu_torch.ops.patch_embed), so the host->device copy
    moves uint8 (1/4 the bytes of float32).

``build_transform(name)`` returns the classic fused host pipeline
(PIL -> normalized float32 HWC) for parity-sensitive paths.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

SIZE = (224, 224)
PIXEL_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
PIXEL_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
AUGMENTATIONS = ("crop", "flip", "randomcrop", "randomresizedcrop")


def _resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """Resize the shorter side to ``size`` (torchvision Resize(int)
    semantics — the long side TRUNCATES, not rounds)."""
    w, h = img.size
    if w <= h:
        new_w, new_h = size, max(size, int(size * h / w))
    else:
        new_w, new_h = max(size, int(size * w / h)), size
    return img.resize((new_w, new_h), Image.BICUBIC)


def _center_crop(arr: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    h, w = arr.shape[:2]
    th, tw = size
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return arr[top : top + th, left : left + tw]


def _random_crop(arr: np.ndarray, size, rng: np.random.Generator) -> np.ndarray:
    h, w = arr.shape[:2]
    th, tw = size
    top = int(rng.integers(0, h - th + 1))
    left = int(rng.integers(0, w - tw + 1))
    return arr[top : top + th, left : left + tw]


def _random_resized_crop(
    img: Image.Image, size, scale, rng: np.random.Generator
) -> np.ndarray:
    """torchvision RandomResizedCrop semantics (10 tries, fallback center)."""
    w, h = img.size
    area = w * h
    log_ratio = (np.log(3 / 4), np.log(4 / 3))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            crop = img.crop((left, top, left + cw, top + ch))
            return np.asarray(crop.resize(size[::-1], Image.BICUBIC))
    img = _resize_shorter(img, max(size))
    return _center_crop(np.asarray(img), size)


def normalize(arr_uint8: np.ndarray) -> np.ndarray:
    """uint8 HWC -> normalized float32 HWC with CLIP mean/std."""
    return (arr_uint8.astype(np.float32) / 255.0 - PIXEL_MEAN) / PIXEL_STD


def load_uint8(impath_or_img, augmentation="crop", size=SIZE, rng=None) -> np.ndarray:
    """Decode + resize + crop (+flip) to uint8 HWC — the host half of the
    pipeline. Normalization is applied on device."""
    img = impath_or_img
    if not isinstance(img, Image.Image):
        img = Image.open(img)
    img = img.convert("RGB")
    rng = rng or np.random.default_rng()

    if augmentation == "randomresizedcrop":
        return _random_resized_crop(img, size, (0.08, 1.0), rng).astype(np.uint8)

    arr = np.asarray(_resize_shorter(img, max(size)))
    if augmentation == "crop":
        arr = _center_crop(arr, size)
    elif augmentation == "flip":
        arr = _center_crop(arr, size)[:, ::-1]  # p=1.0 flip, parity default.py:49-55
    elif augmentation == "randomcrop":
        arr = _random_crop(arr, size, rng)
        if rng.random() < 0.5:
            arr = arr[:, ::-1]
    else:
        raise ValueError(f"Invalid image augmentation method: {augmentation}")
    return np.ascontiguousarray(arr)


def build_transform(image_augmentation: str, size=SIZE, seed: int | None = None):
    """PIL/path -> normalized float32 HWC callable (parity pipeline)."""
    if image_augmentation not in AUGMENTATIONS:
        raise ValueError(f"Invalid image augmentation method: {image_augmentation}")
    rng = np.random.default_rng(seed)

    def transform(img):
        return normalize(load_uint8(img, image_augmentation, size, rng))

    return transform
