"""Feature-cache IO: path schemes + .pth-compatible save/load.

Path-scheme parity with features.py:32-44 (img/text/descriptor outdirs,
'patch-token' subdir for token-level caches) and schema parity with the
cache contracts finetune.py consumes:

  text cache  = {features, labels, eot_indices, prompts, lab2cname[, cname2lab]}
  image cache = {features, labels, paths} (train mode nests {train:..., val:...})

Caches are written with torch.save (host-side IO only) so artifacts are
drop-in interchangeable with the reference; arrays are numpy in memory.
"""

from __future__ import annotations

import os

import numpy as np

from uml_tpu_torch.data.fewshot import get_few_shot_setup_name
from uml_tpu_torch.utils.io import makedirs


def img_outdir(outdir, encoder, ds, augmentation, tr_shot, seed,
               mode="train", return_tokens=False):
    subpath = "patch-token" if return_tokens else ""
    if mode == "train":
        return os.path.join(outdir, subpath, "image", encoder.replace("/", "-"),
                            ds, augmentation,
                            f"{get_few_shot_setup_name(tr_shot, seed)}.pth")
    return os.path.join(outdir, subpath, "image", encoder.replace("/", "-"),
                        ds, "test.pth")


def text_outdir(outdir, encoder, ds, text_augmentation, return_tokens=False):
    subpath = "patch-token" if return_tokens else ""
    return os.path.join(outdir, subpath, "text", encoder.replace("/", "-"),
                        ds, f"{text_augmentation}.pth")


def descriptor_outdir(outdir, encoder, ds, descriptor_type, return_tokens=False):
    return text_outdir(outdir, encoder, ds, descriptor_type, return_tokens)


def save_cache(obj: dict, path: str) -> None:
    """Write a cache dict; numpy arrays become torch tensors on disk."""
    import torch

    def conv(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(v).copy())
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list) and v and isinstance(v[0], np.ndarray):
            return [conv(x) for x in v]
        return v

    makedirs(os.path.dirname(path))
    torch.save(conv(obj), path)


def load_cache(path: str) -> dict:
    """Read a cache dict (ours or the reference's); tensors become numpy."""
    import torch

    def conv(v):
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, list) and v and isinstance(v[0], torch.Tensor):
            return [conv(x) for x in v]
        return v

    return conv(torch.load(path, map_location="cpu", weights_only=False))
