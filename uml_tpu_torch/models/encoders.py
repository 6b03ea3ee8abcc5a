"""CLIP weight resolution and the encoder the ``features`` CLI drives.

The counterpart of uml_tpu/models/encoders.py.  Weights resolve from
local paths only:

  $UML_CLIP_WEIGHTS_DIR/<name with / -> ->.pt     e.g. ViT-B-16.pt

checked against the official SHA256 digest (UML_CLIP_VERIFY_SHA=0 skips
the check).  Missing weights raise unless ``allow_random_init``, which
draws the weights from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.models.clip import CLIP, build_clip
from uml_tpu_torch.models.port_torch import load_clip_checkpoint
from uml_tpu_torch.models.tokenizer import tokenize

# Official OpenAI checkpoint SHA256 digests (encoders.py:29-36)
CLIP_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
}


def verify_clip_sha256(name: str, path: str) -> None:
    """Raise if the local checkpoint's SHA256 mismatches the official
    digest.  Unknown names pass; UML_CLIP_VERIFY_SHA=0 skips."""
    if os.environ.get("UML_CLIP_VERIFY_SHA", "1") == "0":
        return
    want = CLIP_SHA256.get(name)
    if want is None:
        return
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            h.update(chunk)
    if h.hexdigest() != want:
        raise RuntimeError(
            f"{path} SHA256 {h.hexdigest()} does not match the official "
            f"{name} checkpoint digest {want}; set UML_CLIP_VERIFY_SHA=0 "
            "to load it anyway")


def clip_weights_path(name: str) -> str | None:
    root = os.environ.get("UML_CLIP_WEIGHTS_DIR", "")
    if not root:
        return None
    path = os.path.join(root, name.replace("/", "-") + ".pt")
    return path if os.path.exists(path) else None


def load_clip(name: str, dtype=torch.bfloat16,
              allow_random_init: bool = False) -> CLIP:
    """-> CLIP (fp32 parameters on the CPU, forward in ``dtype``), from
    the local checkpoint when there is one, else random init from a
    generator seeded with 0."""
    path = clip_weights_path(name)
    if path is not None:
        verify_clip_sha256(name, path)
        print(f"=> Loading CLIP weights from {path}")
        return load_clip_checkpoint(path, dtype=dtype)
    if not allow_random_init:
        raise FileNotFoundError(
            f"No CLIP weights for {name!r}. Set UML_CLIP_WEIGHTS_DIR to a "
            "directory containing the OpenAI checkpoint "
            f"({name.replace('/', '-')}.pt), or pass --allow-random-init "
            "for smoke testing.")
    print(f"=> [random-init] CLIP {name} (no pretrained weights found)")
    return build_clip(name, dtype=dtype).init_random(
        torch.Generator().manual_seed(0))


class ClipEncoder:
    """Image/text encoding with a frozen CLIP on one device.

    ``stage_images`` copies a uint8 batch to the device (pinned host
    memory, asynchronous copy), ``encode_staged`` runs the forward and
    returns the device output unfetched; ``encode_images`` /
    ``encode_texts`` do both and return numpy.  ``check_finite`` raises at
    the first batch with a non-finite feature (``--debug_nans``).

    ``model`` is the CLIP on ``device`` (fp32 parameters, forward in
    ``dtype``); the finetune CLI trains a copy of it on the full-model path.
    """

    def __init__(self, name: str, dtype=torch.bfloat16,
                 allow_random_init: bool = False, device=None,
                 check_finite: bool = False):
        self.name = name
        self.device = torch.device(device) if device is not None else default_device()
        self.model = load_clip(name, dtype, allow_random_init).to(self.device).eval()
        self.check_finite = check_finite

    def stage_images(self, imgs_uint8: np.ndarray):
        """uint8 [B,H,W,3] -> (flat [B, H*W*3] uint8 on the device, B)."""
        flat = torch.from_numpy(
            np.ascontiguousarray(imgs_uint8).reshape(imgs_uint8.shape[0], -1))
        if self.device.type == "cuda":
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        return flat, flat.shape[0]

    def _checked(self, out):
        if self.check_finite and not bool(torch.isfinite(out).all()):
            raise FloatingPointError(f"{self.name}: non-finite encoder output")
        return out

    def encode_staged(self, batch, n: int, return_tokens: bool = False):
        with torch.no_grad():
            out = self.model.encode_image_u8(batch, return_tokens=return_tokens)
        return self._checked(out), n

    def encode_images(self, imgs_uint8: np.ndarray,
                      return_tokens: bool = False) -> np.ndarray:
        """uint8 [B,H,W,3] -> features [B,D] (or tokens [B,S,W]) float32."""
        out, n = self.encode_staged(*self.stage_images(imgs_uint8),
                                    return_tokens=return_tokens)
        return out.float().cpu().numpy()[:n]

    def encode_texts(self, texts: list[str], return_tokens: bool = False):
        """list[str] -> (features [N,D] | tokens [N,77,W], eot_indices [N])."""
        toks = torch.from_numpy(tokenize(texts).astype(np.int64)).to(self.device)
        with torch.no_grad():
            out, eot = self.model.encode_text(toks, return_eot=True,
                                              return_tokens=return_tokens)
        out = self._checked(out)
        return out.float().cpu().numpy(), eot.cpu().numpy().astype(np.int64)
