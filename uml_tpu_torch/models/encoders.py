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
from typing import NamedTuple

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
              allow_random_init: bool = False, quant: str = "none") -> CLIP:
    """-> CLIP (fp32 parameters on the CPU, forward in ``dtype``, serving
    mode ``quant``: none or an int8 mode of models.clip.Q8_HALVES), from
    the local checkpoint when there is one, else random init from a
    generator seeded with 0."""
    path = clip_weights_path(name)
    if path is not None:
        verify_clip_sha256(name, path)
        print(f"=> Loading CLIP weights from {path}")
        return load_clip_checkpoint(path, dtype=dtype, quant=quant)
    if not allow_random_init:
        raise FileNotFoundError(
            f"No CLIP weights for {name!r}. Set UML_CLIP_WEIGHTS_DIR to a "
            "directory containing the OpenAI checkpoint "
            f"({name.replace('/', '-')}.pt), or pass --allow-random-init "
            "for smoke testing.")
    print(f"=> [random-init] CLIP {name} (no pretrained weights found)")
    return build_clip(name, dtype=dtype, quant=quant).init_random(
        torch.Generator().manual_seed(0))


class StagedBatch(NamedTuple):
    """A uint8 batch on the device, flat [B, H*W*3], and the event its
    copy recorded on the copy stream (None on the CPU): the stream that
    reads ``pixels`` waits for ``copied`` first."""

    pixels: torch.Tensor
    copied: object = None


class PendingOutput:
    """A forward's output on its way to the host: ``out`` cast to fp32 on
    its stream, copied without blocking into pinned memory, and the event
    that marks the copy's end.  ``result()`` waits for the event before
    numpy reads the buffer -> float32 [n, ...]."""

    def __init__(self, out: torch.Tensor, n: int):
        self.n = n
        out = out.float()
        if out.is_cuda:
            self.host = torch.empty(out.shape, dtype=torch.float32,
                                    pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(out.device))
        else:
            self.host, self.done = out, None

    def result(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()[:self.n]


class _PinnedRing:
    """``slots`` pinned host buffers, reused in turn for the host->device
    copies of a copy stream.  Each slot keeps the event of the last copy
    out of it; a slot is rewritten only after that copy has ended."""

    def __init__(self, device, slots: int = 4):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.buffers = [None] * slots
        self.events = [None] * slots
        self.turn = 0

    def copy(self, flat: np.ndarray) -> StagedBatch:
        i = self.turn
        self.turn = (i + 1) % len(self.buffers)
        if self.events[i] is not None:
            self.events[i].synchronize()
        buf = self.buffers[i]
        if buf is None or buf.numel() < flat.size:
            buf = self.buffers[i] = torch.empty(flat.size, dtype=torch.uint8,
                                                pin_memory=True)
        host = buf[:flat.size].view(flat.shape)
        host.numpy()[...] = flat
        with torch.cuda.stream(self.stream):
            pixels = torch.empty(flat.shape, dtype=torch.uint8,
                                 device=self.device)
            pixels.copy_(host, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[i] = event
        return StagedBatch(pixels, event)


class ClipEncoder:
    """Image/text encoding with a frozen CLIP (ViT or RN tower) on one
    device.

    The image path is split as uml_tpu splits it (encoders.py:161-201):
    ``stage_images`` copies a uint8 batch to the device, and
    ``encode_staged`` dispatches the forward and returns the device
    output unfetched (cli/features.py reads it through a PendingOutput).
    On the card the host->device copy runs on a stream of its own, out of
    a ring of four pinned buffers that are reused (an event guards each
    reuse); the forward's stream waits for the copy's event.  ``encode_images`` / ``encode_texts`` return numpy
    (synchronous).  ``check_finite`` raises at the first batch with a
    non-finite feature (``--debug_nans``).

    ``model`` is the CLIP on ``device`` (fp32 parameters, forward in
    ``dtype``); the finetune CLI trains a copy of it on the full-model path.
    ``device`` defaults to the card (core.device.default_device);
    ``quant`` is the int8 serving mode (inference-only; the RN towers
    ignore it).
    """

    def __init__(self, name: str, dtype=torch.bfloat16,
                 allow_random_init: bool = False, device=None,
                 check_finite: bool = False, quant: str = "none"):
        self.name = name
        self.device = torch.device(device) if device is not None else default_device()
        self.model = load_clip(name, dtype, allow_random_init,
                               quant=quant).to(self.device).eval()
        self.check_finite = check_finite
        self._ring = None

    def stage_images(self, imgs_uint8: np.ndarray):
        """uint8 [B,H,W,3] -> (a StagedBatch of flat [B, H*W*3] uint8 on
        the device, B).  Transfer only: no forward is dispatched.  (No
        padding to a fixed batch: nothing here compiles per shape.)"""
        n = imgs_uint8.shape[0]
        flat = np.ascontiguousarray(imgs_uint8).reshape(n, -1)
        if self.device.type != "cuda":
            return StagedBatch(torch.from_numpy(flat)), n
        if self._ring is None:
            self._ring = _PinnedRing(self.device)
        return self._ring.copy(flat), n

    def _checked(self, out):
        if self.check_finite and not bool(torch.isfinite(out).all()):
            raise FloatingPointError(f"{self.name}: non-finite encoder output")
        return out

    def encode_staged(self, batch: StagedBatch, n: int,
                      return_tokens: bool = False):
        """Dispatch the forward on a staged batch -> (device output,
        n), unfetched.  The current stream waits for the batch's copy."""
        pixels = batch.pixels
        if batch.copied is not None:
            stream = torch.cuda.current_stream(pixels.device)
            stream.wait_event(batch.copied)
            pixels.record_stream(stream)
        with torch.no_grad():
            out = self.model.encode_image_u8(pixels, return_tokens=return_tokens)
        return self._checked(out), n

    def encode_images(self, imgs_uint8: np.ndarray,
                      return_tokens: bool = False) -> np.ndarray:
        """uint8 [B,H,W,3] -> features [B,D] (or tokens [B,S,W]) float32."""
        out, n = self.encode_staged(*self.stage_images(imgs_uint8),
                                    return_tokens=return_tokens)
        return PendingOutput(out, n).result()

    def encode_texts(self, texts: list[str], return_tokens: bool = False):
        """list[str] -> (features [N,D] | tokens [N,77,W], eot_indices [N])."""
        toks = torch.from_numpy(tokenize(texts).astype(np.int64)).to(self.device)
        with torch.no_grad():
            out, eot = self.model.encode_text(toks, return_eot=True,
                                              return_tokens=return_tokens)
        out = self._checked(out)
        return out.float().cpu().numpy(), eot.cpu().numpy().astype(np.int64)
