"""Device choice: the counterpart of ``jax.default_backend()``.

The entry points run on the card.  ``default_device()`` returns ``cuda``
and raises when no card is visible, unless the caller asked for the CPU
with ``UML_TORCH_DEVICE=cpu`` (the counterpart of ``JAX_PLATFORMS=cpu``);
a machine whose CUDA is broken never carries on on the CPU unasked.  A
per-call ``device=`` (e.g. ``ClipEncoder(device="cpu")``) overrides it.
On a CPU tensor every op wrapper takes its plain PyTorch version; on a
CUDA tensor it launches its hand-written kernel or raises.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "UML_TORCH_DEVICE"


def default_device() -> torch.device:
    want = os.environ.get(DEVICE_ENV, "cuda") or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"{DEVICE_ENV}={want!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: uml_tpu_torch runs on an NVIDIA GPU; "
            f"set {DEVICE_ENV}=cpu to run on the CPU (the plain PyTorch "
            "versions of the kernels)")
    return torch.device("cuda")

