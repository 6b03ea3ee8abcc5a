"""Device choice: the counterpart of ``jax.default_backend()``.

CUDA when a card is visible, else the CPU.  On the CPU every op wrapper
takes its plain PyTorch version; on a CUDA tensor it launches its
hand-written kernel or raises.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def check_mesh_flag(mesh: str) -> None:
    """``--mesh``: uml_tpu runs data-parallel over every visible device
    under 'auto'.  The port runs on one device; a multi-device run is not
    ported yet, so it raises instead of silently using one card."""
    if mesh == "auto" and torch.cuda.device_count() > 1:
        raise SystemExit(
            f"--mesh auto sees {torch.cuda.device_count()} CUDA devices; "
            "multi-device extraction is not ported yet. Pass --mesh off "
            "(or expose one card with CUDA_VISIBLE_DEVICES).")
