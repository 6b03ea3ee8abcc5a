"""Seeding / determinism discipline.

The reference enforces correctness purely through determinism (seeding of
python/numpy/torch RNGs: engine/tools/utils.py:26-32, MultiBench/utilis.py:8-16).
The port seeds python/numpy for the host-side split/sampling machinery
whose outputs must match the reference exactly (few-shot index JSONs), and
torch's global generator; model random-init takes its own explicit
``torch.Generator``.
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    """Seed every host RNG that influences data sampling order."""
    os.environ.setdefault("PYTHONHASHSEED", str(seed))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def cname2lab(lab2cname: dict[int, str]) -> dict[str, int]:
    """Invert a label->classname map to lowercase_underscored name->label.

    Parity with engine/tools/utils.py:120-123.
    """
    return {v.lower().replace(" ", "_"): k for k, v in lab2cname.items()}
