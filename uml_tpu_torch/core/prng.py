"""Random streams (the port of uml_tpu/core/prng.py).

Device-side randomness comes from an explicit ``torch.Generator`` seeded
from the experiment seed (uml_tpu's root ``jax.random`` key); host-side
sampling (shuffle orders that must match the reference byte for byte)
uses seeded numpy generators, the same streams as uml_tpu's.  ``torch``
is imported inside ``make_rng`` only: the image loader's spawned decode
workers import this module and never torch.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:
    import torch


def make_rng(seed: int, device=None) -> torch.Generator:
    """The root generator of an experiment (on ``device``, default CPU)."""
    import torch

    return torch.Generator(device=device or "cpu").manual_seed(seed)


def host_rng(seed: int) -> np.random.Generator:
    """An independent host-side generator (shuffle orders, augment draws)."""
    return np.random.default_rng(seed)


def epoch_perm(rng: np.random.Generator, n: int) -> np.ndarray:
    """A fresh shuffle of [0, n): one stream per loader, which is how the
    reference realizes "unpairedness" (two shuffled DataLoaders zipped,
    MultiBench/main.py:70-71)."""
    return rng.permutation(n)
