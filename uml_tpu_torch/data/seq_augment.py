"""Sequence augmentations for self-supervised training.

The port of uml_tpu/data/seq_augment.py: host numpy, so the same code.

Capability parity with MultiBench/utilis.py:41-112: per-sequence transforms
(permute steps, gaussian noise, 20% step dropout, mixup) and the two-view /
single-view samplers used for contrastive variants.  numpy implementations
operating on [T, D] sequences or [B, T, D] batches.
"""

from __future__ import annotations

import numpy as np


def permute(x, rng=None):
    """Shuffle the time order of a [T, ...] sequence."""
    rng = rng or np.random
    return x[rng.permutation(x.shape[0])]


def noise(x, rng=None, scale=0.1):
    rng = rng or np.random
    return x + rng.standard_normal(x.shape).astype(x.dtype) * scale


def drop(x, rng=None):
    """Zero out 20% of the time steps."""
    rng = rng or np.random
    out = np.array(x)
    n_drop = x.shape[0] // 5
    idx = rng.choice(x.shape[0], n_drop, replace=False)
    out[idx] = 0.0
    return out


def mixup(x, rng=None, alpha=1.0):
    """Mix each sequence with a random other along the leading axis."""
    rng = rng or np.random
    lam = rng.beta(alpha, alpha)
    indices = rng.permutation(x.shape[0])
    return x * lam + x[indices] * (1 - lam)


def identity(x, rng=None):
    return x


_SEQ_TRANSFORMS = (permute, noise, drop, identity)
_EMBED_TRANSFORMS = (noise, mixup, identity)


def augment(x_batch, rng=None):
    """Two independently-augmented views of each sequence (utilis.py:70-82)."""
    rng = rng or np.random
    v1 = np.array(x_batch)
    v2 = np.array(x_batch)
    for i in range(len(x_batch)):
        t1, t2 = rng.choice(4, 2, replace=False)
        v1[i] = _SEQ_TRANSFORMS[t1](v1[i], rng)
        v2[i] = _SEQ_TRANSFORMS[t2](v2[i], rng)
    return v1, v2


def augment_single(x_batch, rng=None):
    """One augmented view per sequence (utilis.py:84-94)."""
    rng = rng or np.random
    v2 = np.array(x_batch)
    for i in range(len(x_batch)):
        t = _SEQ_TRANSFORMS[int(rng.choice(4))]
        v2[i] = t(v2[i], rng)
    return v2


def augment_embed_single(x_batch, rng=None):
    """Batch-level embedding augmentation (utilis.py:97-106)."""
    rng = rng or np.random
    t = _EMBED_TRANSFORMS[int(rng.choice(3))]
    return t(np.array(x_batch), rng)


def augment_mimic(x_batch, rng=None):
    """Static [B, D] -> embed aug; sequences [B, T, D] -> per-seq aug."""
    if np.ndim(x_batch) == 2:
        return augment_embed_single(x_batch, rng)
    return augment_single(x_batch, rng)
