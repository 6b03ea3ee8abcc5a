"""Representation-alignment metrics the supervised loop logs, in torch.

The port of the part of uml_tpu/metrics/alignment.py (:46-135) that
train/supervised.py uses per iteration: ``compute_nearest_neighbors``,
``hsic_biased``, ``cka`` and ``mutual_knn`` (the reference's
vision_language/metrics.py:55-119, 252-285).  The rest of the suite
(cycle_knn, lcs_knn, cknna, svcca, ...) comes later.

Ties: ``torch.topk`` and ``jax.lax.top_k`` may order equal similarities
differently, so two rows with tied neighbours can give a different kNN
set; the tests use tie-free (continuous random) inputs.
"""

from __future__ import annotations

import torch

_DIAG_NEG = -1e8


def compute_nearest_neighbors(feats: torch.Tensor, topk: int = 1) -> torch.Tensor:
    """Top-k neighbours by inner product, excluding self (the diagonal is
    set to -1e8, metrics.py:272-285) -> int64 [N, topk]."""
    if feats.dim() != 2:
        raise ValueError(f"Expected feats to be 2D, got {feats.dim()}")
    sims = feats @ feats.T
    n = sims.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=sims.device)
    sims = sims.masked_fill(eye, _DIAG_NEG)
    return torch.topk(sims, topk, dim=1).indices


def _knn_mask(knn: torch.Tensor, n: int) -> torch.Tensor:
    """Binary [N, N] fp32 mask with 1 at each row's top-k neighbour columns."""
    mask = torch.zeros(knn.shape[0], n, device=knn.device)
    return mask.scatter_(1, knn, 1.0)


def hsic_biased(K: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Biased HSIC = trace(K H L H), in the centered O(N^2) form."""

    def center(m):
        return m - m.mean(0, keepdim=True) - m.mean(1, keepdim=True) + m.mean()

    return torch.sum(center(K) * center(L))


def cka(feats_A: torch.Tensor, feats_B: torch.Tensor,
        kernel_metric: str = "ip") -> torch.Tensor:
    """Centered Kernel Alignment with the inner-product kernel
    (metrics.py:96-119); the rbf and unbiased variants come later."""
    if kernel_metric != "ip":
        raise ValueError(f"kernel metric {kernel_metric!r}: only 'ip' is "
                         "ported")
    K = feats_A @ feats_A.T
    L = feats_B @ feats_B.T
    return hsic_biased(K, L) / (torch.sqrt(hsic_biased(K, K) * hsic_biased(L, L))
                                + 1e-6)


def mutual_knn(feats_A: torch.Tensor, feats_B: torch.Tensor,
               topk: int) -> torch.Tensor:
    """Mutual kNN accuracy (metrics.py:55-84)."""
    n = feats_A.shape[0]
    mask_a = _knn_mask(compute_nearest_neighbors(feats_A, topk), n)
    mask_b = _knn_mask(compute_nearest_neighbors(feats_B, topk), n)
    return ((mask_a * mask_b).sum(1) / topk).mean()
