"""Representation-alignment metric suite, in torch.

The port of uml_tpu/metrics/alignment.py (the reference's
vision_language/metrics.py:15-308 and MultiBench/metrics.py): the kernel
metrics run as torch functions on whatever device their inputs lie on
(the supervised and self-supervised loops call them on the card), the
integer-sequence metrics (``lcs_knn``, ``edit_distance_knn``) run their
DP on the host, and ``AlignmentMetrics`` keeps the reference's
``measure(metric, A, B, **kw)`` string dispatch, returning Python floats.

As in uml_tpu: biased HSIC in the centered O(N^2) form; kNN by the
self-similarity Gram with the diagonal at -1e8; ``svcca`` by exact thin
SVDs and classical CCA (whitened cross-covariance SVD), not the
reference's randomized SVD + NIPALS; ``compute_effective_rank`` =
exp(entropy of the normalized singular values) (MultiBench/utilis.py:27-36).

Ties: ``torch.topk`` and ``jax.lax.top_k`` may order equal similarities
differently, so two rows with tied neighbours can give a different kNN
set; the tests use tie-free (continuous random) inputs.  ``svcca``'s
singular vectors differ in sign between LAPACK builds; its score does not.
"""

from __future__ import annotations

import numpy as np
import torch

_DIAG_NEG = -1e8


# ---------------------------------------------------------------------------
# kNN helpers
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# HSIC
# ---------------------------------------------------------------------------


def hsic_biased(K: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Biased HSIC = trace(K H L H), in the centered O(N^2) form."""

    def center(m):
        return m - m.mean(0, keepdim=True) - m.mean(1, keepdim=True) + m.mean()

    return torch.sum(center(K) * center(L))


def hsic_unbiased(K: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Unbiased HSIC estimator (Song et al. 2012, eq. 5; metrics.py:230-249)."""
    m = K.shape[0]
    eye = torch.eye(m, dtype=torch.bool, device=K.device)
    K_t = K.masked_fill(eye, 0.0)
    L_t = L.masked_fill(eye, 0.0)
    term1 = torch.sum(K_t * L_t.T)
    term2 = torch.sum(K_t) * torch.sum(L_t) / ((m - 1) * (m - 2))
    term3 = 2 * torch.sum(K_t @ L_t) / (m - 2)
    return (term1 + term2 - term3) / (m * (m - 3))


# ---------------------------------------------------------------------------
# Metric cores (0-d tensors; the facade converts to float)
# ---------------------------------------------------------------------------


def cka(feats_A: torch.Tensor, feats_B: torch.Tensor, kernel_metric: str = "ip",
        rbf_sigma: float = 1.0, unbiased: bool = False) -> torch.Tensor:
    """Centered Kernel Alignment (metrics.py:96-119)."""
    if kernel_metric == "ip":
        K = feats_A @ feats_A.T
        L = feats_B @ feats_B.T
    elif kernel_metric == "rbf":
        d2_A = torch.sum((feats_A[:, None, :] - feats_A[None, :, :]) ** 2, -1)
        d2_B = torch.sum((feats_B[:, None, :] - feats_B[None, :, :]) ** 2, -1)
        K = torch.exp(-d2_A / (2 * rbf_sigma ** 2))
        L = torch.exp(-d2_B / (2 * rbf_sigma ** 2))
    else:
        raise ValueError(f"Invalid kernel metric {kernel_metric}")
    hsic_fn = hsic_unbiased if unbiased else hsic_biased
    return hsic_fn(K, L) / (torch.sqrt(hsic_fn(K, K) * hsic_fn(L, L)) + 1e-6)


def mutual_knn(feats_A: torch.Tensor, feats_B: torch.Tensor,
               topk: int) -> torch.Tensor:
    """Mutual kNN accuracy (metrics.py:55-84)."""
    n = feats_A.shape[0]
    mask_a = _knn_mask(compute_nearest_neighbors(feats_A, topk), n)
    mask_b = _knn_mask(compute_nearest_neighbors(feats_B, topk), n)
    return ((mask_a * mask_b).sum(1) / topk).mean()


def cycle_knn(feats_A: torch.Tensor, feats_B: torch.Tensor,
              topk: int) -> torch.Tensor:
    """kNN cycle accuracy: the A-neighbours of a row's B-neighbours contain
    the row (metrics.py:39-51, compute_knn_accuracy:258-269)."""
    knn_A = compute_nearest_neighbors(feats_A, topk)
    knn_B = compute_nearest_neighbors(feats_B, topk)
    cyc = knn_A[knn_B]  # [N, topk, topk]
    n = cyc.shape[0]
    hit = cyc == torch.arange(n, device=cyc.device)[:, None, None]
    return hit.reshape(n, -1).any(dim=1).float().mean()


def cknna(feats_A: torch.Tensor, feats_B: torch.Tensor, topk: int,
          distance_agnostic: bool = False, unbiased: bool = True) -> torch.Tensor:
    """CKA restricted to mutual-nearest-neighbour entries (metrics.py:180-227)."""
    n = feats_A.shape[0]
    if topk < 2:
        raise ValueError("CKNNA requires topk >= 2")
    K = feats_A @ feats_A.T
    L = feats_B @ feats_B.T
    eye = torch.eye(n, dtype=torch.bool, device=K.device)

    def similarity(K, L):
        K_hat = K.masked_fill(eye, float("-inf")) if unbiased else K
        L_hat = L.masked_fill(eye, float("-inf")) if unbiased else L
        idx_K = torch.topk(K_hat, topk, dim=1).indices
        idx_L = torch.topk(L_hat, topk, dim=1).indices
        mask = _knn_mask(idx_K, n) * _knn_mask(idx_L, n)
        if distance_agnostic:
            return torch.sum(mask)
        hsic_fn = hsic_unbiased if unbiased else hsic_biased
        return hsic_fn(mask * K, mask * L)

    sim_kl = similarity(K, L)
    sim_kk = similarity(K, K)
    sim_ll = similarity(L, L)
    return sim_kl / (torch.sqrt(sim_kk * sim_ll) + 1e-6)


def svcca(feats_A: torch.Tensor, feats_B: torch.Tensor,
          cca_dim: int = 10) -> torch.Tensor:
    """SVCCA: SVD to ``cca_dim``, then the mean canonical correlation
    (metrics.py:129-160, by exact thin SVD and classical CCA)."""

    def preprocess(act):
        act = act - act.mean(0)
        return act / (act.std(0, correction=0) + 1e-8)

    def top_left_singular(act, q):
        U, _, _ = torch.linalg.svd(act, full_matrices=False)
        return U[:, :q]

    U1 = top_left_singular(preprocess(feats_A), cca_dim)
    U2 = top_left_singular(preprocess(feats_B), cca_dim)
    U1 = U1 - U1.mean(0)
    U2 = U2 - U2.mean(0)
    S11, S22, S12 = U1.T @ U1, U2.T @ U2, U1.T @ U2
    eps = 1e-8 * torch.eye(cca_dim, dtype=U1.dtype, device=U1.device)

    def inv_sqrt(S):
        w, V = torch.linalg.eigh(S + eps)
        return (V * torch.rsqrt(torch.clamp(w, min=1e-12))) @ V.T

    T = inv_sqrt(S11) @ S12 @ inv_sqrt(S22)
    corrs = torch.linalg.svdvals(T)
    return torch.clamp(corrs, 0.0, 1.0).mean()


def compute_effective_rank(feats: torch.Tensor) -> torch.Tensor:
    """exp(entropy of the normalized singular values)
    (MultiBench/utilis.py:27-36, the spectral-diversity diagnostic).
    Non-finite ``feats`` give NaN, as jnp.linalg.svd does (torch's SVD
    raises on them), so a diverged step reports NaN instead of stopping
    the run."""
    finite = torch.isfinite(feats).all()
    s = torch.linalg.svdvals(torch.where(finite, feats, torch.zeros_like(feats)))
    p = s / (torch.sum(s) + 1e-12)
    entropy = -torch.sum(torch.where(p > 0, p * torch.log(p + 1e-12),
                                     torch.zeros_like(p)))
    return torch.where(finite, torch.exp(entropy), float("nan"))


# ---------------------------------------------------------------------------
# Host-side integer-sequence metrics (diagnostics)
# ---------------------------------------------------------------------------


def _lcs_length(x: np.ndarray, y: np.ndarray) -> int:
    m, n = len(x), len(y)
    dp = np.zeros((m + 1, n + 1), dtype=np.int64)
    for i in range(1, m + 1):
        match = x[i - 1] == y
        for j in range(1, n + 1):
            dp[i, j] = (
                dp[i - 1, j - 1] + 1 if match[j - 1] else max(dp[i - 1, j], dp[i, j - 1])
            )
    return int(dp[m, n])


def _edit_distance(x: np.ndarray, y: np.ndarray) -> int:
    m, n = len(x), len(y)
    dp = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        prev = dp.copy()
        dp[0] = i
        for j in range(1, n + 1):
            cost = 0 if x[i - 1] == y[j - 1] else 1
            dp[j] = min(prev[j] + 1, dp[j - 1] + 1, prev[j - 1] + cost)
    return int(dp[n])


def _knn_lists(feats_A, feats_B, topk):
    return (compute_nearest_neighbors(feats_A, topk).cpu().numpy(),
            compute_nearest_neighbors(feats_B, topk).cpu().numpy())


def lcs_knn(feats_A, feats_B, topk: int) -> float:
    """Mean longest-common-subsequence length of the two kNN lists
    (metrics.py:88-92, longest_ordinal_sequence:288-308)."""
    knn_A, knn_B = _knn_lists(feats_A, feats_B, topk)
    return float(np.mean([_lcs_length(a, b) for a, b in zip(knn_A, knn_B)]))


def edit_distance_knn(feats_A, feats_B, topk: int) -> float:
    """1 - mean(edit distance) / topk of the two kNN lists
    (metrics.py:164-176)."""
    knn_A, knn_B = _knn_lists(feats_A, feats_B, topk)
    dists = [_edit_distance(a, b) for a, b in zip(knn_A, knn_B)]
    return 1.0 - float(np.mean(dists)) / topk


# ---------------------------------------------------------------------------
# Facade with the reference's string-dispatch API
# ---------------------------------------------------------------------------


class AlignmentMetrics:
    """String-dispatch facade matching the reference API.

    ``AlignmentMetrics.measure('cka', A, B, kernel_metric='ip')`` etc.
    Accepts numpy arrays and torch tensors (a tensor stays on its device,
    as fp32); returns Python floats like the reference (``.item()``).
    """

    SUPPORTED_METRICS = [
        "cycle_knn",
        "mutual_knn",
        "lcs_knn",
        "cka",
        "unbiased_cka",
        "cknna",
        "svcca",
        "edit_distance_knn",
    ]

    @staticmethod
    def _to_tensor(x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.detach().float()
        return torch.as_tensor(np.asarray(x, dtype=np.float32))

    @staticmethod
    def measure(metric: str, feats_A, feats_B, **kwargs) -> float:
        if metric not in AlignmentMetrics.SUPPORTED_METRICS:
            raise ValueError(f"Unrecognized metric: {metric}")
        return getattr(AlignmentMetrics, metric)(feats_A, feats_B, **kwargs)

    @staticmethod
    def cka(feats_A, feats_B, kernel_metric="ip", rbf_sigma=1.0, unbiased=False):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return float(cka(A, B, kernel_metric, rbf_sigma, unbiased))

    @staticmethod
    def unbiased_cka(feats_A, feats_B, **kwargs):
        kwargs["unbiased"] = True
        return AlignmentMetrics.cka(feats_A, feats_B, **kwargs)

    @staticmethod
    def mutual_knn(feats_A, feats_B, topk):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return float(mutual_knn(A, B, topk))

    @staticmethod
    def cycle_knn(feats_A, feats_B, topk):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return float(cycle_knn(A, B, topk))

    @staticmethod
    def cknna(feats_A, feats_B, topk=None, distance_agnostic=False, unbiased=True):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        if topk is None:
            topk = A.shape[0] - 1
        return float(cknna(A, B, topk, distance_agnostic, unbiased))

    @staticmethod
    def svcca(feats_A, feats_B, cca_dim=10):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return float(svcca(A, B, cca_dim))

    @staticmethod
    def lcs_knn(feats_A, feats_B, topk):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return lcs_knn(A, B, topk)

    @staticmethod
    def edit_distance_knn(feats_A, feats_B, topk):
        A, B = AlignmentMetrics._to_tensor(feats_A), AlignmentMetrics._to_tensor(feats_B)
        return edit_distance_knn(A, B, topk)
