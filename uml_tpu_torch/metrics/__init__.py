"""Representation-alignment metrics (the counterpart of uml_tpu.metrics)."""

from uml_tpu_torch.metrics.alignment import (
    AlignmentMetrics,
    cka,
    mutual_knn,
    cycle_knn,
    cknna,
    svcca,
    hsic_biased,
    hsic_unbiased,
    compute_nearest_neighbors,
    compute_effective_rank,
)

__all__ = [
    "AlignmentMetrics",
    "cka",
    "mutual_knn",
    "cycle_knn",
    "cknna",
    "svcca",
    "hsic_biased",
    "hsic_unbiased",
    "compute_nearest_neighbors",
    "compute_effective_rank",
]
