"""The port's metrics/alignment.py against uml_tpu's, metric by metric,
through both ``AlignmentMetrics.measure`` facades and the functions under
them, at the tolerance of tests/test_metrics.py (abs 1e-4).  ``svcca`` is
compared by its score: its singular vectors' signs differ between LAPACK
builds, the mean canonical correlation does not.  Inputs are continuous
random (no kNN ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.metrics import alignment as jal
from uml_tpu_torch.metrics import alignment as tal

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _feats(seed, n=48, d=32, mix=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if mix is not None:   # a noisy copy of another draw: correlated features
        x = mix + 0.5 * x
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


A = _feats(0)
PAIRS = {"independent": (A, _feats(1)), "correlated": (A, _feats(2, mix=A)),
         "self": (A, A)}

CASES = [
    ("cka", {}), ("cka", {"kernel_metric": "rbf", "rbf_sigma": 0.8}),
    ("cka", {"unbiased": True}), ("unbiased_cka", {}),
    ("mutual_knn", {"topk": 5}), ("cycle_knn", {"topk": 5}),
    ("cknna", {"topk": 10}), ("cknna", {}), ("cknna", {"topk": 6, "unbiased": False}),
    ("cknna", {"topk": 6, "distance_agnostic": True}),
    ("svcca", {"cca_dim": 8}), ("lcs_knn", {"topk": 6}),
    ("edit_distance_knn", {"topk": 6}),
]


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("metric,kw", CASES, ids=[f"{m}-{i}" for i, (m, _) in enumerate(CASES)])
def test_measure_matches_uml_tpu(metric, kw, pair):
    a, b = PAIRS[pair]
    want = jal.AlignmentMetrics.measure(metric, a, b, **kw)
    got = tal.AlignmentMetrics.measure(metric, a, b, **kw)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=ATOL), (metric, kw, pair)
    # a torch tensor goes in as it is
    again = tal.AlignmentMetrics.measure(metric, torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert again == pytest.approx(got, abs=1e-6)


def test_hsic_and_neighbours_match_uml_tpu():
    a, b = PAIRS["correlated"]
    K, L = a @ a.T, b @ b.T
    for name in ("hsic_biased", "hsic_unbiased"):
        want = float(getattr(jal, name)(jnp.asarray(K), jnp.asarray(L)))
        got = float(getattr(tal, name)(torch.from_numpy(K), torch.from_numpy(L)))
        assert got == pytest.approx(want, rel=1e-5, abs=1e-6), name
    for topk in (1, 4):
        np.testing.assert_array_equal(
            tal.compute_nearest_neighbors(torch.from_numpy(a), topk).numpy(),
            np.asarray(jal.compute_nearest_neighbors(jnp.asarray(a), topk)))


@pytest.mark.parametrize("rank", [1, 5, 32])
def test_effective_rank_matches_uml_tpu(rank):
    rng = np.random.default_rng(rank)
    x = (rng.standard_normal((96, rank)) @ rng.standard_normal((rank, 32))).astype(np.float32)
    x[60:] = 0.0   # zeroed padding rows, as the train step masks them
    want = float(jal.compute_effective_rank(jnp.asarray(x)))
    got = float(tal.compute_effective_rank(torch.from_numpy(x)))
    assert got == pytest.approx(want, rel=1e-5)


def test_unknown_metric_and_small_topk_raise():
    with pytest.raises(ValueError):
        tal.AlignmentMetrics.measure("nope", A, A)
    with pytest.raises(ValueError):
        tal.AlignmentMetrics.measure("cknna", A, A, topk=1)
    with pytest.raises(ValueError):
        tal.AlignmentMetrics.measure("cka", A, A, kernel_metric="cosine")
    assert tal.AlignmentMetrics.SUPPORTED_METRICS == jal.AlignmentMetrics.SUPPORTED_METRICS
