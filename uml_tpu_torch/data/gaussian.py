"""Synthetic linear data-generating process for the UML theory experiments.

The port of uml_tpu/data/gaussian.py: numpy end to end, so the pools and
every index are bit-equal to uml_tpu's.  Re-implements the reference DGP
(Gaussian_experiment/data.py:7-61):

  X = (theta_c * attenuation_mask) @ A_c^T + theta_x @ A_x^T + eps_x
  Y =  theta_c                     @ B_c^T + theta_y @ B_y^T + eps_y

with a shared latent ``theta_c`` (gaussian / gmm / laplace), per-modality
private latents, iid projection matrices and observation noise.  The
attenuation mask keeps the first 10% of shared dims at 1.0 and scales the
rest by ``attenuation`` — only X is attenuated (data.py:48-53).

The "unpaired" batching contract (Gaussian_experiment/dataset.py:3-18 +
main.py:131-143): X and Y pools are modulo-index paired, batches are drawn
from one shuffled index stream with drop_last semantics.  The UML losses
never compare x_i to y_i, so only the batch *composition* matters; we keep
the single shuffled stream for faithfulness.

Pools are generated once on the host and moved to the device once; the
training loop (train/gaussian.py) gathers each batch by index there.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def sample_latent(
    rng: np.random.Generator,
    num_samples: int,
    dim: int,
    dist_type: str = "gaussian",
    n_clusters: int = 10,
) -> np.ndarray:
    """Shared-latent sampler. Parity with data.py:7-24 (incl. centering)."""
    if dist_type == "gaussian":
        latents = rng.standard_normal((num_samples, dim))
        return latents - latents.mean(0)
    if dist_type == "gmm":
        centroids = rng.standard_normal((n_clusters, dim)) * 5.0
        cluster_ids = rng.integers(0, n_clusters, size=num_samples)
        noise = rng.standard_normal((num_samples, dim)) * 0.5
        latents = centroids[cluster_ids] + noise
        return latents - latents.mean(0)
    if dist_type == "laplace":
        # Laplace(0, 1); not centered, matching the reference (data.py:20-22)
        return rng.laplace(0.0, 1.0, size=(num_samples, dim))
    raise ValueError(f"Unsupported distribution type: {dist_type}")


def generate_data(configs: dict) -> dict[str, np.ndarray]:
    """Generate an unpaired (X, Y) pool. Parity with data.py:29-61.

    configs keys: seed, num_samples, dim_c, dim_x, dim_y, dim_obs, noise_std,
    attenuate_x, attenuation, shared_latent_distribution_type.
    """
    rng = np.random.default_rng(configs["seed"])
    n = configs["num_samples"]

    theta_c = sample_latent(
        rng, n, configs["dim_c"],
        dist_type=configs.get("shared_latent_distribution_type", "gaussian"),
        n_clusters=10,
    )
    theta_x = rng.standard_normal((n, configs["dim_x"]))
    theta_y = rng.standard_normal((n, configs["dim_y"]))

    noise_x = rng.standard_normal((n, configs["dim_obs"])) * configs["noise_std"]
    noise_y = rng.standard_normal((n, configs["dim_obs"])) * configs["noise_std"]

    A_c = rng.standard_normal((configs["dim_obs"], configs["dim_c"]))
    A_x = rng.standard_normal((configs["dim_obs"], configs["dim_x"]))
    B_c = rng.standard_normal((configs["dim_obs"], configs["dim_c"]))
    B_y = rng.standard_normal((configs["dim_obs"], configs["dim_y"]))

    if configs["attenuate_x"]:
        attenuation = np.full((configs["dim_c"],), configs["attenuation"])
        attenuation[: int(configs["dim_c"] * 0.1)] = 1.0
        theta_c_x = theta_c * attenuation
    else:
        theta_c_x = theta_c

    data_x = theta_c_x @ A_c.T + theta_x @ A_x.T + noise_x
    data_y = theta_c @ B_c.T + theta_y @ B_y.T + noise_y
    return {
        "x": data_x.astype(np.float32),
        "y": data_y.astype(np.float32),
    }


class UnpairedIndexStream:
    """Shuffled modulo-index batches over two independently-sized pools.

    Mirrors DataLoader(UnpairedDataset, shuffle=True, drop_last=True)
    (main.py:141-143): one seeded shuffle over max(len_x, len_y) indices
    per epoch, each index mapped modulo into both pools.
    Yields (idx_x, idx_y) int32 arrays of shape [batch_size].
    """

    def __init__(self, len_x: int, len_y: int, batch_size: int, seed: int = 42):
        self.len_x = len_x
        self.len_y = len_y
        self.length = max(len_x, len_y)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def batches(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One epoch of batches (drop_last)."""
        perm = self.rng.permutation(self.length)
        n_batches = self.length // self.batch_size
        for b in range(n_batches):
            idx = perm[b * self.batch_size : (b + 1) * self.batch_size]
            yield (idx % self.len_x).astype(np.int32), (idx % self.len_y).astype(np.int32)

    def batch_chunks(self, num_steps: int, chunk: int):
        """Group ``num_steps`` batches (cycling epochs) into pairs of
        [chunk, bs] int64 index arrays (the last chunk may be shorter)."""
        it = self.batches()
        buf_x, buf_y = [], []
        produced = 0
        while produced < num_steps:
            try:
                ix, iy = next(it)
            except StopIteration:
                it = self.batches()
                continue
            buf_x.append(ix)
            buf_y.append(iy)
            produced += 1
            if len(buf_x) == chunk or produced == num_steps:
                yield (np.stack(buf_x).astype(np.int64),
                       np.stack(buf_y).astype(np.int64))
                buf_x, buf_y = [], []
