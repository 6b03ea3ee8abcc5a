"""MIMIC ingestion (im.pk imputed pickle).

The port of uml_tpu/data/mimic.py: host numpy, so the same code.

Capability parity with MultiBench/datasets/mimic/get_data.py:16-113:
  * ep_tdata timeseries [N, 24, 12] + adm_features_all static [N, 5];
    inf/nan -> 0; global standardization
  * task -1 -> 6-class mortality labels from adm_labels_all; task 0..19 ->
    binary icd9 label column
  * deterministic shuffle (random.seed(10)) then splits:
    valid = first 10%, test = 10-20%, train = 20%..end
  * 11-level robustness test variants (tabular + timeseries noise)
"""

from __future__ import annotations

import pickle
import random

import numpy as np

from uml_tpu_torch.data.robustness import add_tabular_noise, add_timeseries_noise


def load_mimic(imputed_path: str, task: int = -1):
    """-> dict(split -> {'static': [n,5], 'timeseries': [n,24,12],
    'labels': [n]}) plus robustness variants for the test split."""
    with open(imputed_path, "rb") as f:
        datafile = pickle.load(f)
    X_t = np.asarray(datafile["ep_tdata"], np.float64)
    X_s = np.asarray(datafile["adm_features_all"], np.float64)
    X_t[~np.isfinite(X_t)] = 0
    X_s[~np.isfinite(X_s)] = 0

    X_s = (X_s - X_s.mean(0)) / X_s.std(0)
    X_t = (X_t - X_t.mean((0, 1))) / X_t.std((0, 1))

    if task < 0:
        adm = np.asarray(datafile["adm_labels_all"])
        y = np.zeros(len(adm), dtype=np.int64)
        for col in range(5, 0, -1):  # later columns lose to earlier ones
            y[adm[:, col] > 0] = col
    else:
        y = np.asarray(datafile["y_icd9"])[:, task].astype(np.int64)

    n = len(y)
    order = list(range(n))
    random.seed(10)                      # parity: get_data.py:89-91
    random.shuffle(order)
    order = np.asarray(order)

    def subset(idx):
        return {
            "static": X_s[idx].astype(np.float32),
            "timeseries": X_t[idx].astype(np.float32),
            "labels": y[idx],
        }

    splits = {
        "valid": subset(order[: n // 10]),
        "test": subset(order[n // 10 : n // 5]),
        "train": subset(order[n // 5 :]),
    }
    return splits


def make_robust_tests(test_split: dict, levels: int = 11,
                      tabular_robust=True, timeseries_robust=True, seed=0):
    """11 noise-level variants of the test split (get_data.py:89-111)."""
    rng = np.random.RandomState(seed)
    out = []
    for level in range(levels):
        p = level / 10
        static = test_split["static"]
        ts = test_split["timeseries"]
        if tabular_robust:
            static = add_tabular_noise(static, p, rng=rng).astype(np.float32)
        if timeseries_robust:
            ts = np.stack(
                add_timeseries_noise([list(ts)], p, rng=rng)[0]
            ).astype(np.float32)
        out.append({"static": static, "timeseries": ts,
                    "labels": test_split["labels"]})
    return out


class MimicBatchStream:
    """Shuffled epoch batches: yields (static [B,5], timeseries [B,24,12],
    labels [B])."""

    def __init__(self, split: dict, batch_size: int, seed: int = 42,
                 shuffle: bool = True, drop_last: bool | None = None):
        self.split = split
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.drop_last = shuffle if drop_last is None else drop_last

    def num_batches(self):
        n = len(self.split["labels"])
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def epoch(self):
        n = len(self.split["labels"])
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(self.num_batches()):
            sel = idx[b * self.batch_size : (b + 1) * self.batch_size]
            yield (self.split["static"][sel], self.split["timeseries"][sel],
                   self.split["labels"][sel])
