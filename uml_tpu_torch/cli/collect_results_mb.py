"""MultiBench results aggregator.

The port of uml_tpu/cli/collect_results_mb.py: host code over the .pth
artifacts, so the same logic.

Capability parity with MultiBench/collect_results.py:4-89 (seed-averaged
metrics per config, best-val selection per (dataset, modality, ...) group
keyed on score_x / score_y / score_xy according to the trained modality).

The reference builds paths from nested loops using an ``alpha_y{v}``
segment that main.py never writes (it writes ``alpha_x{x}_alpha_y{y}``,
main.py:50) — its collector silently finds nothing.  This version globs
``**/seed_*/results.pth`` under the results root and parses the path
segments, so it reads whatever the trainer actually wrote.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import statistics
from collections import defaultdict

from uml_tpu_torch.data.feature_cache import load_cache

_SEGMENT_PATTERNS = {
    "dataset": re.compile(r"^log_(?P<v>.+)$"),
    "modality": re.compile(r"^mod(?P<v>.+)$"),
    "epochs": re.compile(r"^epochs(?P<v>.+)$"),
    "zdim": re.compile(r"^zdim(?P<v>.+)$"),
    "alphas": re.compile(r"^alpha_x(?P<x>[^_]+)_alpha_y(?P<v>.+)$"),
    "step_k": re.compile(r"^step_k(?P<v>.+)$"),
    "pos": re.compile(r"^pos_embd_(?P<v>.+)$"),
    "lr": re.compile(r"^lr(?P<v>.+)$"),
}


def parse_run_dir(path: str) -> dict:
    info = {}
    for seg in path.split(os.sep):
        for name, pat in _SEGMENT_PATTERNS.items():
            m = pat.match(seg)
            if m:
                info[name] = m.group("v")
    return info


def collect_results(experiments_dir: str, group_by=("dataset", "modality")):
    """-> {group key: {'best': seed-mean metrics of the best-val config,
    'configs': n configs seen}}."""
    runs = defaultdict(list)  # config dir -> list of per-seed results
    for path in glob.glob(os.path.join(experiments_dir, "**", "seed_*",
                                       "results.pth"), recursive=True):
        runs[os.path.dirname(os.path.dirname(path))].append(load_cache(path))

    grouped = defaultdict(list)
    for cfg_dir, seed_results in runs.items():
        # seed-mean every scalar metric
        merged = defaultdict(list)
        for sr in seed_results:
            for k, v in sr.items():
                if isinstance(v, (int, float)):
                    merged[k].append(float(v))
        mean = {k: statistics.mean(v) for k, v in merged.items()}
        info = parse_run_dir(cfg_dir)
        key = tuple(info.get(g, "?") for g in group_by)
        grouped[key].append((info, mean, len(seed_results)))

    summary = {}
    for key, entries in grouped.items():
        modality = key[group_by.index("modality")] if "modality" in group_by else "xy"
        metric = {"x": "val/score_x", "y": "val/score_y"}.get(modality,
                                                              "val/score_xy")
        entries = sorted(entries, key=lambda e: e[1].get(metric, -1.0),
                         reverse=True)
        info, best, n_seeds = entries[0]
        summary[key] = {"best": best, "config": info, "n_seeds": n_seeds,
                        "configs": len(entries)}
    return summary


def main():
    p = argparse.ArgumentParser(description="Collect MultiBench results")
    p.add_argument("--experiments_dir", default="results")
    p.add_argument("--group_by", nargs="+", default=["dataset", "modality"])
    args = p.parse_args()

    summary = collect_results(args.experiments_dir, tuple(args.group_by))
    for key in sorted(summary):
        info = summary[key]
        best = info["best"]
        print(f"Key: {key}  (configs={info['configs']}, seeds={info['n_seeds']})")
        for metric in ("test/score_x", "test/score_y", "test/score_xy",
                       "val/score_x", "val/score_y", "val/score_xy"):
            if metric in best:
                print(f"  {metric}: {best[metric]:.4f}")
        print()
    return summary


if __name__ == "__main__":
    main()
