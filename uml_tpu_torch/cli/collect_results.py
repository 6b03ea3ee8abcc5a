"""Results aggregator over finetune sweep artifacts.

The port of uml_tpu/cli/collect_results.py: host code over the .pth
artifacts (it reads only their scalars and hparams), so the same logic.
Capability parity with vision_language/collect_results.py:14-129: scans
``experiments/{dataset}-shot_{shot}-seed_{seed}/{encoder}/{modality}/{init}/
results.pth``, picks each seed's best-val hparams, and reports mean/std of
val/test accuracy across seeds per experiment key, plus the best seed's
hparams and test_result.pth path.
"""

from __future__ import annotations

import argparse
import os
import statistics

from uml_tpu_torch.cli.finetune import hparam_str as _finetune_hparam_str
from uml_tpu_torch.data.feature_cache import load_cache


def hparam_str(optim, lr, wd, batch_size, iters, dropout, learnable_temp,
               model_str=None):
    """finetune's directory naming + optional model_str suffix — delegated
    so the two can never drift apart (best_path must resolve what the
    finetune CLI wrote)."""
    base = _finetune_hparam_str(optim, lr, wd, batch_size, iters, dropout,
                                learnable_temp)
    if model_str is not None:
        base += f"-{model_str}"
    return base


def _aslist(x):
    return x if isinstance(x, list) else [x]


def collect_results(datasets, seeds, encoders, train_shots, init_types,
                    modality_types, experiments_dir="experiments",
                    text_datasets=()):
    datasets, seeds, encoders = _aslist(datasets), _aslist(seeds), _aslist(encoders)
    train_shots, init_types = _aslist(train_shots), _aslist(init_types)
    modality_types = _aslist(modality_types)
    text_datasets = list(text_datasets) or [""]

    raw: dict = {}
    for dataset in datasets:
        for text_ds in text_datasets:
            for shot in train_shots:
                for seed in seeds:
                    benchname = (f"{dataset}-{text_ds}-shot_{shot}-seed_{seed}"
                                 if text_ds else
                                 f"{dataset}-shot_{shot}-seed_{seed}")
                    seed_dir = os.path.join(experiments_dir, benchname)
                    if not os.path.isdir(seed_dir):
                        continue
                    for encoder in encoders:
                        for modality in modality_types:
                            for init in init_types:
                                results_file = os.path.join(
                                    seed_dir, encoder, modality, init,
                                    "results.pth")
                                if not os.path.isfile(results_file):
                                    continue
                                res = load_cache(results_file)
                                key = ((dataset, text_ds, encoder, str(shot),
                                        init, modality) if text_ds else
                                       (dataset, encoder, str(shot), init,
                                        modality))
                                raw.setdefault(key, []).append(
                                    (int(seed), res, results_file))

    summary = {}
    for key, entries in raw.items():
        vals, tests = [], []
        for seed, res, _ in entries:
            best_i = max(range(len(res["val_acc"])),
                         key=lambda i: res["val_acc"][i])
            vals.append(res["val_acc"][best_i])
            tests.append(res["test_acc"][best_i])

        best_seed, best_res, best_path = max(
            entries, key=lambda t: max(t[1]["val_acc"]))
        best_i = max(range(len(best_res["val_acc"])),
                     key=lambda i: best_res["val_acc"][i])
        best_hparams = best_res["hparams"][best_i]
        model_str = None
        if best_hparams.get("pos_embd") is not None or \
                best_hparams.get("pos_learnable") is not None:
            model_str = (f"pos_embd_{best_hparams.get('pos_embd')}"
                         f"-pos_learnable_{best_hparams.get('pos_learnable')}")
        best_path = os.path.join(
            os.path.dirname(best_path),
            hparam_str(best_hparams["optim"], best_hparams["lr"],
                       best_hparams["weight_decay"], best_hparams["batch_size"],
                       best_hparams["max_iter"], best_hparams.get("dropout"),
                       best_hparams.get("learnable_temp"), model_str),
            "test_result.pth")

        summary[key] = {
            "mean_val_acc": statistics.mean(vals),
            "std_val_acc": statistics.stdev(vals) if len(vals) > 1 else 0.0,
            "mean_test_acc": statistics.mean(tests),
            "std_test_acc": statistics.stdev(tests) if len(tests) > 1 else 0.0,
            "n_seeds": len(entries),
            "best_seed": best_seed,
            "best_hparams": best_hparams,
            "best_path": best_path,
        }
    return summary


def main():
    p = argparse.ArgumentParser(description="Collect finetune sweep results")
    p.add_argument("--experiments_dir", default="experiments")
    p.add_argument("--datasets", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--encoders", nargs="+", required=True)
    p.add_argument("--train_shots", nargs="+", type=int, default=[16])
    p.add_argument("--init_types", nargs="+", default=["zeroshot"])
    p.add_argument("--modality_types", nargs="+", required=True)
    args = p.parse_args()

    summary = collect_results(
        args.datasets, args.seeds, args.encoders, args.train_shots,
        args.init_types, args.modality_types, args.experiments_dir)
    header = (f"{'Key':<90} {'Test':>8} {'±':>6} {'Val':>8} {'±':>6} {'n':>3}")
    print(header)
    print("-" * len(header))
    for key in sorted(summary):
        info = summary[key]
        print(f"{str(key):<90} {info['mean_test_acc']:8.4f} "
              f"{info['std_test_acc']:6.4f} {info['mean_val_acc']:8.4f} "
              f"{info['std_val_acc']:6.4f} {info['n_seeds']:3d}")
    return summary


if __name__ == "__main__":
    main()
