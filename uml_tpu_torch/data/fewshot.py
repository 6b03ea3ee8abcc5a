"""Few-shot benchmark assembly + tensor dataset equivalents.

Capability parity with engine/datasets/utils.py: index-file-driven few-shot
benchmark loading, text-feature datasets with per-class n-shot subsampling
or class-averaging, and eval-only testset/label-map access.

As in uml_tpu: instead of torch Datasets yielding single items, the text
dataset is a struct of numpy arrays (features/labels/eot) the training
loop batches by index.
"""

from __future__ import annotations

import os

import numpy as np

from uml_tpu_torch.data.registry import dataset_classes
from uml_tpu_torch.utils.io import load_json


def get_few_shot_setup_name(train_shot: int, seed: int) -> str:
    """Parity with engine/datasets/utils.py:9-12."""
    return f"shot_{train_shot}-seed_{seed}"


def get_few_shot_benchmark(data_dir, indices_dir, dataset, train_shot, seed):
    """{'train','val','test','lab2cname','classnames'} from a pre-generated
    index JSON (train_shot=-1 -> full dataset).  Parity with utils.py:177-200."""
    assert dataset in dataset_classes, f"Dataset {dataset} is not supported."
    few_shot_dataset = None
    if train_shot != -1:
        index_file = os.path.join(
            indices_dir, dataset, f"{get_few_shot_setup_name(train_shot, seed)}.json"
        )
        assert os.path.exists(index_file), f"Few-shot data does not exist at {index_file}."
        few_shot_dataset = load_json(index_file)
    else:
        print("=> Using full dataset for feature extraction")
    print(f"=> Loading benchmark dataset ({dataset}) from {data_dir}")
    benchmark = dataset_classes[dataset](data_dir)
    return {
        "train": few_shot_dataset["train"]["data"] if train_shot != -1 else benchmark.train,
        "val": few_shot_dataset["val"]["data"] if train_shot != -1 else benchmark.val,
        "test": benchmark.test,
        "lab2cname": benchmark.lab2cname,
        "classnames": benchmark.classnames,
    }


def get_testset(dataset, data_dir):
    if dataset in dataset_classes:
        return dataset_classes[dataset](data_dir).test
    raise NotImplementedError(dataset)


def get_label_map(data_dir, dataset_name):
    """imagenet-a/-r subset label remapping; None otherwise (utils.py:211-215)."""
    if dataset_name in ("imagenet_a", "imagenet_r"):
        return dataset_classes[dataset_name](data_dir).label_map
    return None


class TextFeatureSet:
    """Cached text features (+labels, +EOT indices) with the reference's
    n-shot semantics (engine/datasets/utils.py:48-107):

      * n_shots int      -> per-class random subsample of n examples
                            (seeded through numpy's global RNG, which
                            set_random_seed seeds like the reference's torch
                            RNG — distributionally equivalent)
      * n_shots 'average'-> one class-mean feature per class
      * n_shots None     -> use everything
    """

    def __init__(self, features, labels, eot_indices, n_shots=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        self.eot_indices = np.asarray(eot_indices)

        if isinstance(n_shots, int):
            idx = self._select_n_shots(self.labels, n_shots)
            self.features = self.features[idx]
            self.labels = self.labels[idx]
            self.eot_indices = self.eot_indices[idx]
            print(f"=> Using {n_shots} text shots per class, total {len(self)} samples")
        elif isinstance(n_shots, str) and n_shots.lower() == "average":
            self._average_per_class()
            print(f"=> Averaging text features per class, total {len(self)} samples")
        elif n_shots is not None:
            raise ValueError("n_shots must be an int, None, or 'average'")

    @staticmethod
    def _select_n_shots(labels, n_shots):
        idx = []
        for label in np.unique(labels):
            label_inds = np.nonzero(labels == label)[0]
            n = min(n_shots, len(label_inds))
            perm = np.random.permutation(len(label_inds))[:n]
            idx.append(label_inds[perm])
        return np.concatenate(idx)

    def _average_per_class(self):
        unique = np.unique(self.labels)
        feats, eots = [], []
        for label in unique:
            mask = self.labels == label
            feats.append(self.features[mask].mean(axis=0))
            eots.append(self.eot_indices[mask][0])
        self.features = np.stack(feats)
        self.labels = unique
        self.eot_indices = np.stack(eots)

    def __len__(self):
        return len(self.features)


class TextFeatureSetWithPrompts(TextFeatureSet):
    """TextFeatureSet that also tracks the raw prompt string per row.

    Parity with TextTensorDatasetMultimodalNeurons
    (engine/datasets/utils.py:14-46): prompts come from a
    {label: [prompt, ...]} dict and are assigned per-row in label order;
    more rows for a label than prompts is an error (same guard as the
    reference's safety check).
    """

    def __init__(self, features, labels, eot_indices, prompts_dict):
        super().__init__(features, labels, eot_indices, n_shots=None)
        counters: dict[int, int] = {}
        self.prompts = []
        for lab in np.asarray(labels).tolist():
            lab = int(lab)
            prompt_list = prompts_dict[lab]
            j = counters.get(lab, 0)
            if j >= len(prompt_list):
                raise IndexError(
                    f"More samples ({j + 1}) for label {lab} than available "
                    f"prompts ({len(prompt_list)}). Your label ordering may "
                    "not match the prompt building order."
                )
            self.prompts.append(prompt_list[j % len(prompt_list)])
            counters[lab] = j + 1
