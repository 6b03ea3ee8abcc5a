"""Benchmark split machinery: split IO, train/val splitting, few-shot sampling.

Capability parity with engine/datasets/benchmark.py.  The few-shot sampler
reproduces the reference byte-for-byte: given the same experiment seed (via
``set_random_seed``) it issues the identical sequence of ``random.sample``
calls — per-label, in first-appearance order — so the emitted
``shot_{n}-seed_{s}.json`` index files are identical to the reference's
(benchmark.py:174-229 + tools' save_as_json).
"""

from __future__ import annotations

import os
import random
from collections import defaultdict

from uml_tpu_torch.utils.io import check_isfile, listdir_nohidden, load_json, save_as_json


def read_split(filepath: str, path_prefix: str):
    """Read a {train,val,test} split JSON of (impath, label, classname) rows.

    Parity with benchmark.py:8-28 (impaths are joined onto path_prefix).
    """

    def _convert(items):
        out = []
        for impath, label, classname in items:
            impath = os.path.join(path_prefix, impath)
            check_isfile(impath)
            out.append({"impath": impath, "label": int(label), "classname": classname})
        return out

    print(f"Reading split from {filepath}")
    split = load_json(filepath)
    return _convert(split["train"]), _convert(split["val"]), _convert(split["test"])


def save_split(train, val, test, filepath, path_prefix):
    """Inverse of read_split (benchmark.py:55-77)."""

    def _extract(items):
        out = []
        for item in items:
            impath = item["impath"].replace(path_prefix, "")
            if impath.startswith("/"):
                impath = impath[1:]
            out.append((impath, item["label"], item["classname"]))
        return out

    save_as_json(
        {"train": _extract(train), "val": _extract(val), "test": _extract(test)},
        filepath,
    )
    print(f"Saved split to {filepath}")


def split_trainval(trainval, p_val=0.2):
    """Per-class random train/val split (benchmark.py:31-52)."""
    p_trn = 1 - p_val
    print(f"Splitting trainval into {p_trn:.0%} train and {p_val:.0%} val")
    tracker = defaultdict(list)
    for idx, item in enumerate(trainval):
        tracker[item["label"]].append(idx)

    train, val = [], []
    for label, idxs in tracker.items():
        n_val = round(len(idxs) * p_val)
        assert n_val > 0
        random.shuffle(idxs)
        for n, idx in enumerate(idxs):
            (val if n < n_val else train).append(trainval[idx])
    return train, val


def read_and_split_data(image_dir, p_trn=0.5, p_val=0.2, ignored=(), new_cnames=None):
    """Scan a folder-per-class tree into splits (benchmark.py:80-126)."""
    categories = sorted(c for c in listdir_nohidden(image_dir) if c not in ignored)
    p_tst = 1 - p_trn - p_val
    print(f"Splitting into {p_trn:.0%} train, {p_val:.0%} val, and {p_tst:.0%} test")

    def _collate(ims, y, c):
        return [{"impath": im, "label": y, "classname": c} for im in ims]

    train, val, test = [], [], []
    for label, category in enumerate(categories):
        category_dir = os.path.join(image_dir, category)
        images = [os.path.join(category_dir, im) for im in listdir_nohidden(category_dir)]
        random.shuffle(images)
        n_total = len(images)
        n_train = round(n_total * p_trn)
        n_val = round(n_total * p_val)
        assert n_train > 0 and n_val > 0 and (n_total - n_train - n_val) > 0
        if new_cnames is not None and category in new_cnames:
            category = new_cnames[category]
        train.extend(_collate(images[:n_train], label, category))
        val.extend(_collate(images[n_train : n_train + n_val], label, category))
        test.extend(_collate(images[n_train + n_val :], label, category))
    return train, val, test


def get_num_classes(data_source) -> int:
    return max(item["label"] for item in data_source) + 1


def get_lab2cname(data_source):
    """(label->classname dict, classnames-in-label-order list)."""
    container = {(item["label"], item["classname"]) for item in data_source}
    mapping = {label: classname for label, classname in container}
    labels = sorted(mapping.keys())
    return mapping, [mapping[l] for l in labels]


def split_dataset_by_label(data_source):
    items = defaultdict(list)
    indices = defaultdict(list)
    for idx, item in enumerate(data_source):
        items[item["label"]].append(item)
        indices[item["label"]].append(idx)
    return items, indices


def sample_few_shot_dataset(data_source, num_shots, repeat=False):
    """Per-class sample of num_shots items (benchmark.py:174-199).

    Uses python's global ``random`` in the reference's exact call order so
    seeded outputs are byte-identical.
    """
    few_shot = {"data": [], "indices": []}
    all_items, all_indices = split_dataset_by_label(data_source)
    for label, items in all_items.items():
        item_indices = list(range(len(items)))
        if len(items) >= num_shots:
            sampled = random.sample(item_indices, num_shots)
        elif repeat:
            sampled = random.choices(item_indices, k=num_shots)
        else:
            sampled = item_indices
        few_shot["indices"].extend(all_indices[label][i] for i in sampled)
        few_shot["data"].extend(items[i] for i in sampled)
    return few_shot


def generate_fewshot_dataset(train, val, num_shots=16, max_val_shots=4, repeat=False):
    """{'train','val'} few-shot samples (benchmark.py:202-229).

    Val gets min(max_val_shots, num_shots) shots.
    """
    assert num_shots >= 1
    print(f"Creating a {num_shots}-shot train set")
    few_shot_train = sample_few_shot_dataset(train, num_shots, repeat=repeat)
    num_val_shots = min(max_val_shots, num_shots)
    print(f"Creating a {num_val_shots}-shot validation set")
    few_shot_val = sample_few_shot_dataset(val, num_val_shots, repeat=repeat)
    return {"train": few_shot_train, "val": few_shot_val}


class Benchmark:
    """Train/val/test item lists + label metadata (benchmark.py:232-246)."""

    dataset_name = ""

    def __init__(self, train=None, val=None, test=None):
        self.train = train
        self.val = val
        self.test = test
        self.num_classes = get_num_classes(train)
        self.lab2cname, self.classnames = get_lab2cname(train)
