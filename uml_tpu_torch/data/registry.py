"""Dataset registry: the 15 vision benchmarks.

Capability parity with engine/datasets/{__init__,*}.py.  Eleven benchmarks
are train/val/test datasets; four (imagenetv2, imagenet-sketch, imagenet-a,
imagenet-r) are eval-only robustness sets whose single split is exposed as
train=val=test, with imagenet-a/-r carrying a ``label_map`` back into the
1000-class ImageNet label space (imagenet_a.py:30-51).

Design: the nine benchmarks that just read a CoOp-style
``split_zhou_*.json`` are table-driven (one registry row each) instead of
nine copy-pasted classes; the folder-scanned and annotation-file-driven ones
get small reader classes.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict

from uml_tpu_torch.data.benchmarks import Benchmark, read_split
from uml_tpu_torch.utils.io import listdir_nohidden


# --------------------------------------------------------------------------
# split_zhou_*.json-backed benchmarks (table-driven)
# --------------------------------------------------------------------------

# name -> (dataset_dir, image_subdir ('' = dataset_dir itself), split filename)
_SPLIT_JSON_BENCHMARKS = {
    "caltech101": ("caltech-101", "101_ObjectCategories", "split_zhou_Caltech101.json"),
    "dtd": ("dtd", "images", "split_zhou_DescribableTextures.json"),
    "eurosat": ("eurosat", "2750", "split_zhou_EuroSAT.json"),
    "food101": ("food-101", "images", "split_zhou_Food101.json"),
    "oxford_flowers": ("oxford_flowers", "jpg", "split_zhou_OxfordFlowers.json"),
    "oxford_pets": ("oxford_pets", "images", "split_zhou_OxfordPets.json"),
    "stanford_cars": ("stanford_cars", "", "split_zhou_StanfordCars.json"),
    "sun397": ("sun397", "SUN397", "split_zhou_SUN397.json"),
    "ucf101": ("ucf101", "UCF-101-midframes", "split_zhou_UCF101.json"),
}


class SplitJsonBenchmark(Benchmark):
    """A benchmark defined entirely by a CoOp split JSON."""

    def __init__(self, data_dir: str, name: str):
        ds_dir, img_subdir, split_file = _SPLIT_JSON_BENCHMARKS[name]
        self.dataset_name = ds_dir
        self.dataset_dir = os.path.join(data_dir, ds_dir)
        self.image_dir = (
            os.path.join(self.dataset_dir, img_subdir) if img_subdir else self.dataset_dir
        )
        self.split_path = os.path.join(self.dataset_dir, split_file)
        assert os.path.exists(self.split_path), self.split_path
        train, val, test = read_split(self.split_path, self.image_dir)
        super().__init__(train=train, val=val, test=test)


def _split_json_factory(name):
    def make(data_dir):
        return SplitJsonBenchmark(data_dir, name)

    make.__name__ = name
    return make


# --------------------------------------------------------------------------
# annotation-file / folder-scan benchmarks
# --------------------------------------------------------------------------


class FGVCAircraft(Benchmark):
    """variants.txt + images_variant_{split}.txt readers (fgvc_aircraft.py)."""

    dataset_name = "fgvc_aircraft"

    def __init__(self, data_dir: str):
        self.dataset_dir = os.path.join(data_dir, self.dataset_name)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        with open(os.path.join(self.dataset_dir, "variants.txt")) as f:
            classnames = [line.strip() for line in f]
        cname2lab = {c: i for i, c in enumerate(classnames)}
        splits = [
            self._read(cname2lab, f"images_variant_{s}.txt")
            for s in ("train", "val", "test")
        ]
        super().__init__(*splits)

    def _read(self, cname2lab, split_file):
        items = []
        with open(os.path.join(self.dataset_dir, split_file)) as f:
            for line in f:
                parts = line.strip().split(" ")
                classname = " ".join(parts[1:])
                items.append({
                    "impath": os.path.join(self.image_dir, parts[0] + ".jpg"),
                    "label": cname2lab[classname],
                    "classname": classname,
                })
        return items


def read_classnames(text_file: str) -> "OrderedDict[str, str]":
    """<wnid folder> -> <classname> map from classnames.txt (imagenet.py:8-20)."""
    classnames = OrderedDict()
    with open(text_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            classnames[parts[0]] = " ".join(parts[1:])
    return classnames


class ImageNet(Benchmark):
    """ImageNet via split_ImageNet.json (imagenet.py:22-52).

    The reference hardcodes an MIT cluster image root (imagenet.py:30); here
    the image root defaults to <dataset_dir>/images and can be overridden
    with $UML_IMAGENET_DIR.
    """

    dataset_name = "imagenet"

    def __init__(self, data_dir: str):
        self.dataset_dir = os.path.join(data_dir, self.dataset_name)
        self.image_dir = os.environ.get(
            "UML_IMAGENET_DIR", os.path.join(self.dataset_dir, "images")
        )
        self.split_path = os.path.join(self.dataset_dir, "split_ImageNet.json")
        if not os.path.exists(self.split_path):
            raise FileNotFoundError(
                f"ImageNet split not found at {self.split_path}; download the "
                "CoOp split_ImageNet.json and place it there."
            )
        train, val, test = read_split(self.split_path, self.image_dir)
        super().__init__(train=train, val=val, test=test)


def _scan_folders(image_dir, classnames, folders):
    items = []
    for label, folder in enumerate(folders):
        classname = classnames[folder]
        for imname in listdir_nohidden(os.path.join(image_dir, folder)):
            items.append({
                "impath": os.path.join(image_dir, folder, imname),
                "label": label,
                "classname": classname,
            })
    return items


class ImageNetV2(Benchmark):
    """Eval-only; folders are stringified labels 0..999 (imagenetv2.py)."""

    dataset_name = "imagenetv2"

    def __init__(self, data_dir: str):
        self.dataset_dir = os.path.join(data_dir, self.dataset_name)
        self.image_dir = os.path.join(
            self.dataset_dir, "imagenetv2-matched-frequency-format-val"
        )
        classnames = read_classnames(os.path.join(self.dataset_dir, "classnames.txt"))
        folders = list(classnames.keys())
        items = []
        for label in range(1000):
            class_dir = os.path.join(self.image_dir, str(label))
            classname = classnames[folders[label]]
            for imname in listdir_nohidden(class_dir):
                items.append({
                    "impath": os.path.join(class_dir, imname),
                    "label": label,
                    "classname": classname,
                })
        super().__init__(train=items, val=items, test=items)


class ImageNetSketch(Benchmark):
    """Eval-only; full 1000-class wnid folder scan (imagenet_sketch.py)."""

    dataset_name = "imagenet-sketch"

    def __init__(self, data_dir: str):
        self.dataset_dir = os.path.join(data_dir, self.dataset_name)
        self.image_dir = os.path.join(self.dataset_dir, "images")
        classnames = read_classnames(os.path.join(self.dataset_dir, "classnames.txt"))
        folders = listdir_nohidden(self.image_dir, sort=True)
        items = _scan_folders(self.image_dir, classnames, folders)
        super().__init__(train=items, val=items, test=items)


class _ImageNetSubsetBenchmark(Benchmark):
    """Eval-only ImageNet subset with a label_map into the original 1000
    labels (imagenet_a.py:30-51 / imagenet_r.py:36-53)."""

    subset_subdir = ""
    IGNORED = ("README.txt",)

    def __init__(self, data_dir: str):
        self.dataset_dir = os.path.join(data_dir, self.dataset_name)
        original_classnames = read_classnames(
            os.path.join(data_dir, "imagenet", "classnames.txt")
        )
        self.image_dir = os.path.join(self.dataset_dir, self.subset_subdir)
        classnames = read_classnames(os.path.join(self.dataset_dir, "classnames.txt"))
        folders = [
            f for f in listdir_nohidden(self.image_dir, sort=True)
            if f not in self.IGNORED
        ]
        original_folders = list(original_classnames)
        self.label_map = [original_folders.index(f) for f in folders]
        items = _scan_folders(self.image_dir, classnames, folders)
        super().__init__(train=items, val=items, test=items)


class ImageNetA(_ImageNetSubsetBenchmark):
    dataset_name = "imagenet-adversarial"
    subset_subdir = "imagenet-a"


class ImageNetR(_ImageNetSubsetBenchmark):
    dataset_name = "imagenet-rendition"
    subset_subdir = "imagenet-r"


class UCF101Reader:
    """Raw-annotation reader for UCF101 regeneration (ucf101.py:35-54).

    Kept for split-regeneration capability; the registry path uses the
    split JSON like the reference.
    """

    @staticmethod
    def rename_action(action: str) -> str:
        return "_".join(re.findall("[A-Z][^A-Z]*", action))


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

dataset_classes = {
    **{name: _split_json_factory(name) for name in _SPLIT_JSON_BENCHMARKS},
    "fgvc_aircraft": FGVCAircraft,
    "imagenet": ImageNet,
    "imagenetv2": ImageNetV2,
    "imagenet_sketch": ImageNetSketch,
    "imagenet_a": ImageNetA,
    "imagenet_r": ImageNetR,
}
