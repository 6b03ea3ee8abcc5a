"""Host-side modules of the port pinned to their uml_tpu originals: BPE
token ids, few-shot JSON bytes, templates and descriptors, decoded pixels,
feature-cache round trips, the features and finetune flag parsers, the
finetune sweep grids (HYPER_DICT), the metrics log (JsonlLogger) and the
finetune / collect_results naming helpers.  All comparisons are exact."""

import argparse
import json

import numpy as np
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from uml_tpu.cli import features as jax_features
from uml_tpu.cli import generate_fewshot as jax_gf
from uml_tpu.data import descriptors as jax_desc
from uml_tpu.data import feature_cache as jax_cache
from uml_tpu.data import loader as jax_loader
from uml_tpu.data import templates as jax_templates
from uml_tpu.data.registry import dataset_classes
from uml_tpu.models.tokenizer import tokenize as jax_tokenize
from uml_tpu_torch.cli import features as torch_features
from uml_tpu_torch.cli import generate_fewshot as torch_gf
from uml_tpu_torch.data import descriptors as torch_desc
from uml_tpu_torch.data import feature_cache as torch_cache
from uml_tpu_torch.data import loader as torch_loader
from uml_tpu_torch.data import templates as torch_templates
from uml_tpu_torch.models.tokenizer import tokenize as torch_tokenize


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return make_caltech_fixture(str(tmp_path_factory.mktemp("data")))


EXTRA_TEXTS = [
    "A bad photo of the Boeing 737-800, an aircraft!",
    "itap of a {} texture &amp; pattern",
    "naïve café résumé — em-dash",
    "don't can't won't it's we're I'll I'd I've I'm",
]


@pytest.mark.parametrize("augmentation", ["hand_crafted", "vanilla",
                                          "classname", "template_mining"])
def test_token_ids_equal(data_dir, augmentation):
    """Prompts of the fixture's classes (and a few awkward strings)."""
    bm = dataset_classes["caltech101"](data_dir)
    templates = torch_templates.get_templates("caltech101", augmentation)
    assert templates == jax_templates.get_templates("caltech101", augmentation)
    prompts = [t.format(c) for c in bm.classnames for t in templates]
    prompts += EXTRA_TEXTS
    np.testing.assert_array_equal(torch_tokenize(prompts),
                                  jax_tokenize(prompts))


@pytest.mark.parametrize("shot,seed", [(1, 1), (3, 2), (16, 3)])
def test_fewshot_json_bytes_equal(data_dir, tmp_path, shot, seed):
    argv = ["--data_dir", data_dir, "--dataset", "caltech101",
            "--train-shot", str(shot), "--seed", str(seed)]
    ours = torch_gf.main(torch_gf.build_parser().parse_args(
        argv + ["--indices_dir", str(tmp_path / "torch")]))
    theirs = jax_gf.main(jax_gf.build_parser().parse_args(
        argv + ["--indices_dir", str(tmp_path / "jax")]))
    assert open(ours, "rb").read() == open(theirs, "rb").read()


def test_descriptors_equal():
    hp = dict(torch_desc.DESCRIPTOR_DICT["gpt3_cupl"])
    hp["fname"] = torch_desc.descriptor_path("gpt3_cupl", "caltech101")
    hp["dsname"] = "caltech101"
    jhp = dict(jax_desc.DESCRIPTOR_DICT["gpt3_cupl"])
    jhp["fname"] = jax_desc.descriptor_path("gpt3_cupl", "caltech101")
    jhp["dsname"] = "caltech101"
    assert torch_desc.load_gpt_descriptions(hp) == \
        jax_desc.load_gpt_descriptions(jhp)


@pytest.mark.parametrize("augmentation", ["crop", "flip", "randomcrop"])
def test_loader_pixels_equal(data_dir, augmentation):
    """The port's PIL loader decodes what uml_tpu's PIL path decodes, with
    the same per-batch augmentation RNG."""
    items = dataset_classes["caltech101"](data_dir).train[:10]
    ours = list(torch_loader.ImageBatchLoader(items, augmentation, 4,
                                              num_workers=2, seed=3,
                                              fast_decode=False))
    theirs = list(jax_loader.ImageBatchLoader(items, augmentation, 4,
                                              num_workers=2, seed=3,
                                              fast_decode=False))
    assert len(ours) == len(theirs) == 3
    for (a, la, pa), (b, lb, pb) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
        assert pa == pb


def _cache_obj():
    rng = np.random.default_rng(0)
    return {
        "train": {"features": rng.standard_normal((5, 8)).astype(np.float32),
                  "labels": np.arange(5, dtype=np.int64),
                  "paths": [f"p{i}.jpg" for i in range(5)]},
        "eot_indices": np.array([3, 4], dtype=np.int64),
        "prompts": {0: ["a photo of a cat."], 1: ["a dog"]},
        "lab2cname": {0: "cat", 1: "dog"},
    }


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("writer,reader", [
    (torch_cache, torch_cache), (torch_cache, jax_cache),
    (jax_cache, torch_cache)])
def test_feature_cache_round_trip_exact(tmp_path, writer, reader):
    path = str(tmp_path / "sub" / "cache.pth")
    obj = _cache_obj()
    writer.save_cache(obj, path)
    _assert_tree_equal(obj, reader.load_cache(path))


def test_cache_paths_equal():
    args = ("./features", "ViT-B/16", "caltech101")
    for mode in ("train", "test"):
        for tokens in (False, True):
            assert torch_cache.img_outdir(*args, "crop", 16, 1, mode, tokens) \
                == jax_cache.img_outdir(*args, "crop", 16, 1, mode, tokens)
    assert torch_cache.text_outdir(*args, "hand_crafted", True) == \
        jax_cache.text_outdir(*args, "hand_crafted", True)


@pytest.mark.parametrize("argv", [
    [],
    ["--dataset", "caltech101", "--clip-encoder", "ViT-B/16",
     "--allow-random-init", "--train-shot", "16", "--seed", "3",
     "--text-augmentation", "hand_crafted", "--batch-size", "64"],
    ["--clip_encoder", "ViT-B/32", "--return_tokens", "--mesh", "off",
     "--descriptor_type", "gpt3_cupl", "--image_augmentation", "flip",
     "--num_workers", "2", "--quant", "int8", "--debug_nans"],
])
def test_features_parsers_give_the_same_namespace(argv):
    ours = torch_features.build_parser().parse_args(argv)
    theirs = jax_features.build_parser().parse_args(argv)
    assert isinstance(ours, argparse.Namespace)
    assert vars(ours) == vars(theirs)


def test_hyper_dict_pinned():
    from uml_tpu.train.optim import HYPER_DICT as jax_grids
    from uml_tpu_torch.train.optim import HYPER_DICT as torch_grids

    assert torch_grids == jax_grids


def test_jsonl_logger_output_pinned(tmp_path):
    """The same calls write the same lines (the wall-clock ``_t`` of the
    config line aside), numpy and torch scalars included."""
    from uml_tpu.utils import logging as jax_logging
    from uml_tpu_torch.utils import logging as torch_logging

    config = {"lr": 1e-3, "name": "x", "tags": ["a"], "obj": object,
              "np": np.float32(0.5)}
    calls = [{"train/loss": np.float32(1.25), "n": np.int64(3)},
             {"val/acc": 0.5, "iter": 0, "t": torch.tensor(2.0)}]
    lines = {}
    for name, mod in (("jax", jax_logging), ("torch", torch_logging)):
        path = tmp_path / name / "metrics.jsonl"
        with mod.JsonlLogger(str(path), config=config) as log:
            for c in calls:
                log.log(c)
        lines[name] = [json.loads(l) for l in path.read_text().splitlines()]
        lines[name][0].pop("_t")
        assert isinstance(mod.init_logger("p", {}, logdir=str(tmp_path / name)),
                          mod.JsonlLogger)
    assert lines["torch"] == lines["jax"]


@pytest.mark.parametrize("args", [
    ("adamw", 5e-05, 0.0, 64, 12800, 0.0, False),
    ("sgd", 0.1, 0.01, 8, 200, None, True)])
def test_finetune_naming_equal(args):
    from uml_tpu.cli import collect_results as jax_collect
    from uml_tpu.cli import finetune as jax_ft
    from uml_tpu_torch.cli import collect_results as torch_collect
    from uml_tpu_torch.cli import finetune as torch_ft

    assert torch_ft.hparam_str(*args) == jax_ft.hparam_str(*args)
    assert torch_collect.hparam_str(*args, model_str="m") == \
        jax_collect.hparam_str(*args, model_str="m")
    for mode in ("crossmodal", "image", "text"):
        ns = argparse.Namespace(common_dim=128)
        kw = dict(init_mode="zeroshot", alpha=0.5, text_bs=4, custom_name="c",
                  args=ns)
        assert torch_ft.savedir("out", "caltech101", "ViT-B/16", 16, 1,
                                "hand_crafted", 2, "crop", mode, **kw) == \
            jax_ft.savedir("out", "caltech101", "ViT-B/16", 16, 1,
                           "hand_crafted", 2, "crop", mode, **kw)


def test_finetune_parsers_give_the_same_namespace():
    from uml_tpu.cli import finetune as jax_ft
    from uml_tpu_torch.cli import finetune as torch_ft

    argv = ["--dataset", "caltech101", "--modality", "crossmodal", "--alpha",
            "0.5", "--hyperparams", "smoke_full", "--text_shot", "average"]
    assert vars(torch_ft.build_parser().parse_args(argv)) == \
        vars(jax_ft.build_parser().parse_args(argv))
