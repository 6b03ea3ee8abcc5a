"""The MultiBench host modules of the port pinned to their uml_tpu originals:
seq_augment, robustness, affect, mimic, preprocess_affect, text_embed,
collect_results_mb and the multibench flag parser.  Every comparison is
exact (the same inputs and the same seeded ``RandomState``s), except
``embed_texts``, whose contextual mode runs a tiny HF BERT through each
package's TextModel (atol 1e-5)."""

import argparse
import os
import pickle

import numpy as np
import pytest
import torch

from tests.test_multibench import make_affect_pickle
from tests.test_preprocess_affect import _make_hdf5
from tests.test_torch_languagemodel import _save_tiny_bert
from uml_tpu.cli import collect_results_mb as jax_collect
from uml_tpu.cli import multibench as jax_mb
from uml_tpu.data import affect as jax_affect
from uml_tpu.data import mimic as jax_mimic
from uml_tpu.data import preprocess_affect as jax_pre
from uml_tpu.data import robustness as jax_rob
from uml_tpu.data import seq_augment as jax_aug
from uml_tpu.data import text_embed as jax_te
from uml_tpu_torch.cli import collect_results_mb as torch_collect
from uml_tpu_torch.cli import multibench as torch_mb
from uml_tpu_torch.data import affect as torch_affect
from uml_tpu_torch.data import mimic as torch_mimic
from uml_tpu_torch.data import preprocess_affect as torch_pre
from uml_tpu_torch.data import robustness as torch_rob
from uml_tpu_torch.data import seq_augment as torch_aug
from uml_tpu_torch.data import text_embed as torch_te

SENTENCES = ["The quick brown fox jumps over the lazy dog!",
             "Sarcasm detection, at 42 frames: really wonderful...",
             "a photo of the centered satellite"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _equal(a, b):
    """Nested lists / tuples / dicts of arrays, equal exactly."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _both(fn_name, module_pair, *args, seed=0, **kw):
    """Call ``fn_name`` of both modules with equal RandomStates."""
    jm, tm = module_pair
    want = getattr(jm, fn_name)(*args, rng=np.random.RandomState(seed), **kw)
    got = getattr(tm, fn_name)(*args, rng=np.random.RandomState(seed), **kw)
    return want, got


@pytest.mark.parametrize("name", ["permute", "noise", "drop", "mixup", "identity",
                                  "augment", "augment_single",
                                  "augment_embed_single", "augment_mimic"])
@pytest.mark.parametrize("shape", [(4, 6, 3), (5, 7)])
def test_seq_augment_equal(name, shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want, got = _both(name, (jax_aug, torch_aug), x, seed=3)
    _equal(want, got)


@pytest.mark.parametrize("case", ["timeseries", "tabular", "audio", "text",
                                  "visual", "typos"])
def test_robustness_equal(case):
    rng = np.random.default_rng(2)
    pair = (jax_rob, torch_rob)
    if case == "timeseries":
        series = [list(rng.standard_normal((5, 6, 3))), list(rng.standard_normal((5, 6, 2)))]
        want, got = _both("add_timeseries_noise", pair, series, 0.4)
    elif case == "tabular":
        want, got = _both("add_tabular_noise", pair, rng.standard_normal((6, 5)), 0.5)
    elif case == "audio":
        want, got = _both("add_audio_noise", pair, rng.standard_normal((6, 12, 3)), 0.7)
    elif case == "text":
        want, got = _both("add_text_noise", pair, SENTENCES, 0.8)
    elif case == "visual":
        imgs = [rng.integers(0, 255, (16, 20, 3), dtype=np.uint8) for _ in range(3)]
        want, got = _both("add_visual_noise", pair, imgs, 0.6)
    else:
        want = [getattr(jax_rob, f)("keyboard", rng=np.random.RandomState(5))
                for f in ("swap_letter", "random_mid", "qwerty_typo", "sticky_keys",
                          "omission")]
        got = [getattr(torch_rob, f)("keyboard", rng=np.random.RandomState(5))
               for f in ("swap_letter", "random_mid", "qwerty_typo", "sticky_keys",
                         "omission")]
    _equal(want, got)


@pytest.fixture(scope="module")
def affect_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("affect") / "sarcasm.pkl"
    make_affect_pickle(str(path))
    return str(path)


def _split_arrays(split):
    return {"arrays": split.arrays, "lengths": split.lengths, "labels": split.labels}


@pytest.mark.parametrize("data_type,vision_norm,z_norm", [
    ("mosi", False, False), ("sarcasm", True, False), ("humor", False, True)])
def test_affect_splits_and_streams_equal(affect_pickle, data_type, vision_norm, z_norm):
    assert torch_affect.DATASET_CONFIG == jax_affect.DATASET_CONFIG
    want = jax_affect.load_affect(affect_pickle, data_type, vision_norm, z_norm)
    got = torch_affect.load_affect(affect_pickle, data_type, vision_norm, z_norm)
    for split in ("train", "valid", "test"):
        _equal(_split_arrays(want[split]), _split_arrays(got[split]))
    for shuffle in (True, False):
        a = jax_affect.AffectBatchStream(want["train"], 16, seed=42, shuffle=shuffle)
        b = torch_affect.AffectBatchStream(got["train"], 16, seed=42, shuffle=shuffle)
        assert a.num_batches() == b.num_batches()
        for _ in range(2):
            _equal(list(a.epoch()), list(b.epoch()))
    _equal(jax_affect.make_robust_tests(want["test"], levels=3),
           torch_affect.make_robust_tests(got["test"], levels=3))
    y = np.array([[-2.0], [0.0], [1.5]])
    _equal(jax_affect.map_labels(y, data_type), torch_affect.map_labels(y, data_type))


def _mimic_pickle(path, n=60):
    rng = np.random.default_rng(0)
    adm_labels = np.zeros((n, 6))
    adm_labels[:10, 1] = 1
    adm_labels[5:15, 3] = 1
    datafile = {"ep_tdata": rng.standard_normal((n, 24, 12)),
                "adm_features_all": rng.standard_normal((n, 5)),
                "adm_labels_all": adm_labels,
                "y_icd9": rng.integers(0, 2, (n, 20))}
    datafile["ep_tdata"][0, 0, 0] = np.inf
    with open(path, "wb") as f:
        pickle.dump(datafile, f)


@pytest.mark.parametrize("task", [-1, 7])
def test_mimic_equal(tmp_path, task):
    path = str(tmp_path / "im.pk")
    _mimic_pickle(path)
    want = jax_mimic.load_mimic(path, task=task)
    got = torch_mimic.load_mimic(path, task=task)
    _equal(want, got)
    _equal(jax_mimic.make_robust_tests(want["test"], levels=3),
           torch_mimic.make_robust_tests(got["test"], levels=3))
    a = jax_mimic.MimicBatchStream(want["train"], 16, seed=43)
    b = torch_mimic.MimicBatchStream(got["train"], 16, seed=43)
    for _ in range(2):
        _equal(list(a.epoch()), list(b.epoch()))


def test_preprocess_affect_equal(tmp_path):
    arr = np.arange(12.0).reshape(6, 2)
    for n in (4, 9):
        _equal(jax_pre.lpad(arr, n), torch_pre.lpad(arr, n))
    folds = [["video1"], ["video2"], []]
    for entry in ("video1[0]", "video2[3]", "video9[1]"):
        assert (jax_pre.detect_entry_fold(entry, folds)
                == torch_pre.detect_entry_fold(entry, folds))
    _equal(jax_pre.embed_left_padded(SENTENCES, paddings=6, dim=8),
           torch_pre.embed_left_padded(SENTENCES, paddings=6, dim=8))
    h5 = str(tmp_path / "cmu.hdf5")
    folds = _make_hdf5(h5)
    want = jax_pre.build_affect_pickle(h5, str(tmp_path / "a.pkl"), folds, seq_len=5)
    got = torch_pre.build_affect_pickle(h5, str(tmp_path / "b.pkl"), folds, seq_len=5)
    _equal(want, got)
    with open(tmp_path / "a.pkl", "rb") as fa, open(tmp_path / "b.pkl", "rb") as fb:
        _equal(pickle.load(fa), pickle.load(fb))


def test_text_embedders_equal(tmp_path, monkeypatch):
    glove = tmp_path / "glove.txt"
    glove.write_text("the 0.5 1.5 -2\nfox 1 2 3\nQuick 4 5 6\n")
    for name in ("HashVocabEmbedder", "WordVectorEmbedder"):
        arg = (SENTENCES if name == "HashVocabEmbedder"
               else jax_te.load_word_vectors(str(glove)))
        want = getattr(jax_te, name)(arg, **({"dim": 16} if name[0] == "H" else {}))
        got = getattr(torch_te, name)(arg, **({"dim": 16} if name[0] == "H" else {}))
        noisy = jax_rob.add_text_noise(SENTENCES, 0.5, rng=np.random.RandomState(0))
        _equal(want(noisy, 9), got(noisy, 9))
    _equal(jax_te.load_word_vectors(str(glove)), torch_te.load_word_vectors(str(glove)))
    for env in ("", str(glove)):
        monkeypatch.setenv("UML_GLOVE_PATH", env)
        want = jax_te.default_text_embedder(SENTENCES, dim=3)
        got = torch_te.default_text_embedder(SENTENCES, dim=3)
        assert type(want).__name__ == type(got).__name__
        _equal(want(SENTENCES, 7), got(SENTENCES, 7))
    embed = jax_te.HashVocabEmbedder(SENTENCES, dim=4)
    _equal(jax_te.reembed_noisy_text(SENTENCES, 3, embed_fn=lambda t: embed(t, 8)),
           torch_te.reembed_noisy_text(SENTENCES, 3, embed_fn=lambda t: embed(t, 8)))


@pytest.mark.parametrize("contextual", [False, True])
def test_embed_texts_equal(tmp_path, monkeypatch, contextual):
    """A tiny seeded BERT saved to a local directory (built from a config
    made in code): both packages' embed_texts give the same arrays."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    d = str(tmp_path / "tiny-bert")
    _save_tiny_bert(d)
    texts = ["a photo of the cat", "the dog", "itap of a centered satellite photo"]
    want = jax_te.embed_texts(texts, d, contextual=contextual, max_len=6)
    got = torch_te.embed_texts(texts, d, contextual=contextual, max_len=6)
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 6, 32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _results_tree(root):
    """Two configs of one (dataset, modality) group, two seeds each, and a
    second modality, in the trainer's layout."""
    from uml_tpu_torch.data.feature_cache import save_cache

    rng = np.random.default_rng(0)
    for ds in ("sarcasm", "mosi"):
        for mod in ("x", "xy"):
            for zdim in (10, 20):
                cfg = (f"log_{ds}/mod{mod}/epochs3/zdim{zdim}/alpha_x1.0_alpha_y1.0/"
                       f"step_k-1/pos_embd_False_learnable_False/lr0.0001")
                for seed in (0, 1):
                    save_cache({k: float(rng.random()) for k in (
                        "test/score_x", "test/score_y", "test/score_xy",
                        "val/score_x", "val/score_y", "val/score_xy")},
                        os.path.join(root, cfg, f"seed_{seed}", "results.pth"))


def test_collect_results_mb_equal(tmp_path, capsys, monkeypatch):
    root = str(tmp_path / "results")
    _results_tree(root)
    path = "a/log_mosi/modxy/epochs3/zdim10/alpha_x1.0_alpha_y0.5/step_k2/x"
    assert torch_collect.parse_run_dir(path) == jax_collect.parse_run_dir(path)
    for group_by in (("dataset", "modality"), ("dataset", "zdim")):
        assert (torch_collect.collect_results(root, group_by)
                == jax_collect.collect_results(root, group_by))
    out = {}
    for name, mod in (("jax", jax_collect), ("torch", torch_collect)):
        monkeypatch.setattr("sys.argv", ["collect_results_mb", "--experiments_dir", root])
        mod.main()
        out[name] = capsys.readouterr().out
    assert out["torch"] == out["jax"] and "Key: ('sarcasm', 'xy')" in out["torch"]


@pytest.mark.parametrize("argv", [
    [],
    ["--ds_name", "sarcasm", "--modality", "xy", "--zdim", "300", "--pos_embd",
     "--pos_learnable", "--infoNCE_loss", "--step_k", "2", "--ckpt_every", "1",
     "--robust_test", "--mesh", "off", "--debug_nans", "--augment"],
])
def test_multibench_parsers_give_the_same_namespace(argv):
    want = jax_mb.build_parser().parse_args(argv)
    got = torch_mb.build_parser().parse_args(argv)
    assert vars(got) == vars(want)
    assert isinstance(got, argparse.Namespace)
