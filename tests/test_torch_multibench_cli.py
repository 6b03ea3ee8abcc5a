"""The port's MultiBench training loop and CLIs against uml_tpu's, on the CPU.

* ``train_selfsup``: a smoke run, reruns equal bit for bit, a resumed run
  equal bit for bit to an uninterrupted one (dropout on, so the dropout
  generator's state must cross the checkpoint), a resume past completion,
  ``check_finite`` (--debug_nans);
* both packages' multibench CLIs for one epoch on a fixture at mosi's
  published input widths: equal artifact trees, results.pth keys,
  model.pth trees and logged metric keys; uml_tpu's model.pth evaluated
  by both packages' ``evaluate`` gives equal scores; both
  collect_results_mb print the same over uml_tpu's results tree;
* the MIMIC path through the port's CLI; no card and no UML_TORCH_DEVICE
  raises; --mesh auto over two cards starts one process per card from
  the command line, and none from a Python call of ``main``.
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multibench import make_affect_pickle
from uml_tpu.cli import collect_results_mb as jax_collect
from uml_tpu.cli import multibench as jax_mb
from uml_tpu.data.affect import load_affect as jax_load_affect
from uml_tpu.models.seq_autoencoder import make_seq_uml as jax_make_seq_uml
from uml_tpu.train import selfsup as jax_selfsup
from uml_tpu_torch.cli import collect_results_mb as torch_collect
from uml_tpu_torch.cli import multibench as torch_mb
from uml_tpu_torch.core.checkpoint import TrainCheckpointer
from uml_tpu_torch.data.affect import load_affect
from uml_tpu_torch.data.feature_cache import load_cache
from uml_tpu_torch.models import seq_autoencoder as sa
from uml_tpu_torch.models.convert import (seq_uml_state_dict_from_jax,
                                          seq_uml_state_dict_to_jax)
from uml_tpu_torch.train.selfsup import SelfSupTrainer, evaluate, train_selfsup

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def affect_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("affect") / "mosi_data.pkl"
    make_affect_pickle(str(path))
    return str(path)


def _train(affect_pickle, epochs, ckpt_dir=None, capture=False, seed=0, **kw):
    splits = load_affect(affect_pickle)
    s1, s2, evals = torch_mb._affect_streams(splits, None, 16)
    trainer = SelfSupTrainer(sa.make_seq_uml(6, 10, 10), lr=1e-3, seed=seed,
                             device="cpu")
    ck = TrainCheckpointer(ckpt_dir) if ckpt_dir else None
    model, score, emb = train_selfsup(trainer, s1, s2, evals, mode="xy",
                                      num_epochs=epochs, ds_name="mosi",
                                      eval_freq=1000, capture=capture,
                                      checkpointer=ck, **kw)
    return model.state_dict(), score, emb


def _equal_states(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.heavy
def test_train_selfsup_smoke_and_reruns(affect_pickle):
    """Scores in range; two runs with the global RNGs perturbed between
    them are equal bit for bit (the eval shuffle and the dropout masks come
    from explicit generators)."""
    a_state, a, emb = _train(affect_pickle, 2, capture=True, step_k=0)
    for k in ("test/score_x", "test/score_y", "test/score_xy",
              "val/score_x_raw", "val/modality_separate"):
        assert 0.0 <= a[k] <= 1.0, k
    assert len(emb["x1"]) == 2 and emb["x1"][0].shape == (48, 10)
    np.random.standard_normal(17)
    torch.randn(5)
    b_state, b, _ = _train(affect_pickle, 2, capture=True, step_k=0)
    assert a == b
    _equal_states(a_state, b_state)


@pytest.mark.heavy
def test_train_selfsup_resume_is_bit_equal(affect_pickle, tmp_path):
    want_state, want, _ = _train(affect_pickle, 3)
    ckdir = str(tmp_path / "ck")
    _train(affect_pickle, 2, ckdir)                     # "crashes" after epoch 2
    state, score, _ = _train(affect_pickle, 3, ckdir)   # resumes epoch 3 only
    assert TrainCheckpointer(ckdir).latest_step() == 3
    _equal_states(state, want_state)
    assert score == want
    # resuming past completion runs no epoch and still returns the score
    again_state, again, _ = _train(affect_pickle, 3, ckdir)
    _equal_states(again_state, want_state)
    assert again == want


def test_debug_nans_raises(affect_pickle, monkeypatch):
    """check_finite (--debug_nans) raises at the first non-finite loss."""
    orig = SelfSupTrainer.init

    def poisoned(self):
        model = orig(self)
        with torch.no_grad():
            model.dec_y.bias.fill_(float("nan"))
        return model

    monkeypatch.setattr(SelfSupTrainer, "init", poisoned)
    with pytest.raises(FloatingPointError):
        _train(affect_pickle, 1, check_finite=True)


# -- the CLIs ----------------------------------------------------------------

CLI_ARGS = ["--ds_name", "mosi", "--modality", "xy", "--num_epochs", "1",
            "--eval_freq", "1", "--step_k", "0", "--robust_test", "--mesh", "off",
            "--pos_embd", "--pos_learnable"]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """uml_tpu's and the port's multibench CLI, one epoch on a fixture at
    mosi's published input widths (vision 20, text 300)."""
    root = tmp_path_factory.mktemp("mb")
    os.makedirs(root / "data_files")
    make_affect_pickle(str(root / "data_files" / "mosi_data.pkl"), n=80, T=8,
                       dx=20, dy=300)
    mp = pytest.MonkeyPatch()
    mp.setenv("UML_TORCH_DEVICE", "cpu")
    outs = {}
    try:
        for name, mod in (("jax", jax_mb), ("torch", torch_mb)):
            args = mod.build_parser().parse_args(
                CLI_ARGS + ["--data_dir", str(root), "--results_dir",
                            str(root / f"results_{name}")])
            outs[name] = mod.main(args)
    finally:
        mp.undo()
    return root, outs


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


@pytest.mark.heavy
def test_multibench_cli_artifacts_match(cli_runs):
    root, outs = cli_runs
    assert outs["torch"].keys() == outs["jax"].keys()
    tree = _tree(root / "results_jax")
    assert _tree(root / "results_torch") == tree
    for rel in (rel for rel in tree if rel.endswith(".pth")):
        want = load_cache(str(root / "results_jax" / rel))
        got = load_cache(str(root / "results_torch" / rel))
        if rel.endswith("model.pth"):
            flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
            flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
            assert [(p, np.shape(v)) for p, v in flat_g] == [
                (p, np.shape(v)) for p, v in flat_w]
        elif rel.endswith("robustness.pth"):
            assert got.keys() == want.keys()
            assert all(len(got[k]) == len(want[k]) for k in want)
        elif rel.endswith("embeddings.pth"):
            assert {k: v.shape for k, v in got.items()} == {
                k: v.shape for k, v in want.items()}
        else:
            assert sorted(got) == sorted(want), rel
            for k, v in got.items():
                assert np.all(np.isfinite(v)), (rel, k)
    # the logged lines: the config, each step's metrics, each eval's scores
    # and the final scores, with the same keys
    (log,) = [rel for rel in tree if rel.endswith("metrics.jsonl")]
    lines = {}
    for name in ("jax", "torch"):
        with open(root / f"results_{name}" / log) as f:
            lines[name] = [sorted(json.loads(line)) for line in f]
    assert lines["torch"] == lines["jax"]
    assert any("train/pred_effective_rank_y" in keys for keys in lines["torch"])


@pytest.mark.heavy
def test_evaluate_on_carried_weights_matches(cli_runs, monkeypatch):
    """uml_tpu's trained model.pth, evaluated by both packages on the same
    eval streams: equal probe scores, losses within 1e-5."""
    root, _ = cli_runs
    (path,) = [os.path.join(root, "results_jax", p) for p in _tree(root / "results_jax")
               if p.endswith("model.pth")]
    tree = load_cache(path)
    data = str(root / "data_files" / "mosi_data.pkl")
    jm = jax_make_seq_uml(20, 300, 10, pos_embd=True, pos_learnable=True)
    jt = jax_selfsup.SelfSupTrainer(jm, seed=0)
    evals = jax_mb._affect_streams(jax_load_affect(data), None, 32)[2]
    want = jax_selfsup.evaluate(jt, jax.tree.map(jnp.asarray, tree), evals, "mosi")
    tm = sa.make_seq_uml(20, 300, 10, pos_embd=True, pos_learnable=True)
    trainer = SelfSupTrainer(tm, seed=0, device="cpu")
    trainer.init()
    tm.load_state_dict(seq_uml_state_dict_from_jax(tree))
    got = evaluate(trainer, torch_mb._affect_streams(load_affect(data), None, 32)[2],
                   "mosi")
    assert got.keys() == want.keys()
    for k in want:
        if "loss" in k:
            assert got[k] == pytest.approx(want[k], rel=TOL), k
        else:
            assert got[k] == want[k], k
    # the port's model.pth tree carries back unchanged
    back = seq_uml_state_dict_to_jax(tm.state_dict())
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                              jax.tree_util.tree_flatten_with_path(tree)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(p))


@pytest.mark.heavy
def test_collect_results_mb_over_uml_tpu_results(cli_runs, capsys, monkeypatch):
    root, _ = cli_runs
    printed = {}
    for name, mod in (("jax", jax_collect), ("torch", torch_collect)):
        monkeypatch.setattr("sys.argv", ["collect_results_mb", "--experiments_dir",
                                         str(root / "results_jax")])
        mod.main()
        printed[name] = capsys.readouterr().out
    assert printed["torch"] == printed["jax"] and "('mosi', 'xy')" in printed["torch"]


@pytest.mark.heavy
def test_multibench_mimic_cli_runs(tmp_path, monkeypatch):
    """The MIMIC path (x = the static [N, 5] row as one step) through the
    port's CLI, one epoch at zdim 10."""
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    os.makedirs(tmp_path / "data_files")
    n = 200
    rng = np.random.default_rng(0)
    with open(tmp_path / "data_files" / "im.pk", "wb") as f:
        pickle.dump({"ep_tdata": rng.standard_normal((n, 24, 12)),
                     "adm_features_all": rng.standard_normal((n, 5)),
                     "adm_labels_all": np.zeros((n, 6)),
                     "y_icd9": rng.integers(0, 2, (n, 20))}, f)
    args = torch_mb.build_parser().parse_args(
        ["--ds_name", "mimic", "--modality", "xy", "--num_epochs", "1",
         "--data_dir", str(tmp_path), "--results_dir", str(tmp_path / "r"), "--debug",
         "--debug_nans"])
    outs = torch_mb.main(args)
    assert all(np.isfinite(v) and 0 <= v <= 100 for v in outs.values())
    (model,) = [p for p in _tree(tmp_path / "r") if p.endswith("model.pth")]
    params = load_cache(str(tmp_path / "r" / model))["params"]
    assert params["xproj_in"]["kernel"].shape == (5, 10)
    assert params["dec_y"]["kernel"].shape == (10, 12)


def test_multibench_needs_a_card_or_the_cpu_flag(monkeypatch):
    monkeypatch.delenv("UML_TORCH_DEVICE", raising=False)
    args = torch_mb.build_parser().parse_args(["--ds_name", "mosi"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="UML_TORCH_DEVICE=cpu"):
            torch_mb.main(args)
    from uml_tpu_torch.core import meshes
    from uml_tpu_torch.core.sweep import run_sweep_cli

    launched = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(meshes, "launch_per_device",
                        lambda n: launched.append(n) or 0)
    # a Python call of main takes the job it runs in and starts no process
    assert meshes.mesh_from_flag("auto") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="UML_TORCH_DEVICE=cpu"):
            torch_mb.main(args)
    assert launched == []
    # the command line starts one process per card, unless a run says off
    monkeypatch.setattr(sys, "argv", ["multibench", "-d", "--ds_name", "mosi",
                                      "--mesh", "off"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="UML_TORCH_DEVICE=cpu"):
            run_sweep_cli(torch_mb.main, torch_mb.build_parser())
    assert launched == []
    monkeypatch.setattr(sys, "argv", ["multibench", "-d", "--ds_name", "mosi"])
    with pytest.raises(SystemExit) as stop:
        run_sweep_cli(torch_mb.main, torch_mb.build_parser())
    assert stop.value.code == 0 and launched == [2]
