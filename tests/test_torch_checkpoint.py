"""Mid-run checkpoints and resume in the port (core/checkpoint.py,
train/supervised.py, ``finetune --ckpt_every``) on the CPU.

* ``TrainCheckpointer``: the round trip of a tree of tensors and numbers,
  the newest ``MAX_TO_KEEP`` steps kept, no temporary file left; a run
  with no checkpointer (None, the disabled state) writes nothing.
* ``train`` stopped at 30 and resumed to 60 equals an uninterrupted 60-step
  run bit for bit, and uml_tpu's uninterrupted run within 1e-5 (as
  tests/test_checkpoint.py does for uml_tpu).
* The finetune CLI with ``--ckpt_every``: a run that dies right after its
  first checkpoint, run again, writes the test_result.pth of an
  uninterrupted run, bit for bit.
* An RN full-model run (BatchNorm in train form) stopped and resumed
  equals the uninterrupted run bit for bit, running statistics included.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_checkpoint import _toy
from uml_tpu.models.uml_head import UMLHead as JaxUMLHead
from uml_tpu.train import optim as joptim
from uml_tpu.train import supervised as jsup
from uml_tpu_torch.core.checkpoint import MAX_TO_KEEP, TrainCheckpointer
from uml_tpu_torch.core.prng import epoch_perm, host_rng, make_rng
from uml_tpu_torch.models.convert import uml_head_params_from_jax
from uml_tpu_torch.models.uml_head import UMLHead
from uml_tpu_torch.train.optim import build_optimizer, build_schedule
from uml_tpu_torch.train.supervised import CyclicBatcher, eval_batches, train


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _equal_trees(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            _equal_trees(a[key], b[key])
        else:
            assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key])), key


def test_checkpointer_roundtrip_and_disabled(tmp_path, monkeypatch):
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    assert MAX_TO_KEEP == 2 and ck.latest_step() is None
    assert ck.restore_latest() == (None, None)
    for step in (7, 14, 21):
        ck.save(step, {"a": torch.arange(6.0).reshape(2, 3) * step, "step": step,
                       "nested": {"b": torch.ones(2, dtype=torch.int8)},
                       "best": None, "acc": 0.5})
    assert ck.latest_step() == 21
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_14.pt", "step_21.pt"]
    step, state = ck.restore_latest()
    assert step == 21 and state["step"] == 21 and state["best"] is None
    assert torch.equal(state["a"], torch.arange(6.0).reshape(2, 3) * 21)
    assert state["nested"]["b"].dtype == torch.int8 and state["acc"] == 0.5
    off = tmp_path / "off"
    off.mkdir()
    monkeypatch.chdir(off)
    run, _ = _toy_runs()
    assert run(None, 20)["iter"] is not None       # ckpt_every=10, no checkpointer
    assert os.listdir(off) == []


def test_prng_streams_match_uml_tpu():
    from uml_tpu.core import prng as jprng

    np.testing.assert_array_equal(epoch_perm(host_rng(3), 17),
                                  jprng.epoch_perm(jprng.host_rng(3), 17))
    a, b = make_rng(5), make_rng(5)
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))


def _toy_runs():
    feats, labels = _toy()
    val = eval_batches(feats[:30], labels[:30], 16)
    jm = JaxUMLHead(feat_dim=8, num_classes=3, logit_scale=0.0)
    init = jm.init_params()

    def run(ckpt_dir, max_iters):
        model = UMLHead(feat_dim=8, num_classes=3, logit_scale=0.0)
        opt = build_optimizer("adamw", build_schedule(0.01, "cosine", 0, 60), 0.0)
        return train(model, CyclicBatcher(feats, labels, 16, seed=0),
                     CyclicBatcher(feats, labels, 16, seed=1), val,
                     optimizer=opt, max_iters=max_iters, eval_freq=20, patience=100,
                     init_params=uml_head_params_from_jax(
                         {k: np.asarray(v) for k, v in init.items()}),
                     checkpointer=TrainCheckpointer(ckpt_dir) if ckpt_dir else None,
                     ckpt_every=10)

    def run_jax():
        opt = joptim.build_optimizer("adamw", joptim.build_schedule(0.01, "cosine",
                                                                    0, 60), 0.0)
        return jsup.train(jm, jsup.CyclicBatcher(feats, labels, 16, seed=0),
                          jsup.CyclicBatcher(feats, labels, 16, seed=1), val,
                          optimizer=opt, max_iters=60, eval_freq=20, patience=100,
                          init_params=init)

    return run, run_jax


def test_train_resume_matches_uninterrupted(tmp_path, capsys):
    run, run_jax = _toy_runs()
    ref = run(None, 60)
    ckdir = str(tmp_path / "resume")
    first = run(ckdir, 30)
    assert first["iter"] == 20
    assert TrainCheckpointer(ckdir).latest_step() == 30
    resumed = run(ckdir, 60)
    assert "Resuming from checkpoint at iter 30" in capsys.readouterr().out
    assert (resumed["iter"], resumed["val_acc"], resumed["val_loss"]) == (
        ref["iter"], ref["val_acc"], ref["val_loss"])
    _equal_trees(resumed["model"], ref["model"])
    jref = run_jax()
    assert resumed["val_acc"] == pytest.approx(jref["val_acc"], abs=1e-6)
    assert resumed["iter"] == jref["iter"]
    np.testing.assert_allclose(resumed["model"]["head_w"].numpy(),
                               np.asarray(jref["model"]["head_w"]), atol=1e-5)


@pytest.mark.heavy
def test_finetune_cli_ckpt_every_resumes(tmp_path, monkeypatch):
    """A combo killed right after its first checkpoint resumes on a rerun
    and saves what an uninterrupted run saves (the frozen ``smoke`` grid on
    tests/test_torch_finetune_cli.py's tiny ViT-B/32 checkpoint)."""
    from tests.test_data_fewshot import make_caltech_fixture
    from tests.test_torch_finetune_cli import TINY_B32
    from uml_tpu_torch.cli import features as torch_features
    from uml_tpu_torch.cli import finetune as torch_ft
    from uml_tpu_torch.cli import generate_fewshot as torch_gf
    from uml_tpu_torch.core import checkpoint as ckpt_mod
    from uml_tpu_torch.data.feature_cache import load_cache
    from uml_tpu_torch.models.clip import CLIP
    import uml_tpu_torch.native

    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(CLIP(TINY_B32).init_random(torch.Generator().manual_seed(1)).state_dict(),
               str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(uml_tpu_torch.native, "native_available", lambda: False)
    common = ["--data_dir", root, "--indices_dir", f"{root}/indices",
              "--feature_dir", f"{root}/features", "--dataset", "caltech101",
              "--clip-encoder", "ViT-B/32", "--train-shot", "2", "--seed", "1",
              "--mesh", "off"]
    torch_gf.main(torch_gf.build_parser().parse_args(common[:4] + [
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    args = torch_features.build_parser().parse_args(
        common + ["--text-augmentation", "hand_crafted", "--batch-size", "8",
                  "--num-workers", "1"])
    args.overwrite, args.force_rerun = False, False
    torch_features.main(args)

    def finetune(result_dir):
        args = torch_ft.build_parser().parse_args(common + [
            "--result_dir", str(tmp_path / result_dir), "--text_type",
            "hand_crafted", "--modality", "crossmodal", "--alpha", "0.5",
            "--hyperparams", "smoke", "--ckpt_every", "50"])
        args.overwrite, args.force_rerun = False, False
        torch_ft.main(args)
        (path,) = [os.path.join(d, f) for d, _, files
                   in os.walk(tmp_path / result_dir) for f in files
                   if f == "test_result.pth"]
        return path

    want = load_cache(finetune("uninterrupted"))

    class Killed(Exception):
        pass

    save = ckpt_mod.TrainCheckpointer.save

    def save_then_die(self, step, state):
        save(self, step, state)
        raise Killed(step)

    monkeypatch.setattr(ckpt_mod.TrainCheckpointer, "save", save_then_die)
    with pytest.raises(Killed):
        finetune("resumed")
    monkeypatch.setattr(ckpt_mod.TrainCheckpointer, "save", save)
    (ckdir,) = [d for d, _, files in os.walk(tmp_path / "resumed")
                if "step_50.pt" in files]
    assert os.path.basename(ckdir) == "checkpoints"
    assert not [f for _, _, files in os.walk(tmp_path / "resumed") for f in files
                if f == "test_result.pth"]
    path = finetune("resumed")
    with open(os.path.join(os.path.dirname(os.path.dirname(path)), "log.txt")) as f:
        assert "Resuming from checkpoint at iter 50" in f.read()
    got = load_cache(path)
    assert set(got) == set(want) == {"test_acc", "val_acc", "model", "iter"}
    assert (got["test_acc"], got["val_acc"], got["iter"]) == (
        want["test_acc"], want["val_acc"], want["iter"])
    _equal_trees(got["model"], want["model"])


@pytest.mark.heavy
def test_rn_full_model_resume_restores_running_statistics(tmp_path):
    """An RN tower training with BatchNorm in train form: stopped at 10,
    resumed to 20, it equals the uninterrupted 20-step run bit for bit,
    the parameters and the running statistics of the best snapshot and of
    the model at the end."""
    from tests.test_torch_clip_resnet_train import _items_and_val, _pair
    from uml_tpu_torch.data.loader import RawImageStream

    items, val = _items_and_val(tmp_path)

    def run(ckpt_dir, max_iters):
        _, _, model = _pair()
        opt = build_optimizer("adamw", build_schedule(1e-3, "cosine", 2, 20), 0.01)
        out = train(model, RawImageStream(items, "crop", 8, seed=0, num_workers=1,
                                          size=(32, 32)),
                    CyclicBatcher(np.random.default_rng(0).standard_normal(
                        (12, 16)).astype(np.float32), np.arange(12) % 3, 8, seed=1),
                    val, optimizer=opt, max_iters=max_iters, eval_freq=5,
                    patience=100, checkpointer=TrainCheckpointer(ckpt_dir)
                    if ckpt_dir else None, ckpt_every=5)
        return out, model.state_dict()

    ref, ref_sd = run(None, 20)
    ckdir = str(tmp_path / "ck")
    run(ckdir, 10)
    step, state = TrainCheckpointer(ckdir).restore_latest()
    assert step == 10
    stats = [k for k in state["model"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * 19
    got, got_sd = run(ckdir, 20)
    assert (got["iter"], got["val_acc"]) == (ref["iter"], ref["val_acc"])
    _equal_trees(got["model"], ref["model"])
    _equal_trees(got_sd, ref_sd)
    init = _pair()[2].state_dict()
    assert all(not torch.equal(got_sd[k], init[k]) for k in stats)
