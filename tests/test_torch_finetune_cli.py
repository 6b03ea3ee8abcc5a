"""The finetune and collect_results CLIs of both packages on one fixture.

A seeded tiny OpenAI-schema checkpoint is written as ViT-B-32.pt (patch 32
at resolution 224, so 50 positions; width 128 with 2 heads and 2 layers in
each tower; embedding width 512, the ViT-B/32 config's, which both
finetune CLIs take from the config table).  The port's ``features`` CLI
writes the text cache; both packages' ``finetune`` read that same cache
(the interop of the two), with ``--modality crossmodal``, for the frozen
grid ``smoke`` and the full-model grid ``smoke_full``.  uml_tpu decodes
with PIL here (its native decoder off), as the port does.

Equal: the artifact trees, the keys of test_result.pth and results.pth
(the full path's ``model["backbone"]`` is a flax tree in uml_tpu and an
OpenAI-schema state_dict in the port, so only its presence is compared),
the number of evals and of logged steps, and collect_results' best row.

The bf16 losses.  Step 0 sees the same weights, the same zero-shot head
and the same batches: its text loss (the same cached features) agrees
within rtol 1e-6, its image loss within 1e-2 (measured 8.2e-4: the two
packages round the image tower's intermediates to bf16 at different
points).  The first five steps agree within 3% (measured 0.66% for
smoke, 0.85% for smoke_full).  Later steps drift apart: the logits are
scaled by exp(4.6) = 100, so per-mille feature differences become logit
differences of order 0.1.
- smoke trains the head alone (a convex problem on fixed features):
  over all 200 steps the gap stays within 0.3 of the run's largest loss
  (measured 0.135).
- smoke_full trains the whole tower with adamw, which turns bf16
  rounding noise in small gradients into lr-sized steps of either sign:
  the trajectory is chaotic after a few steps.  The port against itself,
  with the MLP pre-activation stash on and off (two valid rounding
  orders), differs by 7.6 at a largest loss of 14.7; the port against
  uml_tpu by 8.2.  So after step 5 only the training itself is held:
  every loss finite, and the mean of the last ten below step 0's.
  The fp32 run of tests/test_torch_train.py holds the full-model
  trajectory step by step.
"""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_data_fewshot import make_caltech_fixture
from uml_tpu.cli import collect_results as jax_collect
from uml_tpu.cli import finetune as jax_ft
from uml_tpu_torch.cli import collect_results as torch_collect
from uml_tpu_torch.cli import features as torch_features
from uml_tpu_torch.cli import finetune as torch_ft
from uml_tpu_torch.cli import generate_fewshot as torch_gf
from uml_tpu_torch.data.feature_cache import load_cache
from uml_tpu_torch.models.clip import CLIP, ClipConfig

STEP0_IMAGE_RTOL = 1e-2
STEP0_TEXT_RTOL = 1e-6
FIRST_STEPS_RTOL = 3e-2
TRAJECTORY_REL = 0.3
TINY_B32 = ClipConfig(embed_dim=512, image_resolution=224, vision_layers=2,
                      vision_width=128, vision_patch_size=32,
                      transformer_width=128, transformer_heads=2,
                      transformer_layers=2)
MODALITY_DIR = "finetune-text_hand_crafted-image_crop_-alpha_0.5"


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _metrics(root):
    (path,) = [os.path.join(root, p) for p in _tree(root)
               if p.endswith("metrics.jsonl")]
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.heavy
@pytest.mark.parametrize("grid", ["smoke", "smoke_full"])
def test_finetune_cli_both_packages(tmp_path, monkeypatch, grid):
    torch.set_num_threads(1)
    root = make_caltech_fixture(str(tmp_path / "data"))
    weights = tmp_path / "weights"
    weights.mkdir()
    model = CLIP(TINY_B32).init_random(torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    import uml_tpu.native

    monkeypatch.setattr(uml_tpu.native, "native_available", lambda: False)

    common = ["--data_dir", root, "--indices_dir", f"{root}/indices",
              "--feature_dir", f"{root}/features", "--dataset", "caltech101",
              "--clip-encoder", "ViT-B/32", "--train-shot", "2", "--seed", "1",
              "--mesh", "off"]
    torch_gf.main(torch_gf.build_parser().parse_args(common[:4] + [
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    args = torch_features.build_parser().parse_args(
        common + ["--text-augmentation", "hand_crafted", "--batch-size", "8",
                  "--num-workers", "2"])
    args.overwrite, args.force_rerun = False, False
    torch_features.main(args)

    exp, best = {}, {}
    for name, cli in (("jax", jax_ft), ("torch", torch_ft)):
        exp[name] = str(tmp_path / f"experiments_{name}")
        args = cli.build_parser().parse_args(common + [
            "--result_dir", exp[name], "--text_type", "hand_crafted",
            "--modality", "crossmodal", "--alpha", "0.5",
            "--hyperparams", grid])
        args.overwrite, args.force_rerun = False, False
        _, best[name], _ = cli.main(args)

    assert _tree(exp["torch"]) == _tree(exp["jax"])
    run_dir = os.path.join("caltech101-shot_2-seed_1", "ViT-B-32", MODALITY_DIR,
                           "zeroshot")
    (sub,) = [p for p in os.listdir(os.path.join(exp["jax"], run_dir))
              if p.startswith("optim_")]
    results, tests = {}, {}
    for name in exp:
        results[name] = load_cache(os.path.join(exp[name], run_dir, "results.pth"))
        tests[name] = load_cache(os.path.join(exp[name], run_dir, sub,
                                              "test_result.pth"))
    assert results["torch"].keys() == results["jax"].keys()
    assert results["torch"]["hparams"] == results["jax"]["hparams"]
    assert tests["torch"].keys() == tests["jax"].keys()
    assert tests["torch"]["model"].keys() == tests["jax"]["model"].keys()
    assert ("backbone" in tests["torch"]["model"]) == (grid == "smoke_full")
    for t in (*results.values(), *tests.values()):
        assert np.isfinite(np.asarray(t["test_acc"], np.float64)).all()
        assert np.isfinite(np.asarray(t["val_acc"], np.float64)).all()
    assert tests["torch"]["iter"] == tests["jax"]["iter"]

    logs = {name: _metrics(os.path.join(exp[name], run_dir)) for name in exp}
    evals = {name: sum("val/val_acc" in row for row in rows)
             for name, rows in logs.items()}
    assert evals["torch"] == evals["jax"] >= 1
    steps = {name: [row for row in rows if "train/image_loss" in row]
             for name, rows in logs.items()}
    assert len(steps["torch"]) == len(steps["jax"]) == \
        (200 if grid == "smoke" else 30)
    for key, step0_rtol in (("train/image_loss", STEP0_IMAGE_RTOL),
                            ("train/text_loss", STEP0_TEXT_RTOL)):
        got = np.array([row[key] for row in steps["torch"]])
        want = np.array([row[key] for row in steps["jax"]])
        assert abs(got[0] - want[0]) <= step0_rtol * abs(want[0]), (key, got[0], want[0])
        np.testing.assert_allclose(got[:5], want[:5], rtol=FIRST_STEPS_RTOL,
                                   atol=1e-6, err_msg=key)
        if grid == "smoke":
            assert np.abs(got - want).max() <= TRAJECTORY_REL * want.max(), key
    for rows in steps.values():
        losses = np.array([row["train/image_loss"] for row in rows])
        assert np.isfinite(losses).all()
        assert losses[-10:].mean() < losses[0]

    summaries = {}
    for name, mod in (("jax", jax_collect), ("torch", torch_collect)):
        summaries[name] = mod.collect_results(
            datasets="caltech101", seeds=1, encoders="ViT-B-32", train_shots=2,
            init_types="zeroshot", modality_types=MODALITY_DIR,
            experiments_dir=exp[name])
    assert summaries["torch"].keys() == summaries["jax"].keys()
    for key, row in summaries["jax"].items():
        got = summaries["torch"][key]
        assert got["best_hparams"] == row["best_hparams"]
        assert got["best_seed"] == row["best_seed"] and got["n_seeds"] == row["n_seeds"]
        assert os.path.relpath(got["best_path"], exp["torch"]) == \
            os.path.relpath(row["best_path"], exp["jax"])
        assert os.path.isfile(got["best_path"])
