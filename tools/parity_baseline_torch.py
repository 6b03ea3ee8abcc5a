"""BASELINE.json parity harness of the port (the twin of parity_baseline.py).

Runs the BASELINE configs end to end through ``uml_tpu_torch`` where the
pretrained weights (``UML_CLIP_WEIGHTS_DIR``) and the datasets are on
disk, and prints the accuracies beside the reference targets.  Where they
are missing it reports what is missing and stops; it never fetches them.

    python tools/parity_baseline_torch.py --data_dir /data --indices_dir indices
    python tools/parity_baseline_torch.py --dry_run [--skip_gaussian]

Configs (BASELINE.json):
  #1 Gaussian synthetic (always runnable; on the card unless
     UML_TORCH_DEVICE=cpu)
  #2 Caltech101 / OxfordPets 16-shot crossmodal finetune over ViT-B/16
     features
  #3 ImageNet 16-shot UML finetune with CUPL descriptors

``--dry_run`` proves the plumbing without assets: a synthetic
caltech-layout fixture (``uml_tpu_torch.graft_entry.make_caltech_fixture``)
through generate_fewshot -> features -> finetune with a random-init
ViT-B/16 and the ``smoke`` hyperparameters (accuracies meaningless),
and nothing else, as parity_baseline.py's.  Imports no JAX and nothing of
uml_tpu.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def check_assets(args) -> list[str]:
    """What configs #2 and #3 need and this machine lacks."""
    from uml_tpu_torch.data.registry import dataset_classes
    from uml_tpu_torch.models.encoders import clip_weights_path

    missing = []
    if clip_weights_path("ViT-B/16") is None:
        missing.append("CLIP ViT-B/16 weights (set UML_CLIP_WEIGHTS_DIR)")
    for ds in args.datasets:
        try:
            dataset_classes[ds](args.data_dir)
        except Exception as e:
            missing.append(f"dataset {ds}: {type(e).__name__} {e}")
    return missing


def run_gaussian(num_steps: int = 2000) -> dict:
    """BASELINE config #1: the x-only and paired (xy) runs on the
    Gaussian data, ``num_steps`` each."""
    from uml_tpu_torch.data.gaussian import generate_data
    from uml_tpu_torch.train.gaussian import make_model, train_gaussian

    cfg = dict(dim_c=10, dim_x=5, dim_y=5, dim_obs=50, noise_std=0.09,
               attenuate_x=True, attenuation=0.05,
               shared_latent_distribution_type="gaussian")
    train = generate_data({"seed": 42, "num_samples": 10000, **cfg})
    val = generate_data({"seed": 43, "num_samples": 2000, **cfg, "attenuate_x": False})
    out = {}
    for mode in ("xy", "x"):
        n = 10000
        pools = ({"x": train["x"][: n // 2], "y": train["y"][: n - n // 2]}
                 if mode == "xy" else {"x": train["x"], "y": train["y"]})
        res = train_gaussian(make_model(50, 128, 10), pools, val["x"], val["y"],
                             mode=mode, num_steps=num_steps, batch_size=512, seed=0)
        out[mode] = dict(val_loss_x=res.final_val_loss_x, cka=res.final_cka,
                         mknn=res.final_mknn)
    print("[gaussian] xy vs x val_loss_x:", round(out["xy"]["val_loss_x"], 4), "vs",
          round(out["x"]["val_loss_x"], 4), "| xy cka:", round(out["xy"]["cka"], 4))
    return out


def run_fewshot_probe(args, dataset, dry_run=False):
    """BASELINE config #2 / #3: features and the crossmodal finetune;
    ``dry_run``: a random-init encoder, 3 shots and the smoke grid ->
    the best test accuracy."""
    from uml_tpu_torch.graft_entry import run_fewshot_cli

    shot = "3" if dry_run else "16"
    _, best_val, best_test = run_fewshot_cli(
        args.data_dir, dataset=dataset, encoder="ViT-B/16", shot=shot,
        seed=str(args.seed), alpha="1.0", random_init=dry_run,
        text_type="hand_crafted" if dry_run else "gpt3_cupl",
        dirs={"indices": args.indices_dir, "features": args.feature_dir,
              "experiments": args.result_dir},
        extra_features=() if dry_run else ("--descriptor_type", "gpt3_cupl"),
        extra_finetune=("--hyperparams", "smoke" if dry_run else "clip_linear",
                        "--eval_test"))
    tag = " (dry-run: random-init, accuracy meaningless)" if dry_run else ""
    print(f"[{dataset}] {shot}-shot crossmodal: val {best_val:.4f} "
          f"test {best_test:.4f}{tag}")
    return best_test


def run_dry(args) -> float:
    """--dry_run: the plumbing on the synthetic fixture, without assets."""
    from uml_tpu_torch.graft_entry import make_caltech_fixture

    root = tempfile.mkdtemp(prefix="uml_parity_dry_")
    try:
        make_caltech_fixture(root)
        args.data_dir = root
        args.indices_dir = os.path.join(root, "indices")
        args.feature_dir = os.path.join(root, "features")
        args.result_dir = os.path.join(root, "experiments")
        best_test = run_fewshot_probe(args, "caltech101", dry_run=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print("[dry-run] plumbing OK: generate_fewshot -> features -> finetune "
          "completed on the synthetic fixture")
    return best_test


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="BASELINE parity harness (uml_tpu_torch)")
    p.add_argument("--data_dir", default="./data")
    p.add_argument("--indices_dir", default="./indices")
    p.add_argument("--feature_dir", default="./features")
    p.add_argument("--result_dir", default="./experiments")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--datasets", nargs="+",
                   default=["caltech101", "oxford_pets", "imagenet"])
    p.add_argument("--skip_gaussian", action="store_true")
    p.add_argument("--dry_run", action="store_true",
                   help="prove the parity plumbing on a synthetic fixture with "
                        "random-init weights (no assets needed)")
    args = p.parse_args(argv)

    if args.dry_run:
        run_dry(args)
        return 0
    if not args.skip_gaussian:
        run_gaussian()
    missing = check_assets(args)
    if missing:
        print("Cannot run the accuracy-parity configs here; missing assets:")
        for m in missing:
            print("  -", m)
        print("Populate them and re-run; everything else is one command.")
        return 0
    for ds in args.datasets:
        run_fewshot_probe(args, ds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
