"""MultiBench self-supervised UML CLI.

The port of uml_tpu/cli/multibench.py: the same parser, sweep contract,
results layout and artifacts (model.pth holds uml_tpu's {'params': ...}
tree with [in, out] kernels, written through
models/convert.py::seq_uml_state_dict_to_jax, so either package's
model.pth loads into the other).  It runs on the card
(core.device.default_device; ``UML_TORCH_DEVICE=cpu`` asks for the CPU);
``--mesh auto`` (the default) run from the command line with several
cards starts one process per card (core.meshes.launch_per_card) and
trains data-parallel (train/selfsup.py), rank 0 alone logging and
writing the artifacts; with one card it is the one-process run;
``--debug_nans`` raises at the first step whose loss is not finite;
``--ckpt_every N`` (any N > 0) saves after every epoch under
``seed_*/checkpoints`` and a rerun resumes from the latest.

Flag/behavior parity with MultiBench/main.py: same inner flags (modality,
lr, zdim, num_epochs, n_seeds, ds_name, step_k, pos_embd/pos_learnable,
alpha_x/alpha_y, infoNCE_loss), same -c/-s/-r/-d outer contract, per-dataset
hard-wired batch sizes and input dims (main.py:66-105), the two
independently-shuffled train streams realizing unpairedness (main.py:70-71),
multi-seed loop with mean/std aggregation and model.pth / results.pth
artifacts per seed (main.py:147-164).

    python -m uml_tpu_torch.cli.multibench -d --ds_name mosi --modality xy ...
    python -m uml_tpu_torch.cli.multibench -c configs/multibench.yaml -r

Data files live under --data_dir/data_files/ like the reference
(mosi_data.pkl, sarcasm.pkl, humor.pkl, mosei_senti_data.pkl, im.pk).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from uml_tpu_torch.core.checkpoint import TrainCheckpointer
from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.core.distributed import is_primary
from uml_tpu_torch.core.meshes import data_size, mesh_from_flag
from uml_tpu_torch.core.sweep import run_sweep_cli
from uml_tpu_torch.data.affect import (DATASET_CONFIG, AffectBatchStream, load_affect,
                                       make_robust_tests, map_labels)
from uml_tpu_torch.data.feature_cache import save_cache
from uml_tpu_torch.data.mimic import MimicBatchStream, load_mimic
from uml_tpu_torch.models.convert import seq_uml_state_dict_to_jax
from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
from uml_tpu_torch.train.probes import make_classifier
from uml_tpu_torch.train.selfsup import SelfSupTrainer, train_selfsup
from uml_tpu_torch.utils.logging import init_logger
from uml_tpu_torch.utils.seeding import set_random_seed

# reference modalities=[0,2]: x = vision, y = text (train.py:296)
MOD_X, MOD_Y = "vision", "text"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="MultiBench UML")
    p.add_argument("--modality", type=str, default="x")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--zdim", type=int, default=10)
    p.add_argument("--num_epochs", type=int, default=100)
    p.add_argument("--n_seeds", type=int, default=1)
    p.add_argument("--ds_name", type=str, default="mosi")
    p.add_argument("--step_k", type=int, default=-1)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--pos_embd", action="store_true")
    p.add_argument("--pos_learnable", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="raise at the first step whose loss is not finite")
    p.add_argument("--mesh", type=str, default="auto", choices=["auto", "off"],
                   help="'auto': data parallel over every card, one "
                        "process per card (started by this command, or by "
                        "torchrun / Slurm); one card runs alone; 'off': one process "
                        "on one card")
    p.add_argument("--run_name", type=str, default="")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--log_dir", type=str, default="./logs")
    p.add_argument("--alpha_x", type=float, default=1.0)
    p.add_argument("--alpha_y", type=float, default=1.0)
    p.add_argument("--infoNCE_loss", action="store_true")
    p.add_argument("--data_dir", type=str, default=".")
    p.add_argument("--eval_freq", type=int, default=100)
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="epoch-level checkpointing (0 = off); "
                        "restarted runs resume from the latest epoch")
    p.add_argument("--raw_text_file", type=str, default="",
                   help="one raw sentence per retained test row (or a JSON "
                        "list): enables the text-modality robust_test "
                        "degradation curves (re-embedded per noise level "
                        "via $UML_GLOVE_PATH or the hash-vocab fallback)")
    p.add_argument("--robust_test", action="store_true",
                   help="after training, probe-evaluate across 10 noise "
                        "levels per modality (affect get_data.py:326-410)")
    return p


def _affect_streams(splits, cfg, batch_size):
    """Build the unpaired train streams + paired eval streams."""

    def xy_stream(split, seed, shuffle):
        base = AffectBatchStream(split, batch_size, seed=seed, shuffle=shuffle)

        def epoch():
            for data, lengths, labels in base.epoch():
                yield ({"x": data[MOD_X], "y": data[MOD_Y]},
                       {"x": lengths[MOD_X], "y": lengths[MOD_Y]},
                       labels)

        return epoch

    # two independently-seeded shuffles = the unpairing trick (main.py:70-71)
    stream_1 = xy_stream(splits["train"], seed=42, shuffle=True)
    stream_2 = xy_stream(splits["train"], seed=43, shuffle=True)
    eval_streams = {
        "train": xy_stream(splits["train"], seed=0, shuffle=False),
        "val": xy_stream(splits["valid"], seed=0, shuffle=False),
        "test": xy_stream(splits["test"], seed=0, shuffle=False),
    }
    return stream_1, stream_2, eval_streams


def _mimic_streams(splits, batch_size):
    def xy_stream(split, seed, shuffle):
        base = MimicBatchStream(split, batch_size, seed=seed, shuffle=shuffle)

        def epoch():
            for static, ts, labels in base.epoch():
                bs = len(labels)
                yield ({"x": static[:, None, :], "y": ts},
                       {"x": np.ones(bs, np.int32),
                        "y": np.full(bs, ts.shape[1], np.int32)},
                       labels)

        return epoch

    stream_1 = xy_stream(splits["train"], 42, True)
    stream_2 = xy_stream(splits["train"], 43, True)
    eval_streams = {
        "train": xy_stream(splits["train"], 0, False),
        "val": xy_stream(splits["valid"], 0, False),
        # reference uses valid as test for mimic (main.py:96, FACTOR-CL)
        "test": xy_stream(splits["valid"], 0, False),
    }
    return stream_1, stream_2, eval_streams


def robust_evaluate(trainer, splits, batch_size, ds_name,
                    levels=10, raw_text=None):
    """Degradation curves: test-split probes under per-modality noise.

    Mirrors the reference's robust_test loaders (vision/audio/all-timeseries
    noise at levels 0..9, noise_level=l/10 per-modality and l/30 combined;
    the GloVe text path needs downloadable vectors — see
    data/text_embed.reembed_noisy_text for the pluggable equivalent).

    Probes are fit ONCE on the clean train embeddings; each noise level
    only re-embeds the test split and scores (the reference refits
    everything per level — pure waste).
    """
    import copy

    def embed(split):
        stream = _affect_streams(
            {"train": split, "valid": split, "test": split}, None,
            batch_size)[2]["test"]
        zx, zy, _, _, labels = trainer.extract_embeddings(stream())
        return zx, zy, map_labels(labels, ds_name)

    tr_zx, tr_zy, tr_lab = embed(splits["train"])
    clfs = {}
    for key, X in (("x", tr_zx), ("y", tr_zy),
                   ("xy", np.concatenate([tr_zx, tr_zy], axis=1))):
        clfs[key] = make_classifier("logistic", ds_name)
        clfs[key].fit(X, tr_lab)

    noisy = make_robust_tests(splits["test"], levels=levels)
    # audio variants exist for parity but don't perturb the (vision, text)
    # modalities the probes consume in the reference's mod [0,2] setup
    curves = {}
    for modality, variants in (("vision", noisy["vision"]),
                               ("timeseries", noisy["timeseries"])):
        curve = []
        for level, variant in enumerate(variants):
            test = copy.copy(splits["test"])
            test.arrays = dict(splits["test"].arrays)
            if modality == "vision":
                test.arrays["vision"] = variant
            else:
                test.arrays["vision"], test.arrays["audio"], \
                    test.arrays["text"] = variant
            te_zx, te_zy, te_lab = embed(test)
            entry = {
                "test/score_x": clfs["x"].score(te_zx, te_lab),
                "test/score_y": clfs["y"].score(te_zy, te_lab),
                "test/score_xy": clfs["xy"].score(
                    np.concatenate([te_zx, te_zy], axis=1), te_lab),
            }
            curve.append(entry)
            print(f"[robust {modality} level {level}] "
                  f"score_xy={entry['test/score_xy']:.4f}")
        curves[modality] = curve

    if raw_text is not None:
        # text-modality degradation (get_data.py:332-347): typo-corrupt the
        # raw sentences per level and re-embed.  Zero-egress: $UML_GLOVE_PATH
        # when present, else the deterministic hash-vocabulary embedder with
        # GloVe OOV->zeros semantics (data/text_embed.py).
        from uml_tpu_torch.data.robustness import add_text_noise
        from uml_tpu_torch.data.text_embed import default_text_embedder

        assert len(raw_text) == len(splits["test"]), (
            f"raw_text must have one sentence per retained test row "
            f"({len(raw_text)} vs {len(splits['test'])})")
        t_max = splits["test"].arrays["text"].shape[1]
        dim = splits["test"].arrays["text"].shape[-1]
        embedder = default_text_embedder(raw_text, dim=dim)
        rng = np.random.RandomState(0)
        curve = []
        for level in range(levels):
            noisy = add_text_noise(raw_text, level / 10, rng=rng)
            test = copy.copy(splits["test"])
            test.arrays = dict(splits["test"].arrays)
            test.lengths = dict(splits["test"].lengths)
            test.arrays["text"] = embedder(noisy, t_max)
            test.lengths["text"] = np.clip(
                [len(s.split()) for s in noisy], 1, t_max).astype(np.int32)
            te_zx, te_zy, te_lab = embed(test)
            entry = {
                "test/score_x": clfs["x"].score(te_zx, te_lab),
                "test/score_y": clfs["y"].score(te_zy, te_lab),
                "test/score_xy": clfs["xy"].score(
                    np.concatenate([te_zx, te_zy], axis=1), te_lab),
            }
            curve.append(entry)
            print(f"[robust text level {level}] "
                  f"score_xy={entry['test/score_xy']:.4f}")
        curves["text"] = curve
    return curves


def main(args):
    mesh = mesh_from_flag(getattr(args, "mesh", "auto"))
    if mesh is not None:
        print(f"=> Data-parallel UML steps over {data_size(mesh)} ranks")
    primary = is_primary()
    device = default_device()
    cfg = DATASET_CONFIG[args.ds_name]
    batch_size = cfg["batch_size"]
    indims = cfg["indims"]

    exp_name = (f"log_{args.run_name}{args.ds_name}/mod{args.modality}/"
                f"epochs{args.num_epochs}/zdim{args.zdim}/"
                f"alpha_x{args.alpha_x}_alpha_y{args.alpha_y}/"
                f"step_k{args.step_k}/pos_embd_{args.pos_embd}"
                f"_learnable_{args.pos_learnable}/lr{args.lr}")
    results_dir = os.path.join(args.results_dir, exp_name)

    outs = {k: [] for k in ("test/score_x", "test/score_y", "test/score_xy",
                            "val/score_x", "val/score_y", "val/score_xy")}
    for seed in range(args.n_seeds):
        set_random_seed(seed)
        seed_dir = os.path.join(results_dir, f"seed_{seed}")
        print(f"Results will be saved to {seed_dir}")
        logger = init_logger("unpaired_multimodal",
                             config={**vars(args), "seed": seed},
                             tags=[args.ds_name, args.modality,
                                   "self-supervised"],
                             logdir=seed_dir if not args.debug else None
                             ) if primary else None

        if args.ds_name == "mimic":
            splits = load_mimic(
                os.path.join(args.data_dir, "data_files", cfg["file"]), task=7)
            stream_1, stream_2, eval_streams = _mimic_streams(splits, batch_size)
        else:
            splits = load_affect(
                os.path.join(args.data_dir, "data_files", cfg["file"]),
                data_type=args.ds_name, vision_norm=cfg["vision_norm"])
            stream_1, stream_2, eval_streams = _affect_streams(
                splits, cfg, batch_size)

        print(f"Dataset: {args.ds_name}\nBatch size: {batch_size}")
        print(f"Modality Info: xdim: {indims[0]}, ydim: {indims[1]}, "
              f"zdim: {args.zdim}")

        model = make_seq_uml(indims[0], indims[1], args.zdim,
                             pos_embd=args.pos_embd,
                             pos_learnable=args.pos_learnable,
                             info_nce=args.infoNCE_loss)
        trainer = SelfSupTrainer(model, lr=args.lr, seed=seed, device=device)
        checkpointer = (TrainCheckpointer(os.path.join(seed_dir, "checkpoints"),
                                          mesh=mesh)
                        if args.ckpt_every else None)
        model, score, embeddings = train_selfsup(
            trainer, stream_1, stream_2, eval_streams,
            mode=args.modality, num_epochs=args.num_epochs,
            step_k=args.step_k, alpha_x=args.alpha_x, alpha_y=args.alpha_y,
            ds_name=args.ds_name, eval_freq=args.eval_freq,
            augment=args.augment, logger=logger, checkpointer=checkpointer,
            check_finite=args.debug_nans, mesh=mesh)

        print("seed: ", seed, " score: ", score)
        print("=====================================")
        for k in outs:
            outs[k].append(100 * score[k])
        if not primary:
            continue

        os.makedirs(seed_dir, exist_ok=True)
        save_cache(seq_uml_state_dict_to_jax(model.state_dict()),
                   os.path.join(seed_dir, "model.pth"))
        save_cache(score, os.path.join(seed_dir, "results.pth"))
        if embeddings is not None and embeddings["x1"]:
            # per-eval capture-embedding history (main.py:151-152)
            save_cache({k: np.stack(v) for k, v in embeddings.items()},
                       os.path.join(seed_dir, "embeddings.pth"))
        if args.robust_test and args.ds_name != "mimic":
            raw_text = None
            if getattr(args, "raw_text_file", ""):
                import json

                with open(args.raw_text_file) as f:
                    head = f.read()
                raw_text = (json.loads(head) if head.lstrip().startswith("[")
                            else [ln for ln in head.splitlines() if ln.strip()])
            curves = robust_evaluate(trainer, splits, batch_size,
                                     args.ds_name, raw_text=raw_text)
            save_cache(curves, os.path.join(seed_dir, "robustness.pth"))
        if hasattr(logger, "finish"):
            logger.finish()

    print(outs)
    outs_mean = {k: float(np.mean(v)) for k, v in outs.items()}
    outs_std = {k: float(np.std(v)) for k, v in outs.items()}
    print("Final scores (mean): ", outs_mean)
    print("Final scores (std): ", outs_std)
    if primary:
        os.makedirs(results_dir, exist_ok=True)
        save_cache(outs, os.path.join(results_dir, "results.pth"))
    return outs_mean


if __name__ == "__main__":
    run_sweep_cli(main, build_parser(), description="MultiBench Experiment",
                  default_config="config.yaml", require_run_flag=True)
