"""Supervised UML finetune CLI (CLIP and DINO / DINOv2 encoders).

The port of uml_tpu/cli/finetune.py (flag and artifact parity with the
reference's vision_language/finetune.py):

  * loads the cached text features (``features`` CLI, text_outdir scheme)
    into a TextFeatureSet with the text_shot int/'average' semantics;
  * loads the few-shot image benchmark;
  * sweeps HYPER_DICT[--hyperparams], one directory per combo
    (hparam_str), skipping a combo whose test_result.pth exists;
  * alternating-modality training (train/supervised.py), zero-shot head
    init, eval every 100 iterations, early stopping;
  * writes test_result.pth {test_acc, val_acc, model, iter} per combo and
    results.pth {test_acc, val_acc, hparams} per sweep, and log.txt.

Two paths, as in uml_tpu.  The frozen path (every grid but the
full-finetune ones) encodes each split once with the frozen CLIP and
trains the head on the features; with ``--vision_model`` the frozen DINO
encoder does (``features._HFEncoderAdapter``), the text features come
from the ``--language_model`` cache, and the head is UML's: ``img_proj``
from the DINO width into the text width (crossmodal) or ``--common_dim``
(uml_tpu/cli/finetune.py:176-186, 356-364).  The full path
(``full_ds_full_model_finetune``, ``smoke_full``) streams raw uint8
batches through the trainable image tower, the CLIP's (``make_uml_clip_head``)
or with ``--vision_model`` the DINO's (``make_uml_dino_head``: UML's head
with ``img_proj`` into the text width or ``--common_dim``, the text
features from the ``--language_model`` cache; uml_tpu/cli/finetune.py:
147-154): on the card its layers run the training kernels of
``uml_tpu_torch/csrc`` (DINO's MLP halves with exact GELU, eps 1e-6).
Which ones is set, as in
uml_tpu, by environment variables, not flags: ``UML_BWD_STASH`` ("1", the
default: the attention halves stash qkv and the attention output; "0":
they recompute them in the backward), ``UML_MLP_STASH`` ("auto", the
default: the MLP halves stash their pre-activation while one layer's
stash stays under 256 MiB; "1" / "0" force it) and, with the MLP stash
off, ``UML_MLP_BWD`` ("kernel" or "dw": the MLP backward kernels; any
other value: the plain VJP; unset: "kernel" on the card, the plain VJP
on the CPU).  ``--strict_reference_parity`` freezes exactly as
the reference does (only for ``linear``).

``test_result.pth["model"]`` holds the head leaves under uml_tpu's names
(``head_w``, and ``img_proj_w`` / ``img_scale`` / ``txt_scale`` where they
exist) and, on the full path, ``backbone``: the trained CLIP as an
OpenAI-schema state_dict (the port's own layout, which
uml_tpu/models/port_torch.py reads), or the trained DinoViT's state_dict,
where uml_tpu saves its flax tree.

    python -m uml_tpu_torch.cli.finetune -d --dataset caltech101 \\
        --clip-encoder ViT-B/16 --train-shot 16 --seed 1 \\
        --text_type hand_crafted --modality crossmodal --alpha 0.5 \\
        --hyperparams smoke_full ...
    python -m uml_tpu_torch.cli.finetune -d --dataset caltech101 \\
        --vision_model vit_base_patch14_dinov2.lvd142m \\
        --language_model bert-base-uncased --train-shot 16 --seed 1 \\
        --text_type hand_crafted --modality crossmodal --alpha 0.5 \\
        --hyperparams smoke_full --allow-random-init ...

The CLIP encoders are ViT-B/16, ViT-B/32 and RN50 / RN101 (the default
``--clip-encoder``); on the full path an RN tower trains with BatchNorm
in its train form (batch statistics normalize; the running statistics
follow at momentum 0.1 after each optimizer step), in the encoder's
dtype (bf16), with cuDNN convolutions.  ``--quant`` is accepted and
ignored, as uml_tpu's finetune ignores it (the int8 modes serve the
features CLI only).  ``--ckpt_every N`` saves the loop's state every N
iterations into ``<combo>/checkpoints``, and a rerun of the combo resumes
from the latest checkpoint (train/supervised.py).

``--mesh auto`` (the default) run from the command line with several
cards starts one process per card (core.meshes.launch_per_card) and
trains data-parallel (train/supervised.py: every rank draws the same
global batches and steps on its rows); the frozen path's features
are extracted round robin by loader batch and shared with every rank.
Rank 0 alone writes ``test_result.pth``, ``results.pth``, ``log.txt``,
the metrics and the checkpoints; the skip-if-exists check is rank 0's
answer on every rank.  With one card it is the one-process run.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

import numpy as np
import torch

from uml_tpu_torch.cli.features import _HFEncoderAdapter
from uml_tpu_torch.core.checkpoint import TrainCheckpointer
from uml_tpu_torch.core.flags import build_shared_parser
from uml_tpu_torch.core.distributed import is_primary
from uml_tpu_torch.core.meshes import agree, data_rank, data_size, mesh_from_flag
from uml_tpu_torch.core.prng import make_rng
from uml_tpu_torch.core.sweep import expand_sweep, run_sweep_cli
from uml_tpu_torch.data.feature_cache import load_cache, save_cache, text_outdir
from uml_tpu_torch.data.fewshot import (
    TextFeatureSet,
    get_few_shot_benchmark,
    get_few_shot_setup_name,
)
from uml_tpu_torch.data.loader import ImageBatchLoader, RawImageStream
from uml_tpu_torch.models.clip import clip_embed_dim
from uml_tpu_torch.models.dino import DINO_CONFIGS
from uml_tpu_torch.models.uml_head import (UMLHead, make_uml_clip_head,
                                           make_uml_dino_head)
from uml_tpu_torch.parallel.data_parallel import gather_in_order
from uml_tpu_torch.train.optim import HYPER_DICT, build_optimizer, build_schedule
from uml_tpu_torch.train.supervised import (
    EVAL_FREQ,
    CyclicBatcher,
    eval_batches,
    make_validate,
    train,
)
from uml_tpu_torch.utils.io import Tee, makedirs
from uml_tpu_torch.utils.logging import init_logger
from uml_tpu_torch.utils.seeding import set_random_seed

FULL_FINETUNE_GRIDS = ("full_ds_full_model_finetune", "smoke_full")


def build_parser() -> argparse.ArgumentParser:
    return build_shared_parser()


def hparam_str(optim, lr, wd, batch_size, iters, dropout, learnable_temp):
    """Parity with finetune.py:58-64."""
    base = f"optim_{optim}-lr_{lr}-wd_{wd}-bs_{batch_size}-iters_{iters}"
    if dropout is not None:
        base += f"-dropout_{dropout}"
    if learnable_temp is True:
        base += "-learnable_temp"
    return base


def savedir(outdir, dataset, encoder, train_shot, seed, text_type, text_shots,
            image_augmentation, mode, init_mode="zeroshot", alpha=0.0,
            text_bs=0, custom_name="", args=None):
    """Parity with finetune.py:67-77."""
    benchname = "-".join([dataset, get_few_shot_setup_name(train_shot, seed)])
    text_name = f"text_{text_type}"
    if text_shots is not None:
        text_name += f"_n_{text_shots}"
    image_name = f"image_{image_augmentation}_{custom_name}"
    mod_name = (f"finetune-{text_name}-{image_name}" if mode == "crossmodal"
                else f"finetune-{image_name}" if mode == "image" else text_name)
    mod_name = f"{mod_name}-alpha_{alpha}" if mode == "crossmodal" else mod_name
    mod_name = f"{mod_name}-text_bs_{text_bs}" if text_bs > 0 else mod_name
    mod_name = (f"{mod_name}-common_dim_{args.common_dim}"
                if args is not None and mode != "crossmodal" else mod_name)
    return os.path.join(outdir, benchname, encoder.replace("/", "-"),
                        mod_name, init_mode)


def _extract_split_features(encoder, items, augmentation, batch_size, seed,
                            mesh=None):
    """Frozen-backbone features of a split; with a ``mesh`` the ranks take
    the loader batches round robin and every rank gets them all."""
    shard = None if mesh is None else (data_rank(mesh), data_size(mesh))
    done = gather_in_order(mesh, [
        (encoder.encode_images(imgs), labs)
        for imgs, labs, _ in ImageBatchLoader(items, augmentation, batch_size,
                                              seed=seed, shard=shard)],
        to_all=True)
    return (np.concatenate([f for f, _ in done]),
            np.concatenate([lab for _, lab in done]))


def _decode_split(items, seed):
    """A split as flat uint8 images (the full path's validation input)."""
    imgs, labels = [], []
    for im, lab, _ in ImageBatchLoader(items, "crop", 64, seed=seed):
        imgs.append(im.reshape(im.shape[0], -1))
        labels.append(lab)
    return np.concatenate(imgs), np.concatenate(labels)


def freezes_backbone(args) -> bool:
    """Every grid but the full-finetune ones freezes the CLIP; with
    --strict_reference_parity only 'linear' does (finetune.py:338)."""
    if getattr(args, "strict_reference_parity", False):
        return args.hyperparams == "linear"
    return args.hyperparams not in FULL_FINETUNE_GRIDS


def setup(datasets, hparams, args):
    """One hparam combo -> test_result dict.  Parity with finetune.py:323-404."""
    ckpt_dir = os.path.join(
        args.savepath,
        hparam_str(hparams["optim"], hparams["lr"], hparams["weight_decay"],
                   hparams["batch_size"], hparams["max_iter"],
                   hparams["dropout"], hparams["learnable_temp"]))
    makedirs(ckpt_dir)
    mesh = getattr(args, "mesh_obj", None)
    primary = is_primary()
    test_path = os.path.join(ckpt_dir, "test_result.pth")
    if agree(mesh, os.path.exists(test_path) and not args.force_rerun):
        print(f"=> Skipping {ckpt_dir} as it already exists!")
        return agree(mesh, load_cache(test_path) if primary else None)
    print(f"=> Setting up {ckpt_dir}")

    logger = init_logger("unpaired_multimodal", config={**vars(args), **hparams},
                         tags=[args.dataset, args.modality, args.hyperparams],
                         logdir=ckpt_dir) if primary else None

    bs = hparams["batch_size"]
    encoder = datasets["encoder"]
    text_ds = datasets["text_ds"]
    gen = make_rng(args.seed)
    if not freezes_backbone(args):
        # full backbone finetuning: raw uint8 batches through a trainable
        # copy of the tower (each combo starts from the encoder's weights)
        if args.use_clip:
            model = make_uml_clip_head(
                copy.deepcopy(encoder.model), args.nclasses,
                logit_scale=args.logit, learnable_temp=hparams["learnable_temp"],
                freeze_backbone=False, generator=gen)
        else:
            # UML semantics with the DINO tower trainable
            # (uml_tpu/cli/finetune.py:147-154)
            proj_dim = (args.text_indim if args.modality == "crossmodal"
                        else args.common_dim)
            model = make_uml_dino_head(
                copy.deepcopy(encoder.model), args.nclasses, text_indim=proj_dim,
                learnable_temp=hparams["learnable_temp"], freeze_backbone=False,
                generator=gen)
        image_stream = RawImageStream(datasets["img_tr_ds"],
                                      args.image_augmentation, bs,
                                      seed=args.seed)
        img_val, lab_val = _decode_split(datasets["img_val_ds"], args.seed)
        img_te, lab_te = _decode_split(datasets["img_te_ds"], args.seed)
        capture = None
    else:
        if args.use_clip:
            # feature-space path, UMLClip semantics (head.py:101-141):
            # shared head in the CLIP embedding space, fixed exp(logit)
            # scale
            model = UMLHead(feat_dim=args.text_indim, num_classes=args.nclasses,
                            text_indim=0, logit_scale=args.logit,
                            learnable_temp=hparams["learnable_temp"],
                            generator=gen)
        else:
            # UML semantics (head.py:39-98): img_proj from the vision dim
            # into the text dim (crossmodal) or common_dim (unimodal)
            proj_dim = (args.text_indim if args.modality == "crossmodal"
                        else args.common_dim)
            model = UMLHead(feat_dim=args.img_indim, num_classes=args.nclasses,
                            text_indim=proj_dim,
                            learnable_temp=hparams["learnable_temp"],
                            generator=gen)
        # text-only runs never consume the train image stream; only the
        # capture diagnostics need a ~1000-image sample
        train_items = (datasets["img_tr_ds"][:1000]
                       if args.modality == "text" else datasets["img_tr_ds"])
        img_tr, lab_tr = _extract_split_features(
            encoder, train_items, args.image_augmentation, 128, args.seed, mesh)
        img_val, lab_val = _extract_split_features(
            encoder, datasets["img_val_ds"], "crop", 128, args.seed, mesh)
        img_te, lab_te = _extract_split_features(
            encoder, datasets["img_te_ds"], "crop", 128, args.seed, mesh)
        image_stream = CyclicBatcher(img_tr, lab_tr, bs, seed=args.seed)
        capture = {
            "image_feats": img_tr[:1000],
            "image_labels": lab_tr[:1000],
            "text_feats": text_ds.features[:1000].astype(np.float32),
        }
    model.to(encoder.device)

    if args.classifier_init == "zeroshot" and (
        args.modality == "crossmodal"
        or (args.modality == "image" and args.common_dim == args.text_indim)
    ):
        print("=> Initializing head with zero-shot weights")
        model.zero_shot_init(text_ds.features, text_ds.labels)

    schedule = build_schedule(hparams["lr"], hparams["lr_scheduler"],
                              hparams["warmup_iter"], hparams["max_iter"],
                              hparams["warmup_type"], hparams["warmup_min_lr"])
    optimizer = build_optimizer(hparams["optim"], schedule,
                                hparams["weight_decay"])

    text_stream = CyclicBatcher(text_ds.features.astype(np.float32),
                                text_ds.labels.astype(np.int64), bs,
                                seed=args.seed + 1)
    if args.modality == "image":
        text_stream = None
        print("=> Running Unimodal: Image Only Model")
    elif args.modality == "text":
        image_stream = None
        print("=> Running Unimodal: Text Only Model")

    val_batches = eval_batches(img_val, lab_val, bs)
    test_batches = eval_batches(img_te, lab_te, bs)

    # --ckpt_every: mid-run checkpoints in the combo's folder; a rerun of
    # the combo resumes from the latest (uml_tpu/cli/finetune.py:239-264)
    ckpt_every = getattr(args, "ckpt_every", 0) or None
    checkpointer = (TrainCheckpointer(os.path.join(ckpt_dir, "checkpoints"),
                                      mesh=mesh)
                    if ckpt_every else None)
    result = train(
        model, image_stream, text_stream, val_batches,
        test_batches if args.eval_test else None,
        optimizer=optimizer, max_iters=hparams["max_iter"], alpha=args.alpha,
        eval_freq=EVAL_FREQ, patience=hparams["patience"], capture=capture,
        logger=logger, checkpointer=checkpointer, ckpt_every=ckpt_every,
        mesh=mesh)
    validate = make_validate(model, mesh)
    test_loss, test_acc = validate(result["final_params"], test_batches)
    if hasattr(logger, "finish"):
        logger.log({"test/test_loss": test_loss, "test/test_acc": test_acc})
        logger.finish()

    test_dict = {
        "test_acc": test_acc,
        "val_acc": result["val_acc"],
        "model": result["model"],
        "iter": result["iter"],
    }
    print(f"=> Test Acc: {test_acc:.4f}")
    if primary:
        print(f"=> Saving Test Results for hparams to {test_path}")
        save_cache(test_dict, test_path)
    return test_dict


def sweep(datasets, hyperparams, args):
    """Parity with finetune.py:406-448."""
    hyperparams = {k: (v if isinstance(v, list) else [v])
                   for k, v in hyperparams.items()}
    combos = expand_sweep(hyperparams)
    results = {"test_acc": [], "val_acc": [], "hparams": []}
    for idx, combo in enumerate(combos):
        print(f"=> Running {idx + 1}/{len(combos)}: {combo}")
        out = setup(datasets, combo, args)
        results["test_acc"].append(out["test_acc"])
        results["val_acc"].append(out["val_acc"])
        results["hparams"].append(combo)
    if is_primary():
        print(f"=> Saving results across all hparams to {args.savepath}")
        save_cache(results, os.path.join(args.savepath, "results.pth"))

    best_idx = int(np.argmax(results["val_acc"]))
    best = (results["val_acc"][best_idx], results["test_acc"][best_idx],
            results["hparams"][best_idx])
    print(f"=> [FINAL] Best Val Acc: {best[0]:.4f} | Best Test Acc: {best[1]:.4f}")
    print(f"=> [FINAL] Best Hyperparameters: {best[2]}")
    return results, best[0], best[1]


def check_ported(args) -> None:
    """The early check of the flags, before any work.  Every flag is
    ported: nothing is refused.  ``--quant`` is accepted and ignored, as
    uml_tpu's finetune does (its help: "Extraction-only")."""


def main(args):
    """Run the sweep -> (results, best val acc, best test acc)."""
    from uml_tpu_torch.models.encoders import ClipEncoder

    check_ported(args)
    args.mesh_obj = mesh_from_flag(args.mesh)
    if args.mesh_obj is not None:
        print(f"=> Data-parallel training over {data_size(args.mesh_obj)} ranks")
    if args.seed >= 0:
        print(f"=> Setting fixed seed: {args.seed}")
        set_random_seed(args.seed)

    args.use_clip = args.vision_model == "" and args.language_model == ""
    encoder_name = (args.clip_encoder if args.use_clip
                    else f"{args.vision_model}-{args.language_model}")
    args.savepath = savedir(
        args.result_dir, args.dataset, encoder_name, args.train_shot,
        args.seed, args.text_type, args.text_shot, args.image_augmentation,
        args.modality, args.classifier_init, args.alpha,
        getattr(args, "text_batch_size", 0) or 0, args.custom_name, args)
    makedirs(args.savepath)

    logfile = (open(os.path.join(args.savepath, "log.txt"), "w")
               if is_primary() else None)
    if logfile is not None:
        sys.stdout = Tee(sys.__stdout__, logfile)
    try:
        print("=> Arguments:", args)
        text_encoder_name = (args.clip_encoder if args.use_clip
                             else args.language_model)
        text_path = text_outdir(args.feature_dir, text_encoder_name,
                                args.dataset, args.text_type)
        print(f"=> Loading text features from: {text_path}")
        tf = load_cache(text_path)
        n_shots = (int(args.text_shot)
                   if (args.text_shot not in (None, "average")) else args.text_shot)
        text_ds = TextFeatureSet(tf["features"], tf["labels"], tf["eot_indices"],
                                 n_shots=n_shots)

        datasets = get_few_shot_benchmark(args.data_dir, args.indices_dir,
                                          args.dataset, args.train_shot, args.seed)
        args.nclasses = len(datasets["lab2cname"])
        if args.use_clip:
            args.img_indim = args.text_indim = clip_embed_dim(args.clip_encoder)
            encoder = ClipEncoder(args.clip_encoder,
                                  allow_random_init=args.allow_random_init,
                                  check_finite=args.debug_nans)
        else:
            encoder = _HFEncoderAdapter(args.vision_model, "",
                                        allow_random_init=args.allow_random_init,
                                        check_finite=args.debug_nans)
            args.img_indim = DINO_CONFIGS[args.vision_model][0].num_features
            # the text width comes from the cached LM features themselves
            args.text_indim = int(tf["features"].shape[-1])
        print(f"=> Encoder on {encoder.device}")
        ds = {
            "img_tr_ds": datasets["train"],
            "img_val_ds": datasets["val"],
            "img_te_ds": datasets["test"],
            "text_ds": text_ds,
            "encoder": encoder,
        }
        results, best_val_acc, best_test_acc = sweep(
            ds, HYPER_DICT[args.hyperparams], args)
        print("Done!")
    finally:
        sys.stdout = sys.__stdout__
        if logfile is not None:
            logfile.close()
    return results, best_val_acc, best_test_acc


if __name__ == "__main__":
    run_sweep_cli(main, build_parser(), description="UML finetune",
                  default_config="finetune.yaml")
