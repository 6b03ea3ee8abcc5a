"""Feature-extraction CLI (CLIP encoders).

The port of uml_tpu/cli/features.py (flag/behavior parity with the
reference's vision_language/features.py): extracts and caches frozen-CLIP
features — train/val/test image features, per-class template text
features, CUPL descriptor features — into the reference's ``.pth`` path
scheme and schema (features.py:32-44, 96-103, 143-149, 180-184), with
idempotent skip-unless-overwrite semantics.

Pipeline: threaded PIL decode -> uint8 batch -> pinned host->device copy
-> CLIP forward (bf16, hand-written kernels on the card) -> device->host
copy, one batch in flight while the loader decodes ahead.

    python -m uml_tpu_torch.cli.features -d --dataset caltech101 \\
        --clip-encoder ViT-B/16 --allow-random-init ...
    python -m uml_tpu_torch.cli.features -c configs/features.yaml

Not ported yet (each raises): the DINO / HF language-model encoders
(``--vision_model`` / ``--language_model``), ``--quant`` int8 modes, and a
multi-device ``--mesh``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from uml_tpu_torch.core.device import check_mesh_flag
from uml_tpu_torch.core.flags import build_shared_parser
from uml_tpu_torch.core.sweep import run_sweep_cli
from uml_tpu_torch.data.descriptors import (
    DESCRIPTOR_DICT,
    descriptor_path as default_descriptor_path,
    load_gpt_descriptions,
)
from uml_tpu_torch.data.feature_cache import (
    descriptor_outdir,
    img_outdir,
    save_cache,
    text_outdir,
)
from uml_tpu_torch.data.fewshot import get_few_shot_benchmark, get_testset
from uml_tpu_torch.data.loader import ImageBatchLoader
from uml_tpu_torch.data.templates import get_templates
from uml_tpu_torch.utils.io import makedirs
from uml_tpu_torch.utils.seeding import cname2lab, set_random_seed

IMAGENET_TESTSETS = ["imagenetv2", "imagenet_sketch", "imagenet_a", "imagenet_r"]


def build_parser() -> argparse.ArgumentParser:
    return build_shared_parser()


# ---------------------------------------------------------------------------
# extraction passes
# ---------------------------------------------------------------------------


def image_features(encoder, items, augmentation, batch_size, num_workers,
                   return_tokens=False, seed=0):
    """{'features','labels','paths','decoder'} over a split
    (features.py:152-184)."""
    loader = ImageBatchLoader(items, augmentation, batch_size,
                              num_workers=num_workers, seed=seed)
    feats, labels, paths = [], [], []
    for i, (imgs, labs, pths) in enumerate(loader):
        out = encoder.encode_images(imgs, return_tokens=return_tokens)
        if return_tokens and i == 0:
            print("Shape of image patch embeddings:", out.shape)
        feats.append(out)
        labels.append(labs)
        paths.extend(pths)
        if (i + 1) % 20 == 0:
            print(f"   ... {i + 1}/{len(loader)} batches")
    return {
        "features": np.concatenate(feats, axis=0),
        "labels": np.concatenate(labels, axis=0),
        "paths": paths,
        # provenance, as uml_tpu records it (its native decoder differs
        # pixel-wise from PIL); the port decodes with PIL only
        "decoder": "pil",
    }


def text_features(encoder, dsname, lab2cname, augmentation,
                  return_tokens=False):
    """Per-class template prompt features (features.py:107-149)."""
    templates = get_templates(dsname, augmentation)
    feats, labels, eots, prompts_dict = [], [], [], {}
    for label, cname in lab2cname.items():
        text_prompts = [t.format(cname.replace("_", " ")) for t in templates]
        out, indices = encoder.encode_texts(text_prompts,
                                            return_tokens=return_tokens)
        feats.append(out)
        labels.append(np.full(len(templates), label, dtype=np.int64))
        eots.append(indices)
        prompts_dict[label] = text_prompts
    return {
        "features": np.concatenate(feats, axis=0),
        "labels": np.concatenate(labels, axis=0),
        "eot_indices": np.concatenate(eots, axis=0),
        "prompts": prompts_dict,
        "lab2cname": lab2cname,
    }


def descriptor_features(encoder, descriptors, lab2cname, return_tokens=False):
    """Per-class CUPL descriptor features (features.py:54-103)."""
    cname2lab_dict = cname2lab(lab2cname)
    feats, labels, eots, prompts_dict = [], [], [], {}
    for cls, descriptions in descriptors.items():
        key = cls.replace(" ", "_").lower()
        if key not in cname2lab_dict:
            print(f"[!!!] Class not found in lab2cname dict corresponding to {cls}")
            continue
        label = cname2lab_dict[key]
        out, indices = encoder.encode_texts(descriptions,
                                            return_tokens=return_tokens)
        feats.append(out)
        labels.append(np.full(len(descriptions), label, dtype=np.int64))
        eots.append(indices)
        prompts_dict[label] = descriptions
    if not feats:
        raise ValueError(
            "No descriptor class matched the dataset's classnames — the "
            "descriptor JSON and the benchmark's lab2cname are disjoint "
            "(wrong dataset, or a custom/synthetic class list)."
        )
    return {
        "features": np.concatenate(feats, axis=0),
        "labels": np.concatenate(labels, axis=0),
        "eot_indices": np.concatenate(eots, axis=0),
        "prompts": prompts_dict,
        "lab2cname": lab2cname,
        "cname2lab": cname2lab_dict,
    }


# ---------------------------------------------------------------------------
# prepare_* (idempotent cache writers)
# ---------------------------------------------------------------------------


def _should_write(path: str, overwrite: bool, what: str) -> bool:
    if overwrite or not os.path.exists(path):
        reason = "overwrite is set to True" if overwrite else "it does not exist"
        print(f"=> Saving {what} to {path} because {reason}")
        return True
    print(f"=> {what} already saved at {path} and overwrite is set to False")
    return False


def prepare_image_features(encoder, args, ds, mode="train"):
    path = img_outdir(args.feature_dir, args.clip_encoder, args.dataset,
                      args.image_augmentation, args.train_shot, args.seed,
                      mode, args.return_tokens)
    makedirs(os.path.dirname(path))
    if not _should_write(path, args.overwrite, "image features"):
        return
    if mode == "train":
        features = {
            split: image_features(encoder, ds[split], args.image_augmentation,
                                  args.batch_size, args.num_workers,
                                  args.return_tokens, args.seed)
            for split in ("train", "val")
        }
    else:
        features = image_features(encoder, ds["test"], "crop",
                                  args.batch_size, args.num_workers,
                                  args.return_tokens, args.seed)
    features["lab2cname"] = ds.get("lab2cname")
    save_cache(features, path)


def prepare_text_features(encoder, args, ds):
    if args.descriptor_type is not None:
        dpath = descriptor_outdir(args.feature_dir, args.clip_encoder,
                                  args.dataset, args.descriptor_type,
                                  args.return_tokens)
        if _should_write(dpath, args.overwrite, "descriptor features"):
            hparams = dict(DESCRIPTOR_DICT[args.descriptor_type])
            fname = os.path.join(args.description_dir, hparams["dirname"],
                                 f"descriptors_{args.dataset}.json")
            if not os.path.exists(fname):
                # fall back to the vendored asset descriptors
                fname = default_descriptor_path(args.descriptor_type, args.dataset)
            hparams["fname"] = fname
            hparams["dsname"] = args.dataset
            descriptions, _ = load_gpt_descriptions(hparams)
            features = descriptor_features(encoder, descriptions,
                                           ds["lab2cname"], args.return_tokens)
            save_cache(features, dpath)

    path = text_outdir(args.feature_dir, args.clip_encoder, args.dataset,
                       args.text_augmentation, args.return_tokens)
    makedirs(os.path.dirname(path))
    if _should_write(path, args.overwrite, "text features"):
        features = text_features(encoder, args.dataset, ds["lab2cname"],
                                 args.text_augmentation, args.return_tokens)
        save_cache(features, path)


def check_ported(args) -> None:
    """Raise for flags whose code is not ported yet, before any dataset
    or model work."""
    if args.vision_model or args.language_model:
        raise SystemExit(
            "--vision_model/--language_model: the DINO and HF language-model "
            "encoders are not ported to uml_tpu_torch yet; use the CLIP "
            "encoders (--clip-encoder)")
    if args.quant != "none":
        raise SystemExit(f"--quant {args.quant}: the int8 serving modes are "
                         "not ported to uml_tpu_torch yet")
    if args.clip_encoder not in ("ViT-B/16", "ViT-B/32"):
        raise SystemExit(f"--clip-encoder {args.clip_encoder}: the RN towers "
                         "are not ported to uml_tpu_torch yet")
    check_mesh_flag(args.mesh)


def main(args):
    """Run the extraction; returns the ClipEncoder it used."""
    from uml_tpu_torch.models.encoders import ClipEncoder

    check_ported(args)
    if args.seed >= 0:
        print(f"Setting fixed seed: {args.seed}")
        set_random_seed(args.seed)

    if args.dataset not in IMAGENET_TESTSETS:
        datasets = get_few_shot_benchmark(args.data_dir, args.indices_dir,
                                          args.dataset, args.train_shot, args.seed)
        print(f"=> Dataset sizes: train: {len(datasets['train'])}, "
              f"val: {len(datasets['val'])}, test: {len(datasets['test'])}")
    else:
        datasets = get_testset(args.dataset, args.data_dir)

    print("=> Using CLIP model")
    encoder = ClipEncoder(args.clip_encoder,
                          allow_random_init=args.allow_random_init,
                          check_finite=args.debug_nans)
    print(f"=> Encoder on {encoder.device}")

    if args.dataset not in IMAGENET_TESTSETS:
        prepare_image_features(encoder, args, datasets, mode="train")
        prepare_image_features(encoder, args, datasets, mode="test")
        prepare_text_features(encoder, args, datasets)
    else:
        print(f"=> Saving ImageNet testset: {args.dataset}, "
              "only preparing image features")
        prepare_image_features(encoder, args, {"test": datasets}, mode="test")
    print("Done!")
    return encoder


if __name__ == "__main__":
    run_sweep_cli(main, build_parser(), description="Feature Extraction",
                  default_config="features.yaml")
