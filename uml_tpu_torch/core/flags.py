"""Shared experiment flag parser.

Flag-compatible with the reference's single shared argparse config
(engine/config/__init__.py:6-260 + defaults.py): directories, dataset/shot/
seed, encoder choices, text/image augmentation enums, and training flags.
Every CLI entrypoint builds on this parser so reference command lines and
sweep YAMLs work unchanged.
"""

from __future__ import annotations

import argparse

from uml_tpu_torch.data.registry import dataset_classes

# Path defaults (engine/config/defaults.py:1-10)
DATA_DIR = "./data"
DESCRIPTION_DIR = "./descriptions"
FEW_SHOT_DIR = "./indices"
FEATURE_DIR = "./features"
RESULT_DIR = "./experiments"

CLIP_ENCODERS = ["ViT-B/16", "ViT-B/32", "RN50", "RN101"]
VISION_MODELS = [
    "vit_base_patch16_224_dino",
    "vit_base_patch8_224_dino",
    "vit_small_patch14_dinov2.lvd142m",
    "vit_base_patch14_dinov2.lvd142m",
    "vit_large_patch14_dinov2.lvd142m",
]
LANGUAGE_MODELS = [
    "bert-base-uncased",
    "bert-large-uncased",
    "roberta-base",
    "roberta-large",
    "openlm-research/open_llama_3b_v2",
    "meta-llama/Llama-2-7b-chat-hf",
    "gpt2",
    "gpt2-medium",
    "gpt2-large",
    "mistralai/Mistral-7B-v0.1",
    "bigscience/bloom-1b1",
]


def build_shared_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()

    # directories
    p.add_argument("--data_dir", type=str, default=DATA_DIR)
    p.add_argument("--indices_dir", type=str, default=FEW_SHOT_DIR)
    p.add_argument("--description_dir", type=str, default=DESCRIPTION_DIR)
    p.add_argument("--feature_dir", type=str, default=FEATURE_DIR)
    p.add_argument("--result_dir", type=str, default=RESULT_DIR)

    # dataset / shots / seed
    p.add_argument("--dataset", type=str, default="fgvc_aircraft",
                   choices=list(dataset_classes.keys()))
    p.add_argument("--train-shot", "--train_shot", type=int, default=1,
                   dest="train_shot")
    p.add_argument("--max-val-shot", "--max_val_shot", type=int, default=4,
                   dest="max_val_shot")
    p.add_argument("--seed", type=int, default=1)

    # encoders
    p.add_argument("--clip-encoder", "--clip_encoder", type=str,
                   default="RN50", choices=CLIP_ENCODERS, dest="clip_encoder")
    p.add_argument("--vision-model", "--vision_model", type=str, default="",
                   choices=[""] + VISION_MODELS, dest="vision_model")
    p.add_argument("--language-model", "--language_model", type=str,
                   default="", choices=[""] + LANGUAGE_MODELS,
                   dest="language_model")

    # text/descriptor/image augmentation
    p.add_argument("--descriptor_type", type=str, default=None,
                   choices=["gpt3_cupl"])
    p.add_argument("--text-augmentation", "--text_augmentation", type=str,
                   default="vanilla",
                   choices=["hand_crafted", "classname", "vanilla",
                            "template_mining"],
                   dest="text_augmentation")
    p.add_argument("--image-augmentation", "--image_augmentation", type=str,
                   default="crop",
                   choices=["crop", "flip", "randomcrop"],
                   dest="image_augmentation")
    p.add_argument("--batch-size", "--batch_size", type=int, default=32,
                   dest="batch_size")
    p.add_argument("--num-workers", "--num_workers", type=int, default=4,
                   dest="num_workers")

    # training flags (finetune)
    p.add_argument("--text_shot", default=None)
    p.add_argument("--custom-name", "--custom_name", default="",
                   dest="custom_name")
    p.add_argument("--modality", type=str, default="image",
                   choices=["crossmodal", "image", "text"])
    p.add_argument("--classifier_init", type=str, default="zeroshot",
                   choices=["zeroshot", "random"])
    p.add_argument("--text_type", type=str, default="hand_crafted",
                   choices=["gpt3_dclip", "gpt3_cupl", "hand_crafted",
                            "classname", "vanilla", "template_mining"])
    p.add_argument("--logit", type=float, default=4.60517)
    p.add_argument("--hyperparams", type=str, default="linear")
    p.add_argument("--eval_test", "--eval-test", action="store_true",
                   default=False)
    p.add_argument("--alpha", type=float, default=0.0)
    p.add_argument("--flip_projection", type=bool, default=False)
    p.add_argument("--common_dim", type=int, default=0)

    # extras beyond the reference parser, flag-compatible with uml_tpu's
    # parser so one command line drives either package
    p.add_argument("--return_tokens", action="store_true", default=False,
                   help="cache token-level features (reference injects this "
                        "via YAML only; YAML booleans also land here)")
    p.add_argument("--allow-random-init", action="store_true",
                   dest="allow_random_init",
                   help="run encoders from random init when no pretrained "
                        "weights are available (testing only)")
    p.add_argument("--quant", type=str, default="none",
                   choices=["none", "int8", "int8_mlp", "int8_attn",
                            "int8_qkv"],
                   help="int8 (W8A8) serving modes of the CLIP towers "
                        "(features CLI)")
    p.add_argument("--ckpt_every", type=int, default=0,
                   help="mid-run checkpoint interval in iterations (0 = off)")
    p.add_argument("--strict_reference_parity", action="store_true",
                   default=False,
                   help="reproduce reference quirks bit-for-bit where this "
                        "build deliberately deviates")
    p.add_argument("--mesh", type=str, default="auto",
                   choices=["auto", "off"],
                   help="'auto' with one visible device, or 'off': "
                        "single-device run; a multi-device mesh is not "
                        "ported yet and raises")
    p.add_argument("--debug_nans", action="store_true", default=False,
                   help="raise as soon as an encoder batch produces a "
                        "non-finite feature")
    return p
