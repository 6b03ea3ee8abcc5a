"""OpenAI CLIP with a ViT image tower: the UMLClip head of the finetune
CLI's full path (``make_uml_clip_head`` with ``freeze_backbone=False``:
the whole CLIP trains, its text tower and ``logit_scale`` included)."""

from __future__ import annotations

import math

import torch

from port_bench import flops
from port_bench.families.common import draw, layer_norm, linear, vit_counters
from port_bench.reference import clip_vit as plain

counters = vit_counters
reference_features = plain.features

TOWER_PREFIX = "backbone.visual."


def _block(prefix: str, width: int, mlp: int):
    return (layer_norm(prefix + "ln_1.", width)
            + linear(prefix + "attn.", width, 3 * width, "in_proj_weight", "in_proj_bias")
            + linear(prefix + "attn.out_proj.", width, width)
            + layer_norm(prefix + "ln_2.", width)
            + linear(prefix + "mlp.c_fc.", width, mlp)
            + linear(prefix + "mlp.c_proj.", mlp, width))


def schema(cfg):
    """[(key, shape, mean, std)] of the OpenAI state dict."""
    w, p, r = cfg["vision_width"], cfg["vision_patch_size"], cfg["image_resolution"]
    tw = cfg["transformer_width"]
    out = [("visual.conv1.weight", (w, 3, p, p), 0.0, (3 * p * p) ** -0.5),
           ("visual.class_embedding", (w,), 0.0, w ** -0.5),
           ("visual.positional_embedding", ((r // p) ** 2 + 1, w), 0.0, w ** -0.5)]
    out += layer_norm("visual.ln_pre.", w)
    for i in range(cfg["vision_layers"]):
        out += _block(f"visual.transformer.resblocks.{i}.", w, cfg["mlp_width"])
    out += layer_norm("visual.ln_post.", w)
    out += [("visual.proj", (w, cfg["embed_dim"]), 0.0, w ** -0.5),
            ("token_embedding.weight", (cfg["vocab_size"], tw), 0.0, 0.02),
            ("positional_embedding", (cfg["context_length"], tw), 0.0, 0.01)]
    for i in range(cfg["transformer_layers"]):
        out += _block(f"transformer.resblocks.{i}.", tw, 4 * tw)
    out += layer_norm("ln_final.", tw)
    out += [("text_projection", (tw, cfg["embed_dim"]), 0.0, tw ** -0.5),
            ("logit_scale", (), math.log(1 / 0.07), 0.0)]
    return out


def shape(cfg) -> dict:
    """The tower's sizes, as port_bench/flops.py takes them."""
    d, p, r = cfg["vision_width"], cfg["vision_patch_size"], cfg["image_resolution"]
    return {"d": d, "m": cfg["mlp_width"], "layers": cfg["vision_layers"], "p": p,
            "r": r, "s": (r // p) ** 2 + 1, "out": cfg["embed_dim"]}


def resolution(cfg) -> int:
    return cfg["image_resolution"]


def feature_width(cfg) -> int:
    return cfg["embed_dim"]


def forward_ops(cfg, batch: int) -> list:
    return flops.tower_forward(shape(cfg), batch)


def state_dict(cfg, seed: int, device) -> dict:
    return draw(schema(cfg), seed, device)


def image_tower_keys(sd) -> dict:
    """The leaves the image features read (the reference's)."""
    return {k: v for k, v in sd.items() if k.startswith("visual.")}


def build_backbone(cfg, sd, device):
    """The program's CLIP on ``device`` (float32 parameters, the forward
    in bfloat16), filled by its ``load_state_dict``."""
    from uml_tpu_torch.models.clip import CLIP, ClipConfig

    if cfg["vision_heads"] != cfg["vision_width"] // 64:
        raise ValueError("the program's CLIP takes heads of 64")
    conf = ClipConfig(embed_dim=cfg["embed_dim"], image_resolution=cfg["image_resolution"],
                      vision_layers=cfg["vision_layers"], vision_width=cfg["vision_width"],
                      vision_patch_size=cfg["vision_patch_size"],
                      context_length=cfg["context_length"], vocab_size=cfg["vocab_size"],
                      transformer_width=cfg["transformer_width"],
                      transformer_heads=cfg["transformer_heads"],
                      transformer_layers=cfg["transformer_layers"])
    with torch.device(device):
        model = CLIP(conf, dtype=getattr(torch, cfg["compute_dtype"]))
    model.load_state_dict(sd)
    return model


def head_extra(cfg, seed: int, device) -> dict:
    """Head leaves the benchmark draws itself: none for UMLClip."""
    return {}


def build_head(cfg, backbone, classes: int, seed: int, extra: dict):
    """``make_uml_clip_head`` as cli/finetune.py calls it on the full path."""
    from uml_tpu_torch.core.prng import make_rng
    from uml_tpu_torch.models.uml_head import make_uml_clip_head

    return make_uml_clip_head(backbone, classes, logit_scale=cfg["assumed"]["logit"],
                              learnable_temp=False, freeze_backbone=False,
                              generator=make_rng(seed))


def head_scale(cfg) -> float:
    return float(torch.exp(torch.tensor(cfg["assumed"]["logit"], dtype=torch.float32)))


def text_width(cfg) -> int:
    return cfg["assumed"]["text_feature_width"]


def units(program_leaves) -> tuple[dict, dict]:
    """(program units, reference units) as reference.uml.unit_norms
    takes them: the OpenAI names (under ``backbone.`` in the program),
    the packed in_proj weight and bias as their query, key and value
    rows."""
    prog, ref = {}, {}
    for k in program_leaves:
        name = k[len("backbone."):] if k.startswith("backbone.") else k
        if name.endswith(("in_proj_weight", "in_proj_bias")):
            ref[name] = [(f"{name}[{q}]", i, 3) for i, q in enumerate("qkv")]
        else:
            ref[name] = [(name, 0, 1)]
        prog[k] = ref[name]
    return prog, ref
