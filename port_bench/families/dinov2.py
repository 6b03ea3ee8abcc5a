"""DINOv2 (HF Dinov2Model schema): the UML head of the finetune CLI's
full path with ``--vision_model`` (``make_uml_dino_head`` with
``img_proj_w`` into the language model's feature width and
``freeze_backbone=False``)."""

from __future__ import annotations

import torch

from port_bench import flops
from port_bench.families.common import draw, layer_norm, linear, vit_counters
from port_bench.reference import dinov2 as plain

counters = vit_counters
reference_features = plain.features

TOWER_PREFIX = "backbone."

_PACKED = ("query", "key", "value")


def schema(cfg):
    d, p, r = cfg["hidden_size"], cfg["patch_size"], cfg["image_size"]
    m = cfg["mlp_ratio"] * d
    out = [("embeddings.cls_token", (1, 1, d), 0.0, 0.02),
           ("embeddings.position_embeddings", (1, (r // p) ** 2 + 1, d), 0.0, 0.02),
           ("embeddings.patch_embeddings.projection.weight", (d, 3, p, p), 0.0,
            (3 * p * p) ** -0.5),
           ("embeddings.patch_embeddings.projection.bias", (d,), 0.0, 0.02)]
    for i in range(cfg["num_hidden_layers"]):
        k = f"encoder.layer.{i}."
        out += layer_norm(k + "norm1.", d)
        for n in _PACKED:
            out += linear(f"{k}attention.attention.{n}.", d, d)
        out += linear(k + "attention.output.dense.", d, d)
        out += [(k + "layer_scale1.lambda1", (d,), 0.1, 0.02)]
        out += layer_norm(k + "norm2.", d)
        out += linear(k + "mlp.fc1.", d, m) + linear(k + "mlp.fc2.", m, d)
        out += [(k + "layer_scale2.lambda1", (d,), 0.1, 0.02)]
    out += layer_norm("layernorm.", d)
    return out


def shape(cfg) -> dict:
    """The tower's sizes, as port_bench/flops.py takes them (no
    projection: the features are the CLS row)."""
    d, p, r = cfg["hidden_size"], cfg["patch_size"], cfg["image_size"]
    return {"d": d, "m": cfg["mlp_ratio"] * d, "layers": cfg["num_hidden_layers"],
            "p": p, "r": r, "s": (r // p) ** 2 + 1, "out": None}


def resolution(cfg) -> int:
    return cfg["image_size"]


def feature_width(cfg) -> int:
    return cfg["hidden_size"]


def forward_ops(cfg, batch: int) -> list:
    return flops.tower_forward(shape(cfg), batch)


def state_dict(cfg, seed: int, device) -> dict:
    return draw(schema(cfg), seed, device)


def image_tower_keys(sd) -> dict:
    return sd


def _port_config(cfg):
    from uml_tpu_torch.models.dino import DinoConfig

    return DinoConfig(hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
                      num_heads=cfg["num_attention_heads"], patch_size=cfg["patch_size"],
                      image_size=cfg["image_size"], mlp_ratio=cfg["mlp_ratio"],
                      layerscale=True, ln_eps=cfg["layer_norm_eps"],
                      pretrain_image_size=cfg["image_size"])


def build_backbone(cfg, sd, device):
    """The program's DinoViT on ``device``, filled through
    ``port_dinov2_state_dict`` (its reader of HF Dinov2Model weights)."""
    from uml_tpu_torch.models.dino import DinoViT, port_dinov2_state_dict

    conf = _port_config(cfg)
    with torch.device(device):
        model = DinoViT(conf, dtype=getattr(torch, cfg["compute_dtype"]))
    model.load_state_dict(port_dinov2_state_dict(sd, conf))
    return model


def head_extra(cfg, seed: int, device) -> dict:
    """``img_proj_w`` [hidden, text width], uniform +-1/sqrt(hidden) as the
    head initialises it, drawn from the seed on the device."""
    d, t = cfg["hidden_size"], text_width(cfg)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    w = (torch.rand((d, t), generator=gen, device=device) * 2 - 1) * d ** -0.5
    return {"img_proj_w": w}


def build_head(cfg, backbone, classes: int, seed: int, extra: dict):
    """``make_uml_dino_head`` as cli/finetune.py calls it on the full path
    (crossmodal: ``text_indim`` is the text features' width), with the
    benchmark's ``img_proj_w`` loaded through ``load_state_tree``."""
    from uml_tpu_torch.core.prng import make_rng
    from uml_tpu_torch.models.uml_head import make_uml_dino_head

    head = make_uml_dino_head(backbone, classes, text_indim=text_width(cfg),
                              learnable_temp=False, freeze_backbone=False,
                              generator=make_rng(seed))
    head.load_state_tree({"img_proj_w": extra["img_proj_w"]})
    return head


def head_scale(cfg) -> float:
    return 1.0


def text_width(cfg) -> int:
    return cfg["assumed"]["text_feature_width"]


_RENAMES = {
    "norm1": "norm1", "norm2": "norm2", "attn_out": "attention.output.dense",
    "fc1": "mlp.fc1", "fc2": "mlp.fc2",
}


def units(program_leaves) -> tuple[dict, dict]:
    """(program units, reference units): the HF leaves, the program's
    packed qkv as the query, key and value leaves' rows."""
    top = {"backbone.cls_token": "embeddings.cls_token",
           "backbone.position_embeddings": "embeddings.position_embeddings",
           "backbone.patch_embed.weight": "embeddings.patch_embeddings.projection.weight",
           "backbone.patch_embed.bias": "embeddings.patch_embeddings.projection.bias",
           "backbone.norm.weight": "layernorm.weight",
           "backbone.norm.bias": "layernorm.bias"}
    prog = {}
    for k in program_leaves:
        if k in top:
            prog[k] = [(top[k], 0, 1)]
        elif k.startswith("backbone.blocks."):
            _, _, i, name, *rest = k.split(".")
            hf = f"encoder.layer.{i}."
            if name == "qkv":
                prog[k] = [(f"{hf}attention.attention.{n}.{rest[0]}", j, 3)
                           for j, n in enumerate(_PACKED)]
            elif name.startswith("layerscale"):
                prog[k] = [(f"{hf}layer_scale{name[-1]}.lambda1", 0, 1)]
            else:
                prog[k] = [(f"{hf}{_RENAMES[name]}.{rest[0]}", 0, 1)]
        else:
            prog[k] = [(k, 0, 1)]
    return prog, {}
