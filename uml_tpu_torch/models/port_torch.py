"""Read OpenAI CLIP checkpoints into the port's CLIP module.

The counterpart of uml_tpu/models/port_torch.py.  The port's module uses
the OpenAI state_dict schema itself, so a checkpoint loads without any
layout conversion; what this module keeps is the architecture inference
from checkpoint shapes (port_torch.py:100-123) and the ``.pt`` reading
(a TorchScript archive or a plain state_dict).  fp16 storage is upcast
to the module's fp32 parameters by ``load_state_dict``.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.models.clip import CLIP, ClipConfig

_NON_PARAM_KEYS = ("input_resolution", "context_length", "vocab_size")


def is_vit_checkpoint(sd) -> bool:
    return "visual.proj" in sd


def config_from_state_dict(sd) -> ClipConfig:
    """Infer the ViT architecture from checkpoint shapes (model.py:405-428)."""
    if not is_vit_checkpoint(sd):
        raise ValueError("not a ViT CLIP checkpoint (no visual.proj); the "
                         "RN50/RN101 towers are not ported yet")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len([
        k for k in sd
        if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")
    ])
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipConfig(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=vision_patch_size * grid,
        vision_layers=vision_layers,
        vision_width=vision_width,
        vision_patch_size=vision_patch_size,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({
            k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")
        }),
    )


def read_state_dict(path: str) -> dict:
    """A CLIP ``.pt``/``.pth`` (TorchScript archive, module or state_dict)
    -> {key: tensor} without the non-parameter entries."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):  # jit archive or module
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if k not in _NON_PARAM_KEYS}


def load_clip_checkpoint(path: str, dtype=torch.float32,
                         quant: str = "none") -> CLIP:
    """Read a CLIP checkpoint -> CLIP (fp32 parameters on the CPU) whose
    forward runs in ``dtype`` and the serving mode ``quant``."""
    sd = read_state_dict(path)
    model = CLIP(config_from_state_dict(sd), dtype=dtype, quant=quant)
    model.load_state_dict(sd)
    return model
