"""Read OpenAI CLIP checkpoints into the port's CLIP module.

The counterpart of uml_tpu/models/port_torch.py.  The port's modules use
the OpenAI state_dict schema themselves, so a checkpoint loads without any
layout conversion; what this module keeps is the architecture inference
from checkpoint shapes (port_torch.py:81-123: a ViT or an RN tower, told
apart by ``visual.proj``) and the ``.pt`` reading (a TorchScript archive
or a plain state_dict).  fp16 storage is upcast to the module's fp32
parameters by ``load_state_dict``; BatchNorm's ``num_batches_tracked``
counters are dropped (inference reads the running statistics only).
"""

from __future__ import annotations

import torch

from uml_tpu_torch.models.clip import CLIP, ClipConfig, ClipResNetModel
from uml_tpu_torch.models.clip_resnet import ClipResNetConfig

_NON_PARAM_KEYS = ("input_resolution", "context_length", "vocab_size")


def is_vit_checkpoint(sd) -> bool:
    return "visual.proj" in sd


def _text_config(sd) -> dict:
    return dict(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=sd["token_embedding.weight"].shape[0],
        transformer_width=sd["ln_final.weight"].shape[0],
        transformer_heads=sd["ln_final.weight"].shape[0] // 64,
        transformer_layers=len({
            k.split(".")[2] for k in sd if k.startswith("transformer.resblocks")
        }),
    )


def resnet_config_from_state_dict(sd) -> ClipResNetConfig:
    """Infer an RN tower from checkpoint shapes (model.py:414-421)."""
    counts = tuple(
        len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{b}.")})
        for b in (1, 2, 3, 4))
    grid = round((sd["visual.attnpool.positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipResNetConfig(layers=counts,
                            output_dim=sd["text_projection"].shape[1],
                            width=sd["visual.layer1.0.conv1.weight"].shape[0],
                            image_resolution=grid * 32)


def resnet_text_config_from_state_dict(sd, rn: ClipResNetConfig) -> ClipConfig:
    """The text tower of an RN checkpoint (port_torch.py:136-148)."""
    return ClipConfig(image_resolution=rn.image_resolution, vision_layers=0,
                      vision_width=rn.width, vision_patch_size=0,
                      **_text_config(sd))


def config_from_state_dict(sd) -> ClipConfig:
    """Infer the ViT architecture from checkpoint shapes (model.py:405-428)."""
    if not is_vit_checkpoint(sd):
        raise ValueError("not a ViT CLIP checkpoint (no visual.proj): read "
                         "an RN one with resnet_config_from_state_dict")
    vision_width = sd["visual.conv1.weight"].shape[0]
    vision_layers = len([
        k for k in sd
        if k.startswith("visual.") and k.endswith(".attn.in_proj_weight")
    ])
    vision_patch_size = sd["visual.conv1.weight"].shape[-1]
    grid = round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5)
    return ClipConfig(image_resolution=vision_patch_size * grid,
                      vision_layers=vision_layers, vision_width=vision_width,
                      vision_patch_size=vision_patch_size, **_text_config(sd))


def read_state_dict(path: str) -> dict:
    """A CLIP ``.pt``/``.pth`` (TorchScript archive, module or state_dict)
    -> {key: tensor} without the non-parameter entries."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):  # jit archive or module
        obj = obj.state_dict()
    return {k: v for k, v in obj.items() if k not in _NON_PARAM_KEYS
            and not k.endswith(".num_batches_tracked")}


def load_clip_checkpoint(path: str, dtype=torch.float32,
                         quant: str = "none") -> CLIP:
    """Read a CLIP checkpoint -> CLIP or ClipResNetModel (fp32 parameters
    on the CPU) whose forward runs in ``dtype``; a ViT serves in the mode
    ``quant``, an RN model ignores it."""
    sd = read_state_dict(path)
    if is_vit_checkpoint(sd):
        model = CLIP(config_from_state_dict(sd), dtype=dtype, quant=quant)
    else:
        rn = resnet_config_from_state_dict(sd)
        model = ClipResNetModel(rn, resnet_text_config_from_state_dict(sd, rn),
                                dtype=dtype)
    model.load_state_dict(sd)
    return model
