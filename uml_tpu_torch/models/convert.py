"""flax CLIP and DINO variables -> the port's state_dicts; UML head trees.

``state_dict_from_jax`` is the exact inverse of
uml_tpu.models.port_torch.port_clip_state_dict (and, for an RN model, of
port_clip_resnet_checkpoint): it takes the flax variable tree of
uml_tpu.models.clip.CLIP or ClipResNetModel as numpy arrays and returns
the state_dict the port's model (and an OpenAI ``.pt``) uses, so the
tests can give both packages the same weights.  ``dino_state_dict_from_jax`` does
the same for uml_tpu.models.dino.DinoViT and the port's DinoViT,
``uml_head_params_from_jax`` for the trainable tree of a uml_tpu UMLHead,
``llama_state_dict_from_jax`` for uml_tpu's LlamaEncoder (float or
int8_w) and the port's.  ``seq_uml_state_dict_from_jax`` and its inverse
``seq_uml_state_dict_to_jax`` carry uml_tpu's SeqUML tree (MultiBench)
both ways: the inverse is what the multibench CLI writes to model.pth, so
either package's model.pth loads into the other.  Pure numpy + torch: no
jax import.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(np.asarray(a, np.float32)))


def _ln(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _t(tree["ln"]["scale"])
    sd[f"{prefix}.bias"] = _t(tree["ln"]["bias"])


def _linear(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)   # [in,out] -> [out,in]
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _transformer(sd, prefix, tree):
    n = len([k for k in tree if k.startswith("resblocks_")])
    for i in range(n):
        blk, p = tree[f"resblocks_{i}"], f"{prefix}.resblocks.{i}"
        _ln(sd, f"{p}.ln_1", blk["ln_1"])
        _ln(sd, f"{p}.ln_2", blk["ln_2"])
        sd[f"{p}.attn.in_proj_weight"] = _t(np.asarray(blk["qkv"]["kernel"]).T)
        sd[f"{p}.attn.in_proj_bias"] = _t(blk["qkv"]["bias"])
        _linear(sd, f"{p}.attn.out_proj", blk["out_proj"])
        _linear(sd, f"{p}.mlp.c_fc", blk["c_fc"])
        _linear(sd, f"{p}.mlp.c_proj", blk["c_proj"])


def _conv(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))   # HWIO -> OIHW


def _bn(sd, prefix, tree):
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])
    sd[f"{prefix}.running_mean"] = _t(tree["mean"])
    sd[f"{prefix}.running_var"] = _t(tree["var"])


def resnet_state_dict_from_jax(visual, prefix: str = "visual.") -> dict:
    """The params of uml_tpu's ModifiedResNet (numpy leaves) -> the port's
    OpenAI-schema keys under ``prefix``: the inverse of
    uml_tpu.models.clip_resnet.port_clip_resnet_state_dict (conv kernels
    HWIO -> OIHW, Dense kernels transposed)."""
    sd, p = {}, prefix
    for i in (1, 2, 3):
        _conv(sd, f"{p}conv{i}", visual[f"conv{i}"])
        _bn(sd, f"{p}bn{i}", visual[f"bn{i}"])
    for name in sorted(k for k in visual if k.startswith("layer")):
        stage, blk = name[len("layer"):].split("_")
        tree, tp = visual[name], f"{p}layer{stage}.{blk}"
        for i in (1, 2, 3):
            _conv(sd, f"{tp}.conv{i}", tree[f"conv{i}"])
            _bn(sd, f"{tp}.bn{i}", tree[f"bn{i}"])
        if "downsample_conv" in tree:
            _conv(sd, f"{tp}.downsample.0", tree["downsample_conv"])
            _bn(sd, f"{tp}.downsample.1", tree["downsample_bn"])
    pool = visual["attnpool"]
    sd[f"{p}attnpool.positional_embedding"] = _t(pool["positional_embedding"])
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _linear(sd, f"{p}attnpool.{name}", pool[name])
    return sd


def state_dict_from_jax(variables) -> dict:
    """{'params': {...}} of uml_tpu's CLIP (ViT) or ClipResNetModel (RN)
    -> {key: fp32 tensor}."""
    params = variables["params"]
    v, t = params["visual"], params["text"]
    if "patch_embed" in v:
        sd = {"visual.conv1.weight": _t(np.asarray(
            v["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))}   # HWIO -> OIHW
        sd["visual.class_embedding"] = _t(v["class_embedding"])
        sd["visual.positional_embedding"] = _t(v["positional_embedding"])
        _ln(sd, "visual.ln_pre", v["ln_pre"])
        _transformer(sd, "visual.transformer", v["transformer"])
        _ln(sd, "visual.ln_post", v["ln_post"])
        sd["visual.proj"] = _t(v["proj"])
    else:
        sd = resnet_state_dict_from_jax(v)
    sd["token_embedding.weight"] = _t(t["token_embedding"]["embedding"])
    sd["positional_embedding"] = _t(t["positional_embedding"])
    _transformer(sd, "transformer", t["transformer"])
    _ln(sd, "ln_final", t["ln_final"])
    sd["text_projection"] = _t(t["text_projection"])
    sd["logit_scale"] = _t(params["logit_scale"])
    return sd


def dino_state_dict_from_jax(variables) -> dict:
    """{'params': {...}} of uml_tpu's DinoViT -> {key: fp32 tensor} of the
    port's DinoViT (Linear kernels [in, out] -> weights [out, in], the
    patch kernel HWIO -> OIHW; LayerScale where the tree has it)."""
    params = variables["params"]
    sd = {"patch_embed.weight": _t(np.asarray(
              params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
          "patch_embed.bias": _t(params["patch_embed"]["bias"]),
          "cls_token": _t(params["cls_token"]),
          "position_embeddings": _t(params["position_embeddings"]),
          "norm.weight": _t(params["norm"]["scale"]),
          "norm.bias": _t(params["norm"]["bias"])}
    n = len([k for k in params if k.startswith("blocks_")])
    for i in range(n):
        blk, p = params[f"blocks_{i}"], f"blocks.{i}"
        for name in ("norm1", "norm2"):
            sd[f"{p}.{name}.weight"] = _t(blk[name]["scale"])
            sd[f"{p}.{name}.bias"] = _t(blk[name]["bias"])
        for name in ("qkv", "attn_out", "fc1", "fc2"):
            _linear(sd, f"{p}.{name}", blk[name])
        for name in ("layerscale1", "layerscale2"):
            if name in blk:
                sd[f"{p}.{name}"] = _t(blk[name])
    return sd


def uml_head_params_from_jax(params) -> dict:
    """uml_tpu's UMLHead trainable tree (numpy leaves: head_w, img_proj_w,
    img_scale, txt_scale, and ``backbone`` = the CLIP or DINO variables on
    the full-model path) -> the tree ``UMLHead.load_state_tree`` reads.  A
    backbone is DINO's when its tree has no ``visual`` tower (DinoViT's
    leaves: ``patch_embed``, ``cls_token``, ``blocks_{i}``, ``norm``)."""
    tree = {k: torch.tensor(np.asarray(v, np.float32))   # keeps 0-d scales
            for k, v in params.items() if k != "backbone"}
    if "backbone" in params:
        backbone = params["backbone"]
        tree["backbone"] = (state_dict_from_jax(backbone)
                            if "visual" in backbone["params"]
                            else dino_state_dict_from_jax(backbone))
    return tree


def llama_state_dict_from_jax(variables) -> dict:
    """{'params': {...}} of uml_tpu's LlamaEncoder (numpy leaves) -> the
    port's LlamaEncoder state_dict (HF's names): Dense kernels [in, out]
    -> weights [out, in] fp32; an int8_w projection's ``kernel_q8`` (int8
    [in, out]) and ``scale`` carried as they are."""
    from uml_tpu_torch.models.llama import Q8_PROJS

    params = variables["params"]
    sd = {"embed_tokens.weight": _t(params["embed_tokens"]["embedding"]),
          "norm.weight": _t(params["norm"]["weight"])}
    n = len([k for k in params if k.startswith("layers_")])
    for i in range(n):
        layer, p = params[f"layers_{i}"], f"layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = _t(layer["input_norm"]["weight"])
        sd[f"{p}.post_attention_layernorm.weight"] = _t(
            layer["post_attn_norm"]["weight"])
        for name in Q8_PROJS:
            key = f"{p}.{'self_attn' if name in Q8_PROJS[:4] else 'mlp'}.{name}"
            tree = layer[name]
            if "kernel_q8" in tree:
                sd[f"{key}.kernel_q8"] = torch.tensor(
                    np.ascontiguousarray(np.asarray(tree["kernel_q8"], np.int8)))
                sd[f"{key}.scale"] = _t(tree["scale"])
            else:
                sd[f"{key}.weight"] = _t(np.asarray(tree["kernel"]).T)
    return sd


def seq_uml_state_dict_from_jax(variables) -> dict:
    """{'params': {...}} of uml_tpu's SeqUML (numpy or tensor leaves) -> the
    port's SeqUML state_dict: the flax path joined by dots, a Dense kernel
    [in, out] -> ``weight`` [out, in], ``bias`` as it is, a LayerNorm
    ``scale`` -> ``weight``, a bare array (``pos_embedding``) as it is."""
    sd = {}

    def walk(tree, prefix):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, f"{prefix}{name}.")
            elif name == "kernel":
                sd[f"{prefix}weight"] = _t(np.asarray(leaf).T)
            elif name == "scale":
                sd[f"{prefix}weight"] = _t(leaf)
            else:
                sd[f"{prefix}{name}"] = _t(leaf)

    walk(variables["params"], "")
    return sd


def seq_uml_state_dict_to_jax(state_dict) -> dict:
    """The inverse of ``seq_uml_state_dict_from_jax``: the port's SeqUML
    state_dict -> {'params': {...}} with numpy fp32 leaves, uml_tpu's names
    and layout (a 2-d ``weight`` is a Dense kernel, transposed to [in, out];
    a 1-d one a LayerNorm scale)."""
    params = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        node = params
        for part in path:
            node = node.setdefault(part, {})
        a = value.detach().cpu().float().numpy()
        if name == "weight":
            node["kernel" if a.ndim == 2 else "scale"] = np.ascontiguousarray(
                a.T if a.ndim == 2 else a)
        else:
            node[name] = a.copy()
    return {"params": params}


def shared_autoencoder_from_jax(variables) -> dict:
    """{'params': {...}} of uml_tpu's SharedAutoencoder -> the port's
    state_dict: each Dense ``kernel`` [in, out] -> ``weight`` [out, in]
    (the same walk as ``seq_uml_state_dict_from_jax``)."""
    return seq_uml_state_dict_from_jax(variables)


def shared_autoencoder_to_jax(state_dict) -> dict:
    """The inverse: the port's SharedAutoencoder state_dict -> uml_tpu's
    {'params': {...}} tree of numpy fp32 leaves."""
    return seq_uml_state_dict_to_jax(state_dict)
