"""OpenAI CLIP's VisionTransformer (clip/model.py), plainly: conv1
without bias over pixels normalised with CLIP's mean and std, the class
embedding, the positional embedding, ln_pre, pre-LN residual blocks
(packed in_proj, QuickGELU MLP), ln_post on the class token, ``proj``."""

from __future__ import annotations

import torch

from port_bench.reference.vit import attention, layer_norm, normalized_patches


def features(sd, images_u8, cfg, mm):
    """OpenAI schema ``visual.*`` -> image features [B, embed_dim]."""
    p, r, d = cfg["vision_patch_size"], cfg["image_resolution"], cfg["vision_width"]
    heads, eps = cfg["vision_heads"], cfg["ln_eps"]
    v = "visual."
    x = mm(normalized_patches(images_u8, r, p),
           sd[v + "conv1.weight"].reshape(d, -1).t())
    cls = sd[v + "class_embedding"].expand(x.shape[0], 1, d)
    x = torch.cat([cls, x], dim=1) + sd[v + "positional_embedding"]
    x = layer_norm(x, sd[v + "ln_pre.weight"], sd[v + "ln_pre.bias"], eps)
    for i in range(cfg["vision_layers"]):
        k = f"{v}transformer.resblocks.{i}."
        wq, wk, wv = sd[k + "attn.in_proj_weight"].chunk(3)
        bq, bk, bv = sd[k + "attn.in_proj_bias"].chunk(3)
        h = layer_norm(x, sd[k + "ln_1.weight"], sd[k + "ln_1.bias"], eps)
        x = x + attention(h, wq, bq, wk, bk, wv, bv, sd[k + "attn.out_proj.weight"],
                          sd[k + "attn.out_proj.bias"], heads, mm)
        h = layer_norm(x, sd[k + "ln_2.weight"], sd[k + "ln_2.bias"], eps)
        h = mm(h, sd[k + "mlp.c_fc.weight"].t()) + sd[k + "mlp.c_fc.bias"]
        h = h * torch.sigmoid(1.702 * h)
        x = x + mm(h, sd[k + "mlp.c_proj.weight"].t()) + sd[k + "mlp.c_proj.bias"]
    x = layer_norm(x[:, 0], sd[v + "ln_post.weight"], sd[v + "ln_post.bias"], eps)
    return mm(x, sd[v + "proj"])
