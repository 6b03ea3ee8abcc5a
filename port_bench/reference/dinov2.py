"""The HF Dinov2Model (modeling_dinov2.py), plainly, on pixels
normalised with CLIP's mean and std (what the UML pipeline feeds it):
patch projection with bias, CLS token, position embeddings at the input
grid, pre-LN blocks with separate query/key/value, LayerScale on both
branches, exact GELU, the final LayerNorm, the CLS token."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from port_bench.reference.vit import attention, layer_norm, normalized_patches


def features(sd, images_u8, cfg, mm):
    """HF Dinov2Model schema -> the CLS token after the final LayerNorm."""
    p, r, d = cfg["patch_size"], cfg["image_size"], cfg["hidden_size"]
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    e = "embeddings."
    x = mm(normalized_patches(images_u8, r, p),
           sd[e + "patch_embeddings.projection.weight"].reshape(d, -1).t())
    x = x + sd[e + "patch_embeddings.projection.bias"]
    cls = sd[e + "cls_token"].expand(x.shape[0], 1, d)
    x = torch.cat([cls, x], dim=1) + sd[e + "position_embeddings"]
    for i in range(cfg["num_hidden_layers"]):
        k = f"encoder.layer.{i}."
        a = k + "attention.attention."
        h = layer_norm(x, sd[k + "norm1.weight"], sd[k + "norm1.bias"], eps)
        h = attention(h, sd[a + "query.weight"], sd[a + "query.bias"],
                      sd[a + "key.weight"], sd[a + "key.bias"],
                      sd[a + "value.weight"], sd[a + "value.bias"],
                      sd[k + "attention.output.dense.weight"],
                      sd[k + "attention.output.dense.bias"], heads, mm)
        x = x + h * sd[k + "layer_scale1.lambda1"]
        h = layer_norm(x, sd[k + "norm2.weight"], sd[k + "norm2.bias"], eps)
        h = F.gelu(mm(h, sd[k + "mlp.fc1.weight"].t()) + sd[k + "mlp.fc1.bias"])
        h = mm(h, sd[k + "mlp.fc2.weight"].t()) + sd[k + "mlp.fc2.bias"]
        x = x + h * sd[k + "layer_scale2.lambda1"]
    x = layer_norm(x, sd["layernorm.weight"], sd["layernorm.bias"], eps)
    return x[:, 0]
