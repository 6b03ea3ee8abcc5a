"""HF's MistralModel (modeling_mistral.py), plainly, as a text encoder with
the features CLI's pooling: the embedding, pre-norm decoder layers
(RMSNorm in float32, half-split rotary, 32 query heads over 8 key / value
heads, SwiGLU), the final RMSNorm, and the attention-masked mean of the
last hidden state over each row's real tokens.

Departures from the published model, each of which changes no real
token's result:

* no ``position_ids`` are passed, so the rotary positions are 0 .. T-1 of
  the padded row, as HF's MistralModel takes them without any (a
  left-padded row's real tokens start at its pad count);
* the sliding window (4096) is left out: no row here is that long;
* attention is a key mask of causality and the row's real keys, each
  score it masks set to float32's lowest value (HF's additive mask); a
  pad query, which sees no real key, then averages the keys it sees
  and stays finite, and the pooling leaves it out;
* the grouped query heads read their key / value head by a reshape, not
  a repeat.

Every product goes through ``mm`` (reference.precision), so the control
runs the same code in TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rotary(t, theta: float):
    """HF's default rotary on t [B, H, T, D] at positions 0 .. T-1: the
    inverse frequencies in float32 from integer exponents, cos and sin of
    the angles, the rotation of the two halves."""
    d, n = t.shape[-1], t.shape[-2]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=t.device).float() / d))
    ang = torch.arange(n, device=t.device).float()[:, None] * inv[None, :]
    emb = torch.cat([ang, ang], dim=-1)
    x1, x2 = t.chunk(2, dim=-1)
    return t * emb.cos() + torch.cat([-x2, x1], dim=-1) * emb.sin()


def attention(y, sd, k, keep, cfg, mm):
    """Grouped-query attention of y [B, T, hidden] under the boolean key
    mask ``keep`` [B, 1, 1, T, T]."""
    b, n, hid = y.shape
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = hid // heads
    q = mm(y, sd[k + "q_proj.weight"].t()).view(b, n, heads, hd).transpose(1, 2)
    key = mm(y, sd[k + "k_proj.weight"].t()).view(b, n, kv, hd).transpose(1, 2)
    val = mm(y, sd[k + "v_proj.weight"].t()).view(b, n, kv, hd).transpose(1, 2)
    theta = cfg["rope_theta"]
    q = rotary(q, theta).reshape(b, kv, heads // kv, n, hd)
    key = rotary(key, theta)[:, :, None]
    val = val[:, :, None]
    scores = mm(q, key.transpose(-2, -1)) / math.sqrt(hd)
    scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    out = mm(torch.softmax(scores, dim=-1), val)                # [B, kv, g, T, hd]
    out = out.reshape(b, heads, n, hd).transpose(1, 2).reshape(b, n, hid)
    return mm(out, sd[k + "o_proj.weight"].t())


def hidden_states(sd, ids, mask, cfg, mm):
    """ids, mask [B, T] -> the last hidden state [B, T, hidden], float32,
    layer by layer."""
    n = ids.shape[1]
    real = mask.bool()
    causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()
    keep = (causal[None] & real[:, None, :])[:, None, None]       # [B, 1, 1, T, T]
    eps = cfg["rms_norm_eps"]
    x = sd["embed_tokens.weight"][ids].float()
    for i in range(cfg["num_hidden_layers"]):
        k = f"layers.{i}."
        y = rms_norm(x, sd[k + "input_layernorm.weight"], eps)
        x = x + attention(y, sd, k + "self_attn.", keep, cfg, mm)
        y = rms_norm(x, sd[k + "post_attention_layernorm.weight"], eps)
        gate = mm(y, sd[k + "mlp.gate_proj.weight"].t())
        up = mm(y, sd[k + "mlp.up_proj.weight"].t())
        x = x + mm(F.silu(gate) * up, sd[k + "mlp.down_proj.weight"].t())
    return rms_norm(x, sd["norm.weight"], eps)


def features(sd, ids, mask, cfg, mm):
    """The pooled features [B, hidden]: the mean of the last hidden state
    over each row's real tokens (``mask`` 1)."""
    with torch.no_grad():
        h = hidden_states(sd, ids, mask, cfg, mm)
        m = mask.float()[..., None]
        return (h * m).sum(1) / m.sum(1)
