"""DeepSeek's DeepseekV2Model (``modeling_deepseek.py`` of DeepSeek-V2 /
DeepSeek-V2-Lite), plainly, as a text encoder with the features CLI's
pooling: the embedding; pre-norm decoder layers of multi-head latent
attention (no q LoRA: ``q_proj`` to nope + rope dims a head;
``kv_a_proj_with_mqa`` to the latent and one rope key for all heads; the
latent's RMSNorm; ``kv_b_proj`` to the nope keys and values; YaRN rotary
on the rope dims; softmax at q_head_dim^-1/2 x mscale^2; ``o_proj``),
then a dense SwiGLU in the first ``first_k_dense_replace`` layers and in
the others the MoE (a float32 softmax gate, greedy top-k, the weights the
selected probabilities x ``routed_scaling_factor``, the routed experts'
weighted sum and the shared experts); the final RMSNorm; the
attention-masked mean of the last hidden state over each row's real
tokens.

Departures from DeepSeek's code, each of which changes no real token's
result:

* no ``position_ids`` are passed, so the rotary positions are 0 .. T-1 of
  the padded row, as DeepseekV2Model takes them without any (a
  left-padded row's real tokens start at its pad count);
* the cos / sin tables are made for the call's T positions, not cached
  for ``max_position_embeddings`` (the same values: each is cos / sin of
  position x inverse frequency, in float32);
* attention is a key mask of causality and the row's real keys, each
  score it masks set to float32's lowest value; a pad query, which sees
  no real key, then averages the keys it sees and stays finite, and the
  pooling leaves it out;
* the MoE is a plain loop over the experts, each taking the (token, slot)
  pairs routed to it (``moe_infer`` sorts the pairs by expert first); the
  pairs' outputs are summed by their weights slot by slot, as there;
* the pads are routed as every token is, so no expert's load changes;
  no expert drops a token (DeepSeek's inference drops none either);
* the rope dims are de-interleaved once and rotated by halves, as
  DeepSeek's ``apply_rotary_pos_emb`` does; q . k is the same under any
  one permutation of both.

Every product goes through ``mm`` (reference.precision), the gate's and
each expert's too, so the control runs the same code in TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _mscale(scale, mscale=1.0):
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def inv_freq(cfg, device):
    """DeepseekV2YarnRotaryEmbedding's inverse frequencies and the cos /
    sin factor (DeepseekV2RotaryEmbedding's, factor 1, without
    ``rope_scaling``)."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    rs = cfg.get("rope_scaling")
    if rs is None:
        return 1.0 / pos, 1.0
    orig = rs["original_max_position_embeddings"]

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low if high != low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp                                  # extrapolated share
    inv = (1.0 / (rs["factor"] * pos)) * (1 - keep) + (1.0 / pos) * keep
    return inv, _mscale(rs["factor"], rs["mscale"]) / _mscale(rs["factor"], rs["mscale_all_dim"])


def scale(cfg) -> float:
    s = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs is not None and rs.get("mscale_all_dim"):
        s *= _mscale(rs["factor"], rs["mscale_all_dim"]) ** 2
    return s


def rotary(t, cos, sin):
    """t [..., T, D] interleaved -> de-interleaved, rotated by halves."""
    *lead, n, d = t.shape
    t = t.view(*lead, n, d // 2, 2).transpose(-1, -2).reshape(*lead, n, d)
    x1, x2 = t.chunk(2, dim=-1)
    return t * cos + torch.cat([-x2, x1], dim=-1) * sin


def attention(y, sd, k, keep, cos, sin, cfg, mm):
    """MLA of y [B, T, hidden] under the boolean key mask ``keep`` [B, 1,
    T, T]."""
    b, n, _ = y.shape
    h, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                         cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r = cfg["kv_lora_rank"]
    q = mm(y, sd[k + "q_proj.weight"].t()).view(b, n, h, nope + rope).transpose(1, 2)
    ckv = mm(y, sd[k + "kv_a_proj_with_mqa.weight"].t())
    latent, k_pe = ckv[..., :r], ckv[..., r:]
    # DeepSeek builds kv_a_layernorm with its RMSNorm's default eps, 1e-6
    kv = mm(rms_norm(latent, sd[k + "kv_a_layernorm.weight"], 1e-6),
            sd[k + "kv_b_proj.weight"].t()).view(b, n, h, nope + vd).transpose(1, 2)
    q_pe = rotary(q[..., nope:], cos, sin)
    k_pe = rotary(k_pe.reshape(b, 1, n, rope), cos, sin)
    query = torch.cat([q[..., :nope], q_pe], dim=-1)
    key = torch.cat([kv[..., :nope], k_pe.expand(b, h, n, rope)], dim=-1)
    scores = mm(query, key.transpose(-2, -1)) * scale(cfg)
    scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
    out = mm(torch.softmax(scores, dim=-1, dtype=torch.float32), kv[..., nope:])
    return mm(out.transpose(1, 2).reshape(b, n, h * vd), sd[k + "o_proj.weight"].t())


def swiglu(x, sd, k, mm):
    gate = mm(x, sd[k + "gate_proj.weight"].t())
    up = mm(x, sd[k + "up_proj.weight"].t())
    return mm(F.silu(gate) * up, sd[k + "down_proj.weight"].t())


def route(x, sd, k, cfg, mm):
    """MoEGate: (experts [N, top], weights [N, top]) of x [N, hidden]."""
    scores = torch.softmax(mm(x.float(), sd[k + "gate.weight"].float().t()), dim=-1,
                           dtype=torch.float32)
    w, idx = torch.topk(scores, k=cfg["num_experts_per_tok"], dim=-1)
    if cfg["num_experts_per_tok"] > 1 and cfg["norm_topk_prob"]:
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg["routed_scaling_factor"]


def moe(y, sd, k, cfg, mm):
    b, n, d = y.shape
    x = y.reshape(-1, d)
    idx, w = route(x, sd, k, cfg, mm)
    out = x.new_zeros(x.shape[0], idx.shape[1], d)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out[tok, slot] = swiglu(x[tok], sd, f"{k}experts.{e}.", mm)
    routed = (out * w.unsqueeze(-1)).sum(1)
    return (routed + swiglu(x, sd, k + "shared_experts.", mm)).view(b, n, d)


def hidden_states(sd, ids, mask, cfg, mm):
    """ids, mask [B, T] -> the last hidden state [B, T, hidden], float32,
    layer by layer."""
    n = ids.shape[1]
    real = mask.bool()
    causal = torch.ones(n, n, dtype=torch.bool, device=ids.device).tril()
    keep = (causal[None] & real[:, None, :])[:, None]               # [B, 1, T, T]
    inv, factor = inv_freq(cfg, ids.device)
    ang = torch.outer(torch.arange(n, device=ids.device, dtype=torch.float32), inv)
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos() * factor, emb.sin() * factor
    eps = cfg["rms_norm_eps"]
    x = sd["embed_tokens.weight"][ids].float()
    for i in range(cfg["num_hidden_layers"]):
        k = f"layers.{i}."
        y = rms_norm(x, sd[k + "input_layernorm.weight"], eps)
        x = x + attention(y, sd, k + "self_attn.", keep, cos, sin, cfg, mm)
        y = rms_norm(x, sd[k + "post_attention_layernorm.weight"], eps)
        dense = i < cfg["first_k_dense_replace"] or i % cfg["moe_layer_freq"]
        x = x + (swiglu(y, sd, k + "mlp.", mm) if dense else moe(y, sd, k + "mlp.", cfg, mm))
    return rms_norm(x, sd["norm.weight"], eps)


def features(sd, ids, mask, cfg, mm):
    """The pooled features [B, hidden]: the mean of the last hidden state
    over each row's real tokens (``mask`` 1)."""
    with torch.no_grad():
        h = hidden_states(sd, ids, mask, cfg, mm)
        m = mask.float()[..., None]
        return (h * m).sum(1) / m.sum(1)
