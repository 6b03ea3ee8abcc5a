"""DeepSeek-V2 (DeepSeek-V2-Lite) as a text encoder in PyTorch.

The decoder stack of DeepSeek's published ``modeling_deepseek.py``
(DeepSeek-V2), returning the last hidden states as ``LlamaEncoder`` does;
``TextModel`` runs it for ``deepseek`` names in float32.  Each layer:

* **MLA**, multi-head latent attention without q LoRA: ``q_proj`` to
  H x (nope + rope) dims; ``kv_a_proj_with_mqa`` to the latent
  (``kv_lora_rank``) and one rope key shared by every head; the latent
  under its own RMSNorm (``kv_a_layernorm``, eps 1e-6 as DeepSeek's code
  fixes it) into ``kv_b_proj``'s H x (nope key + value); the rope dims
  rotated on interleaved pairs (DeepSeek's de-interleave, then the
  half-split rotation); ``ops.attention.mha_plain`` at DeepSeek's softmax
  scale, q_head_dim^-0.5 x YaRN's mscale(factor, mscale_all_dim)^2;
  ``o_proj``.
* **YaRN rotary** (``rope_scaling`` type yarn): the inverse frequencies
  blended between the extrapolated and the interpolated (/ factor) ones
  by a linear ramp over the correction range of beta_fast / beta_slow,
  the cos / sin tables scaled by mscale(factor, mscale) /
  mscale(factor, mscale_all_dim); built once, on the weights' device,
  when the model is built (``build_deepseek_v2``), for
  ``max_position_embeddings`` positions.
* The first ``first_k_dense_replace`` layers a dense SwiGLU MLP
  (``models/llama.py::swiglu``); the others (every ``moe_layer_freq``-th)
  **MoE**: a float32 softmax gate over the routed experts, greedy top-k,
  the selected probabilities times ``routed_scaling_factor`` (or
  renormalized under ``norm_topk_prob``); every token routed, pads
  included, none dropped and no expert capped; each expert's tokens
  gathered together and run as one product per projection
  (``routed_experts``), combined by the routing weights, plus the shared
  experts, one SwiGLU of ``n_shared_experts`` x the expert width.

On the card the routed experts are two launches of the grouped kernel
``ops/moe_gemm.py::moe_gemm`` a layer, which reads each expert's row count
on the device, so no host synchronisation sizes them; on the CPU, one
product a projection an expert sized by host counts, as DeepSeek's
``moe_infer`` does.  The products are counted where they are launched
(``moe_gemm.launches``, ``moe_gemm_plain.launches``); ``routed_experts``
counts the routed (token, expert) rows (``rows``) and, where the host
reads the counts (the CPU), the busiest expert's rows summed over layers
(``busiest_rows``): from what the host holds alone.  Spans
(``utils/profiling.py::span``, recorded only under a profiler):
``uml.text.mla`` around each attention, ``uml.text.moe`` around each MoE
layer with ``uml.text.moe.route`` (gate, top-k, sort, counts, and the
host read off the card), ``uml.text.moe.experts`` and
``uml.text.moe.shared``.

Parameter names are HF's ``DeepseekV2Model``'s (``layers.{i}.self_attn.
kv_a_proj_with_mqa``, ``layers.{i}.mlp.experts.{j}.gate_proj``,
``layers.{i}.mlp.gate.weight``, ``layers.{i}.mlp.shared_experts.*``), as
``nn.Linear``-layout weights [out, in], so ``port_hf_deepseek_v2`` is a
copy and ``build_deepseek_v2`` takes a state dict's tensors as they lie.
Not supported (``NotImplementedError``): q LoRA, group-limited routing,
scoring other than softmax, attention biases, rope scaling other than
YaRN; ``TextModel`` also refuses ``int8_w`` and a mesh whose ``model``
axis is wider than 1 for this encoder.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields

import torch
from torch import nn
from torch.nn import functional as F

from uml_tpu_torch.models.llama import _NEG, Dense, RMSNorm, swiglu, swiglu_mlp
from uml_tpu_torch.ops.attention import mha_plain
from uml_tpu_torch.ops.moe_gemm import expert_table, moe_gemm, moe_gemm_plain
from uml_tpu_torch.utils.profiling import span

# DeepSeek's code builds kv_a_layernorm with DeepseekV2RMSNorm's default eps
LATENT_EPS = 1e-6
LITE_ROPE_SCALING = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"}


@dataclass(frozen=True)
class DeepseekV2Config:
    """Every key of DeepSeek-V2-Lite's ``config.json`` that shapes the
    model; the defaults are DeepSeek-V2-Lite's published values."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: int | None = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: dict | None = field(default_factory=lambda: dict(LITE_ROPE_SCALING))
    max_position_embeddings: int = 163840
    topk_method: str = "greedy"
    n_group: int | None = 1
    topk_group: int | None = 1
    scoring_func: str = "softmax"
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    seq_aux: bool = True
    hidden_act: str = "silu"
    attention_bias: bool = False
    tie_word_embeddings: bool = False
    model_type: str = "deepseek_v2"

    @classmethod
    def from_dict(cls, d) -> "DeepseekV2Config":
        """The keys of ``d`` this config has (others ignored)."""
        return cls(**{f.name: d[f.name] for f in fields(cls) if f.name in d})

    @classmethod
    def from_hf(cls, hf_config) -> "DeepseekV2Config":
        return cls.from_dict(hf_config.to_dict())

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, layer: int) -> bool:
        return (self.n_routed_experts is not None and layer >= self.first_k_dense_replace
                and layer % self.moe_layer_freq == 0)


def check_supported(cfg: DeepseekV2Config) -> None:
    """Raise NotImplementedError for what this encoder does not compute."""
    scaling = _rope_kind(cfg)
    wrong = [(cfg.q_lora_rank is not None, f"q_lora_rank {cfg.q_lora_rank}"),
             (cfg.topk_method != "greedy", f"topk_method {cfg.topk_method!r}"),
             (cfg.scoring_func != "softmax", f"scoring_func {cfg.scoring_func!r}"),
             (cfg.hidden_act != "silu", f"hidden_act {cfg.hidden_act!r}"),
             (cfg.attention_bias, "attention_bias"),
             (scaling not in (None, "yarn"), f"rope_scaling type {scaling!r}")]
    bad = [what for is_bad, what in wrong if is_bad]
    if bad:
        raise NotImplementedError(f"DeepseekV2Encoder does not run {', '.join(bad)}")


def _rope_kind(cfg):
    rs = cfg.rope_scaling
    return None if rs is None else rs.get("type", rs.get("rope_type"))


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(cfg: DeepseekV2Config) -> float:
    """DeepSeek's: q_head_dim^-0.5, times mscale(factor, mscale_all_dim)^2
    under YaRN (0.11472 for DeepSeek-V2-Lite)."""
    scale = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None and rs.get("mscale_all_dim", 0):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope_inv_freq(cfg: DeepseekV2Config, device=None):
    """(inverse frequencies fp32 [rope dims / 2], the cos / sin scale) of
    DeepSeek's rotary: plain, or YaRN's blend
    (DeepseekV2YarnRotaryEmbedding._set_cos_sin_cache)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (base ** exps)
    rs = cfg.rope_scaling
    if rs is None:
        return freq_extra, 1.0
    factor = rs["factor"]
    freq_inter = 1.0 / (factor * base ** exps)
    original = rs.get("original_max_position_embeddings", 4096)

    def correction_dim(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(correction_dim(rs.get("beta_slow", 1))), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra_share = 1.0 - ramp
    inv_freq = freq_inter * (1 - extra_share) + freq_extra * extra_share
    scale = float(yarn_get_mscale(factor, rs.get("mscale", 1))
                  / yarn_get_mscale(factor, rs.get("mscale_all_dim", 0)))
    return inv_freq, scale


def rope_tables(cfg: DeepseekV2Config, device=None):
    """cos, sin [max_position_embeddings, rope dims] fp32 on ``device``."""
    inv_freq, scale = rope_inv_freq(cfg, device)
    t = torch.arange(cfg.max_position_embeddings, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(x, cos, sin):
    """DeepSeek's apply_rotary_pos_emb on x [..., S, D] at positions
    0 .. S-1: the interleaved pairs de-interleaved, then the half-split
    rotation (cos, sin [S, D])."""
    *lead, s, d = x.shape
    x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class MLA(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        k, h = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = Dense(k, h * cfg.q_head_dim)
        self.kv_a_proj_with_mqa = Dense(k, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, LATENT_EPS)
        self.kv_b_proj = Dense(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        self.o_proj = Dense(h * cfg.v_head_dim, k)
        self.scale = softmax_scale(cfg)

    def forward(self, x, mask, cos, sin, dtype):
        cfg = self.cfg
        b, s, _ = x.shape
        h, nope, rope, vd = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.v_head_dim)
        q = self.q_proj(x, dtype).view(b, s, h, nope + rope).transpose(1, 2)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        latent, k_pe = self.kv_a_proj_with_mqa(x, dtype).split([cfg.kv_lora_rank, rope], dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(latent), dtype)
        k_nope, v = kv.view(b, s, h, nope + vd).transpose(1, 2).split([nope, vd], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe[:, None], cos, sin)                  # [B, 1, S, rope]
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, h, s, rope)], dim=-1)
        out = mha_plain(q, k, v, mask=mask, scale=self.scale)
        return self.o_proj(out.transpose(1, 2).reshape(b, s, h * vd), dtype)


def routed_experts(x, order, counts, weight, moe, dtype):
    """The routed experts' sum for x [N, K]: ``order`` [N x k] sorts the
    (token, slot) rows by expert, ``counts`` holds each expert's rows (a
    device tensor on the card, host ints off it), ``weight`` [N, k] the
    routing weights.  On the card the experts' SwiGLU is two launches of
    ``ops/moe_gemm.py::moe_gemm`` over every expert at once, sized on the
    device; off it, one product a projection an expert
    (``moe_gemm_plain``).  The rows go back to their (token, slot) and are
    summed by the weights, slot by slot, as DeepSeek's ``moe_infer``
    does."""
    n, top = weight.shape
    rows = x.index_select(0, order // top)
    if rows.is_cuda:
        offsets = F.pad(counts.cumsum(0), (1, 0)).int()
        tables = moe.expert_tables()
        m = moe.experts[0]["gate_proj"].weight.shape[0]
        act = moe_gemm(rows, offsets, tables["gate_proj"], m, tables["up_proj"])
        out = moe_gemm(act, offsets, tables["down_proj"], rows.shape[1])
    else:
        weights = {name: [mlp[name].weight.to(dtype) for mlp in moe.experts]
                   for name in ("gate_proj", "up_proj", "down_proj")}
        act = moe_gemm_plain(rows, counts, weights["gate_proj"], weights["up_proj"])
        out = moe_gemm_plain(act, counts, weights["down_proj"])
        routed_experts.busiest_rows += max(counts)
    routed_experts.rows += n * top
    back = torch.empty_like(out).index_copy_(0, order, out)
    return (back.view(n, top, -1) * weight.unsqueeze(-1).to(back.dtype)).sum(dim=1)


routed_experts.rows = 0
routed_experts.busiest_rows = 0


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        k, m = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = Dense(k, cfg.n_routed_experts)
        self.experts = nn.ModuleList(swiglu_mlp(k, m) for _ in range(cfg.n_routed_experts))
        self.shared_experts = (swiglu_mlp(k, m * cfg.n_shared_experts)
                               if cfg.n_shared_experts else None)
        self._tables = None

    def expert_tables(self) -> dict:
        """{projection: the experts' weight pointers on the device}
        (``moe_gemm``'s tables), made at the first call on the card and
        again whenever the weights have moved."""
        key = self.experts[0]["gate_proj"].weight.data_ptr()
        if self._tables is None or self._tables[0] != key:
            self._tables = (key, {name: expert_table([mlp[name].weight for mlp in self.experts])
                                  for name in ("gate_proj", "up_proj", "down_proj")})
        return self._tables[1]

    def route(self, x):
        """x [N, K] -> (the rows' order by expert [N x k], each expert's
        row count, the weights [N, k] fp32): DeepSeek's MoEGate (float32
        logits and softmax, greedy top-k).  The counts stay on the card
        (a tensor) and are read to the host off it (ints)."""
        cfg = self.cfg
        scores = F.linear(x.float(), self.gate.weight.float()).softmax(dim=-1, dtype=torch.float32)
        weight, idx = torch.topk(scores, k=cfg.num_experts_per_tok, dim=-1, sorted=False)
        if cfg.num_experts_per_tok > 1 and cfg.norm_topk_prob:
            weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
        else:
            weight = weight * cfg.routed_scaling_factor
        order = idx.view(-1).argsort()
        # as DeepSeek's moe_infer counts them (torch.bincount would read the
        # ids' maximum to the host first)
        counts = idx.new_zeros(idx.shape[0], cfg.n_routed_experts).scatter_(1, idx, 1).sum(0)
        return order, (counts if x.is_cuda else counts.tolist()), weight

    def forward(self, y, dtype):
        shape = y.shape
        x = y.reshape(-1, shape[-1]).to(dtype)
        with span("uml.text.moe.route"):
            order, counts, weight = self.route(x)
        with span("uml.text.moe.experts"):
            out = routed_experts(x, order, counts, weight, self, dtype)
        if self.shared_experts is not None:
            with span("uml.text.moe.shared"):
                out = out + swiglu(self.shared_experts, x, dtype)
        return out.view(shape)


class DeepseekV2Block(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, moe: bool):
        super().__init__()
        k = cfg.hidden_size
        self.input_layernorm = RMSNorm(k, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(k, cfg.rms_norm_eps)
        self.mlp = MoE(cfg) if moe else swiglu_mlp(k, cfg.intermediate_size)

    def forward(self, x, mask, cos, sin, dtype):
        with span("uml.text.mla"):
            x = x + self.self_attn(self.input_layernorm(x), mask, cos, sin, dtype)
        y = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            with span("uml.text.moe"):
                return x + self.mlp(y, dtype)
        return x + swiglu(self.mlp, y, dtype)


class DeepseekV2Encoder(nn.Module):
    """Decoder-only DeepSeek-V2 stack -> the last hidden states [B, S,
    hidden] in ``dtype`` (fp32 by default, as TextModel runs it)."""

    def __init__(self, cfg: DeepseekV2Config, dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        self.config, self.dtype = cfg, dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(DeepseekV2Block(cfg, cfg.is_moe(i))
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        cos, sin = rope_tables(cfg)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, input_ids, attention_mask=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        x = self.embed_tokens(input_ids).to(self.dtype)
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        mask = torch.where(keep, 0.0, _NEG)[None, None]          # [1, 1, S, S]
        if attention_mask is not None:
            pad = torch.where(attention_mask.bool(), 0.0, _NEG)
            mask = mask + pad[:, None, None, :]
        cos, sin = self.rope_cos[:s], self.rope_sin[:s]
        for layer in self.layers:
            x = layer(x, mask, cos, sin, self.dtype)
        return self.norm(x)


def build_deepseek_v2(cfg: DeepseekV2Config, state_dict: dict,
                      dtype=torch.float32) -> DeepseekV2Encoder:
    """A DeepseekV2Encoder that takes ``state_dict``'s tensors as they are
    (no copy, on their device), its rotary tables built there."""
    with torch.device("meta"):
        model = DeepseekV2Encoder(cfg, dtype=dtype)
    model.load_state_dict(state_dict, assign=True)
    model.rope_cos, model.rope_sin = rope_tables(cfg, model.embed_tokens.weight.device)
    return model


def port_hf_deepseek_v2(hf_state_dict, config: DeepseekV2Config) -> dict:
    """HF DeepseekV2Model state_dict -> the port's (the same names; fp32
    tensors; HF's non-persistent rotary buffers dropped)."""
    with torch.device("meta"):
        names = list(DeepseekV2Encoder(config).state_dict())
    return {k: torch.as_tensor(hf_state_dict[k]).float() for k in names}
