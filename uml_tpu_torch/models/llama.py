"""LLaMA-architecture text encoder (OpenLLaMA, Mistral) in PyTorch.

The port of uml_tpu/models/llama.py: the decoder stack written in-house
(the reference runs these models through HF on one GPU,
engine/models/languagemodel.py:10-62), returning the last hidden states.
Numerics as uml_tpu's (and HF's LlamaModel): RMSNorm in fp32, half-split
rotary embeddings with the inverse frequencies in float64 cast to fp32,
grouped-query attention by repeating the kv heads, SwiGLU MLP; the mask
is an additive causal mask plus a pad mask of -1e30 (llama.py:209-215)
through ``ops.attention.mha_plain`` (uml_tpu's ``mha_reference``: no
Pallas kernel runs here).  Mistral uses the same block.

Parameter names are HF's (``embed_tokens``, ``layers.{i}.self_attn.q_proj``,
``layers.{i}.mlp.gate_proj``, ``input_layernorm``,
``post_attention_layernorm``, ``norm``), with float projections as
``nn.Linear``-layout weights [out, in], so ``port_hf_llama`` is a copy.
``quant="int8_w"``: weight-only int8 projections (``Q8Dense``: int8
``kernel_q8`` [in, out] and a per-column fp32 ``scale``; the products run
in the compute dtype and the scale rides the output, llama.py:91-124);
``quantize_llama_params`` turns a float state_dict into that layout with
``ops.quant.quantize_weight`` (round half up).  ``LLAMA_TP_RULES`` are
the tensor-parallel rules of these names (uml_tpu's llama.py:225-229):
q / k / v, gate and up column-parallel, o and down row-parallel, applied
by ``parallel.tensor_parallel.apply_tp_sharding`` (``TextModel(...,
mesh=)``).  Under them every rank still runs all heads, on weights
gathered whole where a projection reads them (the module docstring of
parallel/tensor_parallel.py): no config splits its heads over ranks, so
the number of kv heads puts no condition on the ``model`` axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from uml_tpu_torch.ops.attention import mha_plain

_NEG = -1e30
Q8_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj",
            "gate_proj", "up_proj", "down_proj")


# parallel.tensor_parallel rules over HF's names: int8_w's kernel_q8
# [in, out] and its scale shard as the float weight [out, in] does
LLAMA_TP_RULES = [
    (r"\bq_proj\b|\bk_proj\b|\bv_proj\b", "col"),
    (r"\bgate_proj\b|\bup_proj\b", "col"),
    (r"\bo_proj\b|\bdown_proj\b", "row"),
]


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    @classmethod
    def from_hf(cls, hf_config) -> "LlamaConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            intermediate_size=hf_config.intermediate_size,
            num_hidden_layers=hf_config.num_hidden_layers,
            num_attention_heads=hf_config.num_attention_heads,
            num_key_value_heads=getattr(hf_config, "num_key_value_heads",
                                        hf_config.num_attention_heads),
            rms_norm_eps=hf_config.rms_norm_eps,
            rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        )


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


def _rope(q, k, theta: float):
    """HF's half-split rotary convention on q, k [B, H, S, D] at positions
    0 .. S-1 (llama.py:71-88)."""
    s, d = q.shape[2], q.shape[3]
    inv_freq = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    positions = torch.arange(s, device=q.device, dtype=torch.float32)
    freqs = positions[:, None] * torch.tensor(inv_freq, dtype=torch.float32,
                                              device=q.device)[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)                   # [S, D]
    cos, sin = emb.cos(), emb.sin()

    def rot_half(x):
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([-x2, x1], dim=-1)

    qf, kf = q.float(), k.float()
    return ((qf * cos + rot_half(qf) * sin).to(q.dtype),
            (kf * cos + rot_half(kf) * sin).to(k.dtype))


class Dense(nn.Module):
    """A bias-free projection, weight [out, in], run in ``dtype``."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in))

    def forward(self, x, dtype):
        return F.linear(x.to(dtype), self.weight.to(dtype))


class Q8Dense(nn.Module):
    """Weight-only int8 projection (llama.py:91-124): ``kernel_q8`` int8
    [in, out] and a per-output-column fp32 ``scale``; y = (x . kq in the
    compute dtype, accumulated in fp32) * scale, so the dequantized weight
    is never stored."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.register_buffer("kernel_q8", torch.zeros(c_in, c_out, dtype=torch.int8))
        self.register_buffer("scale", torch.ones(c_out))

    def forward(self, x, dtype):
        y = torch.matmul(x.to(dtype), self.kernel_q8.to(dtype))
        return (y.float() * self.scale).to(dtype)


def quantize_llama_params(state_dict: dict) -> dict:
    """A float LlamaEncoder state_dict -> the ``quant="int8_w"`` layout:
    each projection's weight [out, in] becomes ``kernel_q8`` int8 [in, out]
    (contiguous, as uml_tpu keeps it) and ``scale`` fp32 [out] (symmetric
    per output column, ops.quant.quantize_weight); the embedding and the
    norms stay float (llama.py:131-146).  Runs where the tensors are."""
    from uml_tpu_torch.ops.quant import quantize_weight

    out = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf == "weight" and prefix.rpartition(".")[2] in Q8_PROJS:
            q, scale = quantize_weight(value.t())
            out[f"{prefix}.kernel_q8"], out[f"{prefix}.scale"] = q.contiguous(), scale
        else:
            out[key] = value
    return out


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, quant: str = "none"):
        super().__init__()
        self.cfg = cfg
        dense = Q8Dense if quant == "int8_w" else Dense
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        d = cfg.hidden_size // h
        k, m = cfg.hidden_size, cfg.intermediate_size
        self.input_layernorm = RMSNorm(k, cfg.rms_norm_eps)
        self.self_attn = nn.ModuleDict({
            "q_proj": dense(k, h * d), "k_proj": dense(k, kvh * d),
            "v_proj": dense(k, kvh * d), "o_proj": dense(h * d, k)})
        self.post_attention_layernorm = RMSNorm(k, cfg.rms_norm_eps)
        self.mlp = nn.ModuleDict({
            "gate_proj": dense(k, m), "up_proj": dense(k, m),
            "down_proj": dense(m, k)})

    def forward(self, x, mask, dtype):
        cfg = self.cfg
        b, s, _ = x.shape
        h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
        d = cfg.hidden_size // h
        attn = self.self_attn
        y = self.input_layernorm(x)
        q = attn["q_proj"](y, dtype).view(b, s, h, d).transpose(1, 2)
        k = attn["k_proj"](y, dtype).view(b, s, kvh, d).transpose(1, 2)
        v = attn["v_proj"](y, dtype).view(b, s, kvh, d).transpose(1, 2)
        q, k = _rope(q, k, cfg.rope_theta)
        if kvh != h:   # grouped-query attention: repeat the kv heads
            k = k.repeat_interleave(h // kvh, dim=1)
            v = v.repeat_interleave(h // kvh, dim=1)
        out = mha_plain(q, k, v, mask=mask).transpose(1, 2).reshape(b, s, h * d)
        x = x + attn["o_proj"](out, dtype)
        y = self.post_attention_layernorm(x)
        mlp = self.mlp
        act = F.silu(mlp["gate_proj"](y, dtype)) * mlp["up_proj"](y, dtype)
        return x + mlp["down_proj"](act, dtype)


class LlamaEncoder(nn.Module):
    """Decoder-only stack -> the last hidden states [B, S, hidden] in
    ``dtype`` (fp32 by default, as uml_tpu's TextModel).  ``quant``:
    "none" or "int8_w" (Q8Dense projections; load them with
    ``quantize_llama_params``)."""

    def __init__(self, cfg: LlamaConfig, dtype=torch.float32, quant: str = "none"):
        super().__init__()
        if quant not in ("none", "int8_w"):
            raise ValueError(f"LlamaEncoder quant {quant!r}: expected none|int8_w")
        self.config, self.dtype, self.quant = cfg, dtype, quant
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaBlock(cfg, quant)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, input_ids, attention_mask=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        x = self.embed_tokens(input_ids).to(self.dtype)
        keep = torch.ones(s, s, dtype=torch.bool, device=dev).tril()
        mask = torch.where(keep, 0.0, _NEG)[None, None]          # [1, 1, S, S]
        if attention_mask is not None:
            pad = torch.where(attention_mask.bool(), 0.0, _NEG)
            mask = mask + pad[:, None, None, :]
        for layer in self.layers:
            x = layer(x, mask, self.dtype)
        return self.norm(x)

    def init_random(self, generator: torch.Generator) -> "LlamaEncoder":
        """Float weights normal with std fan_in^-0.5 (the embedding
        hidden^-0.5), norm scales 1, drawn on the generator's device (a
        CUDA generator fills a model made on the card); int8 projections
        from uniform int8 and scale 3 / (127 sqrt(in)) (llama.py:111-119)."""
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("layernorm.weight") or name == "norm.weight":
                    p.fill_(1.0)
                else:
                    p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
            for m in self.modules():
                if isinstance(m, Q8Dense):
                    c_in = m.kernel_q8.shape[0]
                    m.kernel_q8.copy_(torch.randint(
                        -127, 128, m.kernel_q8.shape, generator=generator,
                        device=generator.device, dtype=torch.int8))
                    m.scale.fill_(3.0 / (127.0 * c_in ** 0.5))
        return self


def build_llama(cfg: LlamaConfig, state_dict: dict, dtype=torch.float32,
                quant: str = "none") -> LlamaEncoder:
    """A LlamaEncoder that takes ``state_dict``'s tensors as they are (no
    copy, on their device): made on the meta device, then assigned."""
    with torch.device("meta"):
        model = LlamaEncoder(cfg, dtype=dtype, quant=quant)
    model.load_state_dict(state_dict, assign=True)
    return model


def port_hf_llama(hf_state_dict, config: LlamaConfig) -> dict:
    """HF LlamaModel / MistralModel state_dict -> the port's (the same
    names; fp32 tensors; HF's non-persistent rotary buffers dropped)."""
    names = ["embed_tokens.weight", "norm.weight"]
    for i in range(config.num_hidden_layers):
        p = f"layers.{i}"
        names += [f"{p}.input_layernorm.weight",
                  f"{p}.post_attention_layernorm.weight"]
        names += [f"{p}.self_attn.{n}.weight" for n in Q8_PROJS[:4]]
        names += [f"{p}.mlp.{n}.weight" for n in Q8_PROJS[4:]]
    return {k: torch.as_tensor(hf_state_dict[k]).float() for k in names}
