"""A LLaMA-architecture decoder as a text encoder (HF MistralModel /
LlamaModel schema): the features CLI's language-model path, the port's
``TextModel`` over its ``LlamaEncoder`` (``models/languagemodel.py``,
``models/llama.py``), built by ``TextModel.native`` from a state dict with
no tokenizer and no ``transformers``.  A text-only family: no image
tower, no head, no ``units``."""

from __future__ import annotations

from port_bench import flops
from port_bench.families.common import draw
from port_bench.reference import llama_encoder as plain

reference_features = plain.features

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")


def _widths(cfg):
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    return d, cfg["intermediate_size"], d // heads * cfg["num_key_value_heads"]


def schema(cfg):
    """[(key, shape, mean, std)] of HF's MistralModel state dict (no LM
    head): projections [out, in] N(0, in^-1/2), the embedding
    N(0, hidden^-1/2), the RMSNorm scales N(1, 0.1)."""
    d, m, kv = _widths(cfg)
    outs = {"q_proj": (d, d), "k_proj": (kv, d), "v_proj": (kv, d), "o_proj": (d, d),
            "gate_proj": (m, d), "up_proj": (m, d), "down_proj": (d, m)}
    out = [("embed_tokens.weight", (cfg["vocab_size"], d), 0.0, d ** -0.5)]
    for i in range(cfg["num_hidden_layers"]):
        k = f"layers.{i}."
        out += [(k + "input_layernorm.weight", (d,), 1.0, 0.1),
                (k + "post_attention_layernorm.weight", (d,), 1.0, 0.1)]
        out += [(f"{k}self_attn.{n}.weight", outs[n], 0.0, outs[n][1] ** -0.5) for n in _ATTN]
        out += [(f"{k}mlp.{n}.weight", outs[n], 0.0, outs[n][1] ** -0.5) for n in _MLP]
    out += [("norm.weight", (d,), 1.0, 0.1)]
    return out


def state_dict(cfg, seed: int, device) -> dict:
    return draw(schema(cfg), seed, device)


def build_text_model(cfg, sd, device):
    """The program's TextModel over a LlamaEncoder that takes ``sd``'s
    tensors as they lie (``TextModel.native``), in float32 as TextModel
    runs it."""
    from uml_tpu_torch.models.languagemodel import TextModel
    from uml_tpu_torch.models.llama import LlamaConfig

    if cfg["compute_dtype"] != "float32":
        raise ValueError("TextModel runs its LlamaEncoder in float32")
    conf = LlamaConfig(vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
                       intermediate_size=cfg["intermediate_size"],
                       num_hidden_layers=cfg["num_hidden_layers"],
                       num_attention_heads=cfg["num_attention_heads"],
                       num_key_value_heads=cfg["num_key_value_heads"],
                       rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"])
    return TextModel.native(conf, sd, device=device)


def feature_width(cfg) -> int:
    return cfg["hidden_size"]


def vocab(cfg) -> int:
    return cfg["vocab_size"]


def forward_ops(cfg, lengths) -> list:
    """Operations and bytes of one call whose rows hold ``lengths`` real
    tokens each, float32 (4-byte activations and weights).  Only the real
    tokens' work counts: under the causal mask and the pad keys' mask no
    real token's state reads a pad, so the pads are work no result needs.
    Attention counts each (query, key) pair of a row's real tokens with
    the key at or before the query."""
    d, m, kv = _widths(cfg)
    n = float(sum(lengths))
    pairs = float(sum(t * (t + 1) // 2 for t in lengths))
    b = flops.FP32
    ops = [("embed", 0.0, b * 2 * n * d)]
    for i in range(cfg["num_hidden_layers"]):
        ops += [(f"layer{i}.{name}", f, by) for name, f, by in [
            ("attn_qkv", 2.0 * n * d * (d + 2 * kv), b * (n * d + d * (d + 2 * kv) + n * (d + 2 * kv))),
            ("attn_core", 4.0 * pairs * d, b * (n * d + 2 * n * kv + n * d)),
            flops.product("attn_out", n, d, d, b, extra_in=b * n * d),
            ("mlp_in", 2.0 * n * d * 2 * m, b * (n * d + 2 * d * m + n * m)),
            flops.product("mlp_out", n, m, d, b, extra_in=b * n * d)]]
    ops.append(("final_norm_pool", 0.0, b * (n * d + len(lengths) * d)))
    return ops


def counters() -> dict:
    """Empty: nothing on the LlamaEncoder's path (``F.linear``,
    ``mha_plain``, the norms) counts its launches."""
    return {}
