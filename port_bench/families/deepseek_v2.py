"""DeepSeek-V2 (HF DeepseekV2Model schema) as a text encoder: the features
CLI's language-model path for ``--language_model deepseek-v2-lite``, the
port's ``TextModel`` over its ``DeepseekV2Encoder``
(``models/languagemodel.py``, ``models/deepseek_v2.py``), built by
``TextModel.native`` from a state dict with no tokenizer and no
``transformers``.  A text-only family: no image tower, no head, no
``units``.

The weights are drawn a layer at a time, each layer's leaves cut from one
draw of their own (the embedding and the final norm likewise), so every
layer lies in storage of its own: the program takes the tensors as they
lie, and freeing it frees them.  The program and the reference draw the
same weights from the same seed."""

from __future__ import annotations

import torch

from port_bench import flops
from port_bench.reference import deepseek_v2 as plain

reference_features = plain.features


def _moe(cfg, i) -> bool:
    return i >= cfg["first_k_dense_replace"] and i % cfg["moe_layer_freq"] == 0


def _proj(key, d_out, d_in):
    return (key, (d_out, d_in), 0.0, d_in ** -0.5)


def _mlp(prefix, d, m):
    return [_proj(f"{prefix}gate_proj.weight", m, d), _proj(f"{prefix}up_proj.weight", m, d),
            _proj(f"{prefix}down_proj.weight", d, m)]


def _layer(cfg, i):
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    k = f"layers.{i}."
    a = k + "self_attn."
    out = [(k + "input_layernorm.weight", (d,), 1.0, 0.1),
           _proj(a + "q_proj.weight", h * (nope + rope), d),
           _proj(a + "kv_a_proj_with_mqa.weight", r + rope, d),
           (a + "kv_a_layernorm.weight", (r,), 1.0, 0.1),
           _proj(a + "kv_b_proj.weight", h * (nope + vd), r),
           _proj(a + "o_proj.weight", d, h * vd),
           (k + "post_attention_layernorm.weight", (d,), 1.0, 0.1)]
    if not _moe(cfg, i):
        return out + _mlp(k + "mlp.", d, cfg["intermediate_size"])
    m = cfg["moe_intermediate_size"]
    out.append(_proj(k + "mlp.gate.weight", cfg["n_routed_experts"], d))
    for e in range(cfg["n_routed_experts"]):
        out += _mlp(f"{k}mlp.experts.{e}.", d, m)
    return out + _mlp(k + "mlp.shared_experts.", d, m * cfg["n_shared_experts"])


def groups(cfg) -> list:
    """The schema in its draws: the embedding, each layer, the final norm;
    each a [(key, shape, mean, std)] of HF's DeepseekV2Model state dict
    (no LM head): projections [out, in] N(0, in^-1/2) (the gate's too),
    the embedding N(0, hidden^-1/2), the RMSNorm scales N(1, 0.1)."""
    d = cfg["hidden_size"]
    return ([[("embed_tokens.weight", (cfg["vocab_size"], d), 0.0, d ** -0.5)]]
            + [_layer(cfg, i) for i in range(cfg["num_hidden_layers"])]
            + [[("norm.weight", (d,), 1.0, 0.1)]])


def schema(cfg) -> list:
    return [leaf for group in groups(cfg) for leaf in group]


def state_dict(cfg, seed: int, device) -> dict:
    """{key: float32 tensor}: one generator on ``device`` seeded with
    ``seed``, one normal draw a group, cut into its leaves and scaled in
    place."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for group in groups(cfg):
        sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device)
        off = 0
        for (key, shape, mean, std), n in zip(group, sizes):
            out[key] = flat[off:off + n].view(shape).mul_(std).add_(mean)
            off += n
    return out


def build_text_model(cfg, sd, device):
    """The program's TextModel over a DeepseekV2Encoder that takes ``sd``'s
    tensors as they lie (``TextModel.native``), in float32 as TextModel
    runs it."""
    from uml_tpu_torch.models.deepseek_v2 import DeepseekV2Config
    from uml_tpu_torch.models.languagemodel import TextModel

    if cfg["compute_dtype"] != "float32":
        raise ValueError("TextModel runs its DeepseekV2Encoder in float32")
    return TextModel.native(DeepseekV2Config.from_dict(cfg), sd, device=device)


def feature_width(cfg) -> int:
    return cfg["hidden_size"]


def vocab(cfg) -> int:
    return cfg["vocab_size"]


def forward_ops(cfg, lengths) -> list:
    """Operations and bytes of one call whose rows hold ``lengths`` real
    tokens each, float32 (4-byte activations and weights).  Only the real
    tokens' work counts (under the causal mask and the pad keys' mask no
    real token's state reads a pad): MLA's four projections and its core
    on each row's (query, key at or before it) pairs, QK at q_head_dim and
    PV at v_head_dim; the dense layer's MLP; each MoE layer's gate, its
    ``num_experts_per_tok`` routed experts and its shared experts a real
    token.  Each routed expert's weights count as read once a call: a
    call's ~650 real tokens route ~3,900 (token, expert) rows over 64
    experts, ~60 an expert.  Under the seeded weights' uneven routing a
    few experts of a layer get no row (in the pool's longest calls 3-4%
    of the (layer, expert) pairs, by the plain path's product launches:
    4,798-4,850 of 4,992), so the weights' bytes are an upper bound by at
    most that much."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, r = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                         cfg["kv_lora_rank"])
    n = float(sum(lengths))
    pairs = float(sum(t * (t + 1) // 2 for t in lengths))
    b = flops.FP32
    m, me = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    experts, top = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    shared = me * cfg["n_shared_experts"]
    ops = [("embed", 0.0, b * 2 * n * d)]
    for i in range(cfg["num_hidden_layers"]):
        layer = [
            flops.product("mla_q", n, d, h * (nope + rope), b),
            flops.product("mla_kv_a", n, d, r + rope, b),
            flops.product("mla_kv_b", n, r, h * (nope + vd), b, extra_in=b * n * r),
            ("mla_core", 2.0 * pairs * h * (nope + rope + vd),
             b * (n * h * (nope + rope) + n * h * (nope + vd) + n * rope + n * h * vd)),
            flops.product("mla_out", n, h * vd, d, b, extra_in=b * n * d)]
        if not _moe(cfg, i):
            layer += [("mlp_in", 2.0 * n * d * 2 * m, b * (n * d + 2 * d * m + n * m)),
                      flops.product("mlp_out", n, m, d, b, extra_in=b * n * d)]
        else:
            rows = n * top
            layer += [
                flops.product("moe_gate", n, d, experts, b),
                ("moe_experts_in", 2.0 * rows * d * 2 * me,
                 b * (rows * d + experts * 2 * d * me + rows * me)),
                ("moe_experts_out", 2.0 * rows * me * d,
                 b * (rows * me + experts * me * d + rows * d)),
                ("moe_shared_in", 2.0 * n * d * 2 * shared, b * (n * d + 2 * d * shared + n * shared)),
                flops.product("moe_shared_out", n, shared, d, b, extra_in=b * n * d)]
        ops += [(f"layer{i}.{name}", f, by) for name, f, by in layer]
    ops.append(("final_norm_pool", 0.0, b * (n * d + len(lengths) * d)))
    return ops


def counters() -> dict:
    """The program's MoE counters: expert-product launches, counted where
    they are launched (``ops/moe_gemm.py``: ``moe_gemm`` on the card,
    ``moe_gemm_plain`` off it), routed (token, expert) rows
    (``models/deepseek_v2.py::routed_experts``), and the work handed to
    the grouped kernel (``moe_gemm``: its operations, its bytes and the
    weights' part of them, its grids' row tiles and experts).  The
    busiest expert's rows are counted where the host reads the counts, the
    CPU alone, so the card's runs do not report them."""
    from uml_tpu_torch.models.deepseek_v2 import routed_experts
    from uml_tpu_torch.ops.moe_gemm import moe_gemm, moe_gemm_plain

    return {"expert_launches": moe_gemm.launches + moe_gemm_plain.launches,
            "routed_rows": routed_experts.rows,
            "moe_gemm_flops": moe_gemm.flops, "moe_gemm_bytes": moe_gemm.bytes,
            "moe_gemm_weight_bytes": moe_gemm.weight_bytes, "moe_gemm_tiles": moe_gemm.tiles,
            "moe_gemm_groups": moe_gemm.groups}
