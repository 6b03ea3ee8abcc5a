"""The port's DeepSeek-V2 text encoder (uml_tpu_torch/models/deepseek_v2.py)
on the CPU at a tiny size: hidden 64, 3 layers (the first dense), 8
routed experts top-2 and 2 shared, ``kv_lora_rank`` 16, rope 8, nope 16,
v 16, seeded random weights.

Held against the benchmark's plain reference
(port_bench/reference/deepseek_v2.py, with YaRN on), the reference
against transformers' DeepseekV2Model (``rope_scaling=None``: that class
leaves YaRN's mscale^2 out of the softmax scale, so with YaRN the two
differ by design), the YaRN tables against transformers' yarn
parameters, the routing (no token dropped, pads inert, the counters), the
HF port and ``TextModel``'s routing of DeepSeek names."""

import numpy as np
import pytest
import torch

from port_bench.reference import deepseek_v2 as plain
from port_bench.reference import precision
from uml_tpu_torch.models import deepseek_v2 as ds
from uml_tpu_torch.models import languagemodel as tlm

# float32 throughout; the port and the references sum their products and
# the routed experts in other orders, so they agree to float32 round-off
# grown over three layers, not bit for bit
TOL = 2e-5
TINY = dict(vocab_size=97, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=4,
            n_routed_experts=8, num_experts_per_tok=2, n_shared_experts=2, kv_lora_rank=16,
            qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, max_position_embeddings=64)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")


def tiny_cfg(**over) -> ds.DeepseekV2Config:
    return ds.DeepseekV2Config(**{**TINY, **over})


def as_dict(cfg: ds.DeepseekV2Config) -> dict:
    from dataclasses import asdict

    return asdict(cfg)


def seeded_state_dict(cfg, seed=0) -> dict:
    """Projections N(0, in^-1/2), the embedding N(0, hidden^-1/2), the
    norm scales N(1, 0.1), in the port's (HF's) names."""
    with torch.device("meta"):
        names = ds.DeepseekV2Encoder(cfg).state_dict()
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in names.items():
        if name.endswith("layernorm.weight") or name == "norm.weight":
            out[name] = 1.0 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            out[name] = torch.randn(t.shape, generator=gen) * t.shape[-1] ** -0.5
    return out


def left_padded(seed=3, rows=(7, 3, 10, 1), vocab=97, pad=2):
    gen = torch.Generator().manual_seed(seed)
    t = max(rows)
    ids = torch.full((len(rows), t), pad, dtype=torch.long)
    mask = torch.zeros(len(rows), t, dtype=torch.long)
    for r, n in enumerate(rows):
        ids[r, t - n:] = torch.randint(3, vocab, (n,), generator=gen)
        mask[r, t - n:] = 1
    return ids, mask


def hf_model(cfg: ds.DeepseekV2Config, sd=None):
    """transformers' DeepseekV2Model of ``cfg`` without YaRN, eager
    attention; ``sd`` loaded strictly (the names are the schema)."""
    from transformers import DeepseekV2Config as HFConfig
    from transformers import DeepseekV2Model

    kw = {k: v for k, v in as_dict(cfg).items()
          if k not in ("rope_scaling", "model_type", "tie_word_embeddings")}
    hf_cfg = HFConfig(**kw, rope_scaling=None, attn_implementation="eager")
    torch.manual_seed(4)
    model = DeepseekV2Model(hf_cfg).eval()
    if sd is not None:
        model.load_state_dict(sd, strict=True)
    return model


def pooled(h, mask):
    m = mask.float()[..., None]
    return (h * m).sum(1) / m.sum(1)


def test_port_matches_the_plain_reference_with_yarn():
    cfg = tiny_cfg()
    assert ds.rope_inv_freq(cfg)[0].shape == (4,) and cfg.rope_scaling["type"] == "yarn"
    sd = seeded_state_dict(cfg)
    ids, mask = left_padded()
    model = ds.build_deepseek_v2(cfg, sd)
    with torch.no_grad():
        got = model(ids, mask)
        want = plain.hidden_states(sd, ids, mask, as_dict(cfg), precision.matmul)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], atol=TOL, rtol=TOL)
    tm = tlm.TextModel.native(cfg, sd, device="cpu")
    feats = tm.encode_ids(ids, mask)
    torch.testing.assert_close(feats, plain.features(sd, ids, mask, as_dict(cfg),
                                                     precision.matmul), atol=TOL, rtol=TOL)


def test_reference_matches_transformers_without_yarn():
    """An independent check of MLA, the MoE, the dense layer and the
    state-dict layout: the reference against HF's DeepseekV2Model."""
    cfg = tiny_cfg(rope_scaling=None)
    sd = seeded_state_dict(cfg, seed=1)
    model = hf_model(cfg, sd)
    ids, mask = left_padded(seed=5)
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = plain.hidden_states(sd, ids, mask, as_dict(cfg), precision.matmul)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], atol=TOL, rtol=TOL)
    torch.testing.assert_close(plain.features(sd, ids, mask, as_dict(cfg), precision.matmul),
                               pooled(want, mask), atol=TOL, rtol=TOL)


def test_yarn_frequencies_and_softmax_scale():
    from transformers import DeepseekV2Config as HFConfig
    from transformers.modeling_rope_utils import ROPE_INIT_FUNCTIONS

    lite = ds.DeepseekV2Config()
    hf_cfg = HFConfig(**{k: v for k, v in as_dict(lite).items()
                         if k not in ("model_type", "tie_word_embeddings")})
    want, factor = ROPE_INIT_FUNCTIONS["yarn"](hf_cfg, "cpu")
    got, scale = ds.rope_inv_freq(lite)
    torch.testing.assert_close(got, want, atol=0, rtol=1e-6)
    assert scale == pytest.approx(factor) == 1.0
    ref, ref_factor = plain.inv_freq(as_dict(lite), "cpu")
    assert torch.equal(got, ref) and ref_factor == scale
    # the blend changes the frequencies inside the correction range only
    plain_freq = 1.0 / 10000 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64)
    assert torch.equal(got[:10], plain_freq[:10])
    torch.testing.assert_close(got[23:], plain_freq[23:] / 40)
    # DeepSeek's softmax scale: 192^-1/2 x (0.1 x 0.707 x ln 40 + 1)^2
    assert ds.softmax_scale(lite) == pytest.approx(0.11472, abs=5e-6)
    assert ds.softmax_scale(lite) == pytest.approx(plain.scale(as_dict(lite)), rel=1e-12)
    assert ds.softmax_scale(tiny_cfg(rope_scaling=None)) == 24 ** -0.5
    cos, sin = ds.rope_tables(lite)
    assert cos.shape == (163840, 64)
    torch.testing.assert_close(cos[5, :32], torch.cos(5 * got))


def test_published_config_is_the_default():
    from port_bench import harness

    assert ds.DeepseekV2Config.from_dict(harness.config("deepseek_v2_lite")) == \
        ds.DeepseekV2Config()
    lite = ds.DeepseekV2Config()
    assert [lite.is_moe(i) for i in range(3)] == [False, True, True]


def _one_expert_gate(cfg):
    """An MoE layer whose gate sends every token to expert 0 (a large
    logit along a direction every row shares) and the other slot by the
    rows' own directions, with x [N, hidden] of that shape."""
    gen = torch.Generator().manual_seed(7)
    moe = ds.MoE(cfg)
    sd = {k.split("mlp.", 1)[1]: v for k, v in seeded_state_dict(cfg, 2).items()
          if k.startswith("layers.1.mlp.")}
    moe.load_state_dict(sd)
    u = torch.randn(cfg.hidden_size, generator=gen)
    u = u / u.norm()
    with torch.no_grad():
        moe.gate.weight[0] = 40 * u
    x = 3 * u + 0.5 * torch.randn(50, cfg.hidden_size, generator=gen)
    return moe, x


def test_no_token_is_dropped_when_one_expert_takes_them_all():
    cfg = tiny_cfg()
    moe, x = _one_expert_gate(cfg)
    _, sizes, _ = moe.route(x)
    assert sizes[0] == 50 and sum(sizes) == 50 * 2
    with torch.no_grad():
        got = moe(x[None], torch.float32)[0]
        want = []
        for t in range(50):
            scores = torch.softmax(moe.gate.weight @ x[t], dim=-1)
            w, idx = torch.topk(scores, 2)
            y = sum(wk * ds.swiglu(moe.experts[int(e)], x[t:t + 1], torch.float32)[0]
                    for wk, e in zip(w, idx))
            want.append(y + ds.swiglu(moe.shared_experts, x[t:t + 1], torch.float32)[0])
    torch.testing.assert_close(got, torch.stack(want), atol=1e-6, rtol=1e-5)


def test_pads_change_no_real_tokens_features():
    cfg = tiny_cfg()
    sd = seeded_state_dict(cfg, 3)
    tm = tlm.TextModel.native(cfg, sd, device="cpu")
    ids, mask = left_padded(seed=9)
    other = torch.where(mask.bool(), ids, torch.full_like(ids, 57))
    a, b = tm.encode_ids(ids, mask), tm.encode_ids(other, mask)
    # the pads route elsewhere, so each expert's product has other rows
    # around the real ones: equal up to the products' blocking
    torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    with torch.no_grad():
        ha, hb = tm.model(ids, mask), tm.model(other, mask)
    assert not torch.allclose(ha[~mask.bool()], hb[~mask.bool()])


def test_port_of_an_hf_state_dict_gives_hfs_hidden_state():
    cfg = tiny_cfg(rope_scaling=None)
    model = hf_model(cfg)
    with torch.no_grad():      # HF's init is N(0, 0.02): widen it to move the routing
        for p in model.parameters():
            if p.dim() == 2:
                p.mul_(8.0)
    sd = ds.port_hf_deepseek_v2(model.state_dict(), cfg)
    assert set(sd) == set(model.state_dict())
    ids, mask = left_padded(seed=11)
    with torch.no_grad():
        want = model(input_ids=ids, attention_mask=mask).last_hidden_state
        got = ds.build_deepseek_v2(cfg, sd)(ids, mask)
    real = mask.bool()
    torch.testing.assert_close(got[real], want[real], atol=TOL, rtol=TOL)


def _save_tiny_deepseek(d, cfg):
    """A seeded HF DeepseekV2Model and a word-level tokenizer (eos, no
    pad) saved to ``d``, whose name holds ``deepseek``."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import PreTrainedTokenizerFast

    hf_model(cfg, seeded_state_dict(cfg, 6)).save_pretrained(d)
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for i, w in enumerate(["a", "photo", "of", "cat", "dog", "the"]):
        vocab[w] = 3 + i
    tok = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(d)


def test_text_model_and_the_cli_adapter_load_a_local_checkpoint(tmp_path):
    from uml_tpu_torch.cli.features import _HFEncoderAdapter

    cfg = tiny_cfg(rope_scaling=None)
    d = str(tmp_path / "tiny-deepseek-v2")
    _save_tiny_deepseek(d, cfg)
    texts = ["a photo of cat", "the dog", "a photo of the dog"]
    tm = tlm.TextModel(d, device="cpu")
    assert tm.backend == "native" and isinstance(tm.model, ds.DeepseekV2Encoder)
    assert tm.tokenizer.pad_token == "</s>" and tm.hidden_size == 64
    assert tm.config == cfg
    got, _ = tm.encode(texts)
    batch = tm.tokenizer(texts, padding=True, return_tensors="pt")
    with torch.no_grad():
        h = hf_model(cfg, seeded_state_dict(cfg, 6))(**batch).last_hidden_state
    np.testing.assert_allclose(got, pooled(h, batch["attention_mask"]).numpy(),
                               atol=TOL, rtol=TOL)
    adapter = _HFEncoderAdapter(language_model=d, device="cpu")
    assert isinstance(adapter.text_model.model, ds.DeepseekV2Encoder)


class _Mesh:
    """What TextModel reads of a (data, model) mesh."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n_model):
        self.shape = (1, n_model)

    def size(self, dim):
        return self.shape[dim]


def test_deepseek_names_route_to_the_native_encoder_and_unsupported_modes_raise():
    assert tlm.MODEL_ALIASES["deepseek-v2-lite"] == "deepseek-ai/DeepSeek-V2-Lite"
    assert tlm.model_family("deepseek-ai/DeepSeek-V2-Lite") == "decoder"
    assert tlm.is_native("deepseek-ai/DeepSeek-V2-Lite") and tlm.is_native("mistral7b")
    assert not tlm.is_native("bert-base-uncased")
    cfg = tiny_cfg()
    sd = seeded_state_dict(cfg, 4)
    with pytest.raises(NotImplementedError, match="int8_w"):
        tlm.TextModel.native(cfg, sd, quant="int8_w", device="cpu")
    with pytest.raises(NotImplementedError, match="model"):
        tlm.TextModel.native(cfg, sd, device="cpu", mesh=_Mesh(2))
    ids, mask = left_padded(seed=13)
    one = tlm.TextModel.native(cfg, sd, device="cpu", mesh=_Mesh(1))
    assert torch.equal(one.encode_ids(ids, mask),
                       tlm.TextModel.native(cfg, sd, device="cpu").encode_ids(ids, mask))
    with pytest.raises(NotImplementedError, match="q_lora_rank"):
        ds.DeepseekV2Encoder(tiny_cfg(q_lora_rank=8))


def test_a_one_wide_model_axis_leaves_the_llama_encoder_unsharded():
    """ROADMAP M1: TextModel shards only over a ``model`` axis wider than
    1; under a one-wide one the LlamaEncoder is the plain one, bit for
    bit."""
    from uml_tpu_torch.models.llama import LlamaConfig, LlamaEncoder

    cfg = LlamaConfig(vocab_size=50, hidden_size=32, intermediate_size=48,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    sd = LlamaEncoder(cfg).init_random(torch.Generator().manual_seed(0)).state_dict()
    ids, mask = left_padded(seed=15, vocab=50)
    tm = tlm.TextModel.native(cfg, sd, device="cpu", mesh=_Mesh(1))
    assert not any("original" in n for n, _ in tm.model.named_parameters())
    assert torch.equal(tm.encode_ids(ids, mask),
                       tlm.TextModel.native(cfg, sd, device="cpu").encode_ids(ids, mask))


def test_counters_count_one_calls_launches_and_rows():
    cfg = tiny_cfg()
    tm = tlm.TextModel.native(cfg, seeded_state_dict(cfg, 5), device="cpu")
    ids, mask = left_padded(seed=17)
    seen = []
    route = ds.MoE.route

    def spy(self, x):
        out = route(self, x)
        seen.append(out[1])
        return out

    from uml_tpu_torch.ops.moe_gemm import moe_gemm, moe_gemm_plain

    def counts():
        return (moe_gemm_plain.launches, ds.routed_experts.rows,
                ds.routed_experts.busiest_rows, moe_gemm.launches)

    before = counts()
    ds.MoE.route = spy
    try:
        tm.encode_ids(ids, mask)
    finally:
        ds.MoE.route = route
    after = counts()
    assert len(seen) == 2                                   # layers 1 and 2
    assert after[0] - before[0] == sum(3 * sum(1 for n in s if n) for s in seen)
    assert after[1] - before[1] == 2 * ids.numel() * 2      # every token, top-2
    assert after[2] - before[2] == sum(max(s) for s in seen)
    assert after[3] == before[3]                            # no grouped launch on the CPU


def test_spans_name_mla_and_the_moes_phases():
    from torch.profiler import profile

    from uml_tpu_torch.utils.profiling import take_spans

    cfg = tiny_cfg()
    tm = tlm.TextModel.native(cfg, seeded_state_dict(cfg, 6), device="cpu")
    ids, mask = left_padded(seed=19)
    take_spans()
    with profile():
        tm.encode_ids(ids, mask)
    spans = take_spans()
    names = [s.name for s in spans]
    assert names.count("uml.text.encode") == 1
    assert names.count("uml.text.mla") == 3 and names.count("uml.text.moe") == 2
    for child in ("route", "experts", "shared"):
        assert names.count(f"uml.text.moe.{child}") == 2
    by_id = {s.id: s for s in spans}
    assert all(by_id[s.parent].name == "uml.text.moe" for s in spans
               if s.name.startswith("uml.text.moe."))
    tm.encode_ids(ids, mask)
    assert take_spans() == []                               # off outside a profiler


def test_the_grouped_kernels_wrapper_passes_its_shapes(monkeypatch):
    """``moe_gemm`` hands its C entry one argument per SIGNATURES entry:
    the experts, the row tiles the grid needs without the counts
    (ceil(R / 64) + G), N, K and the SwiGLU flag; it raises on what the
    kernel does not take (recorder in place of the C call, meta tensors)."""
    import contextlib
    import types

    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops import moe_gemm as mg

    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def meta(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta")

    a, offsets, table = meta(6840, 2048), meta(65, dtype=torch.int32), meta(64, dtype=torch.int64)
    counters = ("launches", "flops", "bytes", "weight_bytes", "tiles", "groups")
    before = [getattr(mg.moe_gemm, c) for c in counters]
    assert mg.moe_gemm(a, offsets, table, 1408, table).shape == (6840, 1408)
    assert mg.moe_gemm(meta(6840, 1408), offsets, table, 2048).shape == (6840, 2048)
    (n1, a1), (n2, a2) = calls
    assert n1 == n2 == "uml_moe_gemm"
    assert len(a1) == len(a2) == len(_build.SIGNATURES["uml_moe_gemm"])
    assert a1[5:10] == (64, 107 + 64, 1408, 2048, 1) and a2[5:10] == (64, 107 + 64, 2048, 1408, 0)
    assert a2[2] is None
    assert mg.moe_gemm.launches - before[0] == 2
    assert mg.moe_gemm.flops - before[1] == 2.0 * 6840 * 1408 * 2048 * 3
    assert mg.moe_gemm.bytes - before[2] == 4.0 * (64 * 1408 * 2048 * 3 + 2 * 6840 * (2048 + 1408))
    assert mg.moe_gemm.weight_bytes - before[3] == 4.0 * 64 * 1408 * 2048 * 3
    assert mg.moe_gemm.tiles - before[4] == 2 * (107 + 64)
    assert mg.moe_gemm.groups - before[5] == 2 * 64
    with pytest.raises(ValueError):         # N not a multiple of 128 without SwiGLU
        mg.moe_gemm(a, offsets, table, 1472)
    with pytest.raises(ValueError):         # offsets of another count
        mg.moe_gemm(a, meta(64, dtype=torch.int32), table, 1408, table)
    with pytest.raises(ValueError):
        mg.moe_gemm(torch.zeros(4, 16), torch.zeros(2, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int64), 64)


@pytest.mark.cuda
def test_the_grouped_kernel_matches_the_plain_version_on_the_card():
    """At DeepSeek-V2-Lite's widths (64 experts, K 2048, N 1408, SwiGLU,
    then the down product), uneven counts with empty experts and partial
    tiles: the kernel against ``moe_gemm_plain`` (cuBLAS, one product an
    expert).  Both sum float32 products, in other orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from uml_tpu_torch.ops import moe_gemm as mg

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    sizes = [0, 1, 63, 64, 65, 700, 0, 129] + [100] * 56
    r, k, m = sum(sizes), 2048, 1408
    a = torch.randn(r, k, device=dev, generator=gen)
    w1 = [torch.randn(m, k, device=dev, generator=gen) * k ** -0.5 for _ in sizes]
    w3 = [torch.randn(m, k, device=dev, generator=gen) * k ** -0.5 for _ in sizes]
    w2 = [torch.randn(k, m, device=dev, generator=gen) * m ** -0.5 for _ in sizes]
    offsets = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int32, device=dev)
    act = mg.moe_gemm(a, offsets, mg.expert_table(w1), m, mg.expert_table(w3))
    out = mg.moe_gemm(act, offsets, mg.expert_table(w2), k)
    want_act = mg.moe_gemm_plain(a, sizes, w1, w3)
    want = mg.moe_gemm_plain(want_act, sizes, w2)
    torch.cuda.synchronize()
    torch.testing.assert_close(act, want_act, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(out, mg.moe_gemm_plain(act, sizes, w2), atol=1e-5, rtol=1e-4)
    assert (out - want).norm() / want.norm() < 1e-5
