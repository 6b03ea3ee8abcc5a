"""The port's CLIP in the int8 serving modes against uml_tpu's (CPU).

The tiny ViT CLIP of tests/test_torch_clip.py (width 128, 2 layers of 2
heads in each tower, patch 16, resolution 64), initialised in JAX and
carried into the port by state_dict_from_jax, runs in bf16 with
quant in {int8, int8_mlp, int8_attn, int8_qkv} in both packages.
Tolerances, per-row cosine of the features:

* port vs uml_tpu, same mode: >= 0.999 (both run the simulated-int8
  math; they differ where the packages round intermediates to bf16 at
  other points, and a quantization tie then flips an integer);
* port int8 vs port bf16: > 0.995, the bound uml_tpu's
  test_clip_int8_feature_fidelity holds itself to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.models.clip import CLIP as JaxCLIP
from uml_tpu.models.clip import ClipConfig as JaxConfig
from uml_tpu_torch.models.clip import CLIP, ClipConfig, build_clip
from uml_tpu_torch.models.convert import state_dict_from_jax
from uml_tpu_torch.models.tokenizer import tokenize
from uml_tpu_torch.ops import text_tower as tt
from uml_tpu_torch.ops import tower_q8 as tw

TINY = dict(embed_dim=64, image_resolution=64, vision_layers=2,
            vision_width=128, vision_patch_size=16, transformer_width=128,
            transformer_heads=2, transformer_layers=2)
MODES = ["int8", "int8_mlp", "int8_attn", "int8_qkv"]
PROMPTS = ["a photo of a cat.", "a bad photo of the Boeing 737-800.", "x"]
MIN_COSINE = 0.999
MIN_COSINE_VS_BF16 = 0.995


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    v = jax.jit(JaxCLIP(JaxConfig(**TINY)).init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3), jnp.float32),
        jnp.zeros((1, 77), jnp.int32))
    v = jax.tree.map(np.asarray, v)
    images = np.random.default_rng(0).integers(0, 256, (4, 64 * 64 * 3),
                                               dtype=np.uint8)
    return v, images, tokenize(PROMPTS)


def _port(v, quant):
    model = CLIP(ClipConfig(**TINY), dtype=torch.bfloat16, quant=quant)
    model.load_state_dict(state_dict_from_jax(v))
    return model


def _encode(model, images, tokens):
    with torch.no_grad():
        return (model.encode_image_u8(torch.from_numpy(images)).float().numpy(),
                model.encode_text(torch.from_numpy(tokens.astype(np.int64)))
                .float().numpy())


def _cos_min(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return ((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                               * np.linalg.norm(b, axis=-1))).min()


@pytest.mark.parametrize("quant", MODES)
def test_features_match_uml_tpu(setup, quant):
    v, images, tokens = setup
    jmodel = JaxCLIP(JaxConfig(**TINY), dtype=jnp.bfloat16, quant=quant)
    want_img = jmodel.apply(v, jnp.asarray(images),
                            method=lambda m, x: m.encode_image_u8(x))
    want_txt = jmodel.apply(v, jnp.asarray(tokens),
                            method=lambda m, t: m.encode_text(t))
    n_text = tt.text_tower.launches
    got_img, got_txt = _encode(_port(v, quant), images, tokens)
    assert tt.text_tower.launches == n_text
    assert got_img.shape == want_img.shape and got_txt.shape == want_txt.shape
    assert _cos_min(got_img, want_img) >= MIN_COSINE
    assert _cos_min(got_txt, want_txt) >= MIN_COSINE


@pytest.mark.parametrize("quant", MODES)
def test_int8_stays_near_bf16(setup, quant):
    v, images, tokens = setup
    bf16 = _encode(_port(v, "none"), images, tokens)
    q8 = _encode(_port(v, quant), images, tokens)
    for a, b in zip(q8, bf16):
        assert _cos_min(a, b) > MIN_COSINE_VS_BF16


@pytest.mark.parametrize("return_tokens", [False, True])
def test_tower_q8_equals_the_per_layer_path(setup, monkeypatch, return_tokens):
    """UML_TOWER_Q8=1 runs the full int8 image layers through tower_q8
    (the CLS layer after it in bf16); on the CPU both compose the same
    plain halves, so the features are equal."""
    v, images, _ = setup
    model = _port(v, "int8")
    u8 = torch.from_numpy(images)
    with torch.no_grad():
        monkeypatch.setenv("UML_TOWER_Q8", "0")
        base = model.encode_image_u8(u8, return_tokens=return_tokens)
        monkeypatch.setenv("UML_TOWER_Q8", "1")
        calls = []
        monkeypatch.setattr("uml_tpu_torch.models.clip.tower_q8",
                            lambda *a, **k: calls.append(1) or tw.tower_q8(*a, **k))
        towered = model.encode_image_u8(u8, return_tokens=return_tokens)
    assert calls == [1]
    assert torch.equal(towered, base)


@pytest.mark.parametrize("quant", MODES)
def test_quant_modes_raise_under_autograd(setup, quant):
    v, images, tokens = setup
    model = _port(v, quant)
    with pytest.raises(RuntimeError, match="inference-only"):
        model.encode_image_u8(torch.from_numpy(images))
    with pytest.raises(RuntimeError, match="inference-only"):
        model.encode_text(torch.from_numpy(tokens.astype(np.int64)))


def test_unknown_quant_mode_raises():
    with pytest.raises(ValueError, match="quant"):
        build_clip("ViT-B/16", quant="int4")


def test_quantized_weights_follow_load_state_dict(setup):
    """The cached int8 weights are rebuilt when the parameters change."""
    v, images, _ = setup
    model = _port(v, "int8")
    u8 = torch.from_numpy(images)
    with torch.no_grad():
        before = model.encode_image_u8(u8)
        sd = state_dict_from_jax(v)
        sd["visual.transformer.resblocks.0.mlp.c_proj.weight"] *= 2
        model.load_state_dict(sd)
        after = model.encode_image_u8(u8)
    assert not torch.allclose(before, after)


def _k_major_want(block, dtype):
    """quantize_weight(w)[0].t() of each int8 weight the layer quantizes:
    the LN-folded fp32 QKV and c_fc weights, out_proj and c_proj cast to
    the compute dtype, all in the [in, out] layout."""
    from uml_tpu_torch.ops.fused_attention import fold_ln_into_matmul
    from uml_tpu_torch.ops.quant import quantize_weight

    w_eff, _ = fold_ln_into_matmul(block.ln_1.weight, block.ln_1.bias,
                                   block.attn.in_proj_weight.t(),
                                   block.attn.in_proj_bias)
    w1_eff, _ = fold_ln_into_matmul(block.ln_2.weight, block.ln_2.bias,
                                    block.mlp.c_fc.weight.t(), block.mlp.c_fc.bias)
    return [quantize_weight(w)[0].t() for w in
            (w_eff, block.attn.out_proj.weight.to(dtype).t(), w1_eff,
             block.mlp.c_proj.weight.to(dtype).t())]


INT8_SLOTS = (0, 3, 6, 9)   # wq, woq, w1q, w2q in quantized()'s tuple


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_cached_int8_weights_are_k_major(setup, tower):
    """The per-layer cache holds each int8 weight once, K-major ([out, in]
    contiguous, what the card's int8 GEMM reads), equal bit for bit to the
    transpose of quantize_weight's [in, out] integers; the forward hands
    the ops [in, out] views of it."""
    v, _, _ = setup
    model = _port(v, "int8")
    blocks = (model.visual.transformer if tower == "visual"
              else model.transformer).resblocks
    with torch.no_grad():
        for block in blocks:
            cached = block.quantized(torch.bfloat16)
            want = _k_major_want(block, torch.bfloat16)
            for slot, w in zip(INT8_SLOTS, want):
                got = cached[slot]
                assert got.dtype == torch.int8 and got.is_contiguous()
                assert torch.equal(got, w), slot
            assert block.quantized(torch.bfloat16)[0] is cached[0]   # cached


def test_stacked_int8_weights_are_k_major(setup):
    """tower_q8's stacked operands: each int8 weight [L, out, in]
    contiguous, layer l equal to the per-layer cache's bit for bit."""
    v, _, _ = setup
    model = _port(v, "int8")
    tower = model.visual.transformer
    with torch.no_grad():
        stacked = tower.stacked_q8(torch.bfloat16, len(tower.resblocks))
        for slot in INT8_SLOTS:
            assert stacked[slot].is_contiguous()
            for l, block in enumerate(tower.resblocks):
                want = _k_major_want(block, torch.bfloat16)[INT8_SLOTS.index(slot)]
                assert torch.equal(stacked[slot][l], want), (slot, l)
