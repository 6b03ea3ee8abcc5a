"""The port's CLIP against uml_tpu's CLIP on the same weights (CPU).

A tiny ViT CLIP (width 128, 2 layers of 2 heads in each tower, patch 16,
resolution 64) is initialised in JAX; state_dict_from_jax carries its
weights into the port.  Tolerances: fp32 max abs error 1e-4 (same math,
other summation order); bf16 per-row cosine >= 0.999 (the two packages
round intermediates to bf16 at different points: uml_tpu's CPU path runs
the unfolded LN and keeps the attention scores in bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.models.clip import CLIP as JaxCLIP
from uml_tpu.models.clip import ClipConfig as JaxConfig
from uml_tpu.models.port_torch import port_clip_state_dict
from uml_tpu_torch.models.clip import CLIP, ClipConfig
from uml_tpu_torch.models.convert import state_dict_from_jax
from uml_tpu_torch.models.tokenizer import tokenize

TINY = dict(embed_dim=64, image_resolution=64, vision_layers=2,
            vision_width=128, vision_patch_size=16, transformer_width=128,
            transformer_heads=2, transformer_layers=2)
PROMPTS = ["a photo of a cat.", "a bad photo of the Boeing 737-800.", "x"]
FP32_ATOL = 1e-4
MIN_COSINE = 0.999
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_variables():
    model = JaxCLIP(JaxConfig(**TINY))
    v = jax.jit(model.init)(jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32),
                            jnp.zeros((1, 77), jnp.int32))
    return jax.tree.map(np.asarray, v)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (3, 64 * 64 * 3), dtype=np.uint8)
    return images, tokenize(PROMPTS)


def _models(variables, dtype):
    jdt, tdt = DTYPES[dtype]
    port = CLIP(ClipConfig(**TINY), dtype=tdt)
    port.load_state_dict(state_dict_from_jax(variables))
    return JaxCLIP(JaxConfig(**TINY), dtype=jdt), port


def _agree(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)
        return
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1)
                            * np.linalg.norm(w, axis=-1))
    assert cos.min() >= MIN_COSINE, cos.min()


def test_state_dict_round_trips_exactly(jax_variables):
    back = port_clip_state_dict(state_dict_from_jax(jax_variables))
    flat_a = jax.tree_util.tree_flatten_with_path(jax_variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), a)
    # and the port's module takes the state_dict with every key
    CLIP(ClipConfig(**TINY)).load_state_dict(state_dict_from_jax(jax_variables))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_encode_image_u8_matches(jax_variables, inputs, dtype, return_tokens):
    jmodel, port = _models(jax_variables, dtype)
    images, _ = inputs
    want = jmodel.apply(jax_variables, jnp.asarray(images),
                        method=lambda m, x: m.encode_image_u8(
                            x, return_tokens=return_tokens))
    with torch.no_grad():
        got = port.encode_image_u8(torch.from_numpy(images),
                                   return_tokens=return_tokens)
    _agree(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_encode_text_matches(jax_variables, inputs, dtype, return_tokens):
    jmodel, port = _models(jax_variables, dtype)
    _, tokens = inputs
    want, want_eot = jmodel.apply(
        jax_variables, jnp.asarray(tokens),
        method=lambda m, t: m.encode_text(t, return_eot=True,
                                          return_tokens=return_tokens))
    with torch.no_grad():
        got, eot = port.encode_text(torch.from_numpy(tokens.astype(np.int64)),
                                    return_eot=True,
                                    return_tokens=return_tokens)
    np.testing.assert_array_equal(eot.numpy(), np.asarray(want_eot))
    _agree(got, want, dtype)


def test_folded_weights_follow_load_state_dict(jax_variables, inputs):
    """The cached folded weights are rebuilt when the parameters change."""
    _, port = _models(jax_variables, "fp32")
    images, _ = inputs
    with torch.no_grad():
        before = port.encode_image_u8(torch.from_numpy(images))
        sd = state_dict_from_jax(jax_variables)
        sd["visual.transformer.resblocks.1.mlp.c_proj.weight"] *= 2
        port.load_state_dict(sd)
        after = port.encode_image_u8(torch.from_numpy(images))
    assert not torch.allclose(before, after)
