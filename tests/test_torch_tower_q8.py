"""The port's whole-tower int8 op (ops.tower_q8) against uml_tpu on the CPU.

L=2 layers at K=128, 2 heads of 64, M=512, S in {9, 17}; the weights are
folded and quantized once in numpy-fed JAX, and both packages run on
those same pre-quantized integers.  Tolerances:

* tower_q8_plain against uml_tpu's tower_q8_reference: max |port - ref|
  <= 2^-5 * max|ref|, twice the bound of one half-block: the tower
  composes four, and each carries the reference's bf16 attention scores
  (the port keeps fp32 ones) and a jitted scan, whose fp32 contraction
  flips quantization ties (uml_tpu's own tower test holds 2e-2 for that);
  measured 1.4-2.0e-2 over 8 seeds and shapes;
* tower_q8_plain against the port's own per-layer path
  (ln_attn_block_q8 + ln_mlp_block_q8 from the raw parameters): equal,
  element for element (the same fold, integers and rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import quant as jq
from uml_tpu.ops.fused_attention import fold_ln_into_matmul as jax_fold
from uml_tpu.ops.tower_q8 import tower_q8_reference
from uml_tpu_torch.ops import quant as tq
from uml_tpu_torch.ops import tower_q8 as tt

K, HEADS, M, B, LAYERS = 128, 2, 512, 2, 2
REL = 2.0 ** -5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _layers(seed):
    """Raw per-layer parameters as numpy arrays: fp32 LN / QKV / c_fc,
    bf16-valued out_proj / c_proj (the model casts those first)."""
    rng = np.random.default_rng(seed)

    def bf(a):
        return np.array(jnp.asarray(jnp.asarray(a, jnp.bfloat16), jnp.float32))

    f32 = np.float32
    return [dict(
        scale=(1 + 0.1 * rng.standard_normal(K)).astype(f32),
        bias=(0.05 * rng.standard_normal(K)).astype(f32),
        w=(rng.standard_normal((K, 3 * K)) * K ** -0.5).astype(f32),
        kb=(0.02 * rng.standard_normal(3 * K)).astype(f32),
        wo=bf(rng.standard_normal((K, K)) * K ** -0.5),
        bo=(0.02 * rng.standard_normal(K)).astype(f32),
        scale2=(1 + 0.1 * rng.standard_normal(K)).astype(f32),
        bias2=(0.05 * rng.standard_normal(K)).astype(f32),
        w1=(rng.standard_normal((K, M)) * K ** -0.5).astype(f32),
        b1=(0.02 * rng.standard_normal(M)).astype(f32),
        w2=bf(rng.standard_normal((M, K)) * M ** -0.5),
        b2=(0.02 * rng.standard_normal(K)).astype(f32),
    ) for _ in range(LAYERS)]


def _stack_q8(layers):
    """uml_tpu's collect path: fold in fp32, quantize, stack per layer."""
    q8 = []
    for p in layers:
        w_eff, b_eff = jax_fold(p["scale"], p["bias"], jnp.asarray(p["w"]),
                                p["kb"])
        w1_eff, b1_eff = jax_fold(p["scale2"], p["bias2"],
                                  jnp.asarray(p["w1"]), p["b1"])
        q8.append((*jq.quantize_weight(w_eff), b_eff,
                   *jq.quantize_weight(jnp.asarray(p["wo"])), p["bo"],
                   *jq.quantize_weight(w1_eff), b1_eff,
                   *jq.quantize_weight(jnp.asarray(p["w2"])), p["b2"]))
    return [np.stack([np.asarray(a) for a in t]) for t in zip(*q8)]


def _x(seed, s):
    x = np.random.default_rng(seed).standard_normal((B, s, K)) * 0.5
    return jnp.asarray(x, jnp.bfloat16)


def _torch_x(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("s", [9, 17])
def test_plain_matches_reference(s):
    x = _x(0, s)
    stacked = _stack_q8(_layers(1))
    want = np.asarray(jnp.asarray(
        tower_q8_reference(x, *(jnp.asarray(a) for a in stacked),
                           heads=HEADS), jnp.float32))
    n = tt.tower_q8.launches
    got = tt.tower_q8(_torch_x(x), *(torch.from_numpy(a) for a in stacked),
                      heads=HEADS)
    assert tt.tower_q8.launches == n                 # the CPU runs no kernel
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * np.abs(want).max()


@pytest.mark.parametrize("s", [9, 17])
def test_plain_equals_the_per_layer_path(s):
    layers = _layers(2)
    x = _torch_x(_x(3, s))
    t = [{k: torch.from_numpy(v) for k, v in p.items()} for p in layers]
    ref = x
    for p in t:
        ref = tq.ln_attn_block_q8(ref, p["scale"], p["bias"], p["w"], p["kb"],
                                  p["wo"].to(torch.bfloat16), p["bo"],
                                  heads=HEADS)
        ref = tq.ln_mlp_block_q8(ref, p["scale2"], p["bias2"], p["w1"],
                                 p["b1"], p["w2"].to(torch.bfloat16), p["b2"],
                                 activation="quick_gelu")
    got = tt.tower_q8_plain(x, *(torch.from_numpy(a) for a in _stack_q8(layers)),
                            heads=HEADS)
    assert torch.equal(got, ref)


def test_supports_gate():
    assert tt.supports_tower_q8(768, 12, 64, 197, 3072)      # ViT-B/16
    assert not tt.supports_tower_q8(768, 12, 32, 197, 3072)  # head dim 32
    assert not tt.supports_tower_q8(760, 12, 64, 197, 3072)  # K % 64
    # any S: the attention streams K/V (ViT-L/14 at 336 px, S = 577)
    assert tt.supports_tower_q8(768, 12, 64, 577, 3072)
