"""The attention halves' plain versions and the text tower's at head dim
32 (hidden 64, 2 heads) against uml_tpu's jnp twins on the CPU.

uml_tpu's plain versions take any head dim; so do the port's: they read it
from the weights (``w_eff.shape[1] // (3 * heads)``).  The CUDA kernels
take head dim 64 only, and their wrappers raise for any other on a CUDA
tensor (tests/test_torch_cuda.py::test_kernels_raise_at_head_dim_32).

Tolerances, as tests/test_torch_ops.py and tests/test_torch_train_ops.py
hold head dim 64: fp32 1e-4 (atol = rtol for the gradients); bf16 2^-6 of
the largest entry; the int8 half 2^-5 of the largest entry
(tests/test_torch_quant.py's REL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import quant as jq
from uml_tpu.ops import text_tower as jtt
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import quant as tq
from uml_tpu_torch.ops import text_tower as ttt

K, HEADS, B, S = 64, 2, 2, 9          # head dim 32
M = 4 * K
FP32_TOL = 1e-4
BF16_REL = 2.0 ** -6
Q8_REL = 2.0 ** -5
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
MATRICES = ("x", "g", "w_eff", "wo", "w1", "w2")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arrays(seed, layers=None, g_rows=S):
    rng = np.random.default_rng(seed)
    lead = () if layers is None else (layers,)

    def rnd(*shape, std=1.0, stack=True):
        return (std * rng.standard_normal((lead if stack else ()) + shape)
                ).astype(np.float32)

    return dict(x=rnd(B, S, K, stack=False), g=rnd(B, g_rows, K, stack=False),
                w_eff=rnd(K, 3 * K, std=K ** -0.5), b_eff=rnd(3 * K, std=0.1),
                wo=rnd(K, K, std=K ** -0.5), bo=rnd(K, std=0.1),
                w1=rnd(K, M, std=K ** -0.5), b1=rnd(M, std=0.1),
                w2=rnd(M, K, std=M ** -0.5), b2=rnd(K, std=0.1))


def _both(arrays, dtype):
    jdt, tdt = DTYPES[dtype]
    j = {n: jnp.asarray(a, jdt if n in MATRICES else jnp.float32)
         for n, a in arrays.items()}
    t = {n: torch.tensor(a).to(tdt if n in MATRICES else torch.float32)
         for n, a in arrays.items()}
    return j, t


def _close(got, want, dtype, rel=BF16_REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= rel * np.abs(want).max(), err


def _attn(w):
    return w["w_eff"], w["b_eff"], w["wo"], w["bo"]


def _twin(w, causal, rows=None):
    out = jfa._raw_block_reference(w["x"], *_attn(w), heads=HEADS, causal=causal,
                                   eps=1e-5)
    return out if rows is None else out[:, :rows]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_half_forwards_match_the_twin(dtype, causal):
    jw, tw = _both(_arrays(1), dtype)
    want = _twin(jw, causal)
    _close(tfa.attn_block_plain(tw["x"], *_attn(tw), heads=HEADS, causal=causal),
           want, dtype)
    out, qkv, attn = tfa.attn_block_stash_plain(tw["x"], *_attn(tw), heads=HEADS,
                                                causal=causal)
    _close(out, want, dtype)
    assert qkv.shape == (B, S, 3 * K) and attn.shape == (B, S, K)
    if not causal:
        _close(tfa.attn_block_cls_plain(tw["x"], *_attn(tw), heads=HEADS),
               _twin(jw, False, rows=1), dtype)


def _vjp(jw, causal, rows=None):
    _, vjp = jax.vjp(lambda *a: jfa._raw_block_reference(
        *a, heads=HEADS, causal=causal, eps=1e-5)[:, :rows or S],
        jw["x"], *_attn(jw))
    return vjp(jw["g"])


@pytest.mark.parametrize("causal", [False, True])
def test_attention_backwards_match_the_twin_vjp(causal):
    """The stash backward and the recompute backward, fp32: dx and the
    parameter gradients against jax.vjp of the twin."""
    jw, tw = _both(_arrays(2), "fp32")
    want = _vjp(jw, causal)
    _, qkv, attn = tfa.attn_block_stash_plain(tw["x"], *_attn(tw), heads=HEADS,
                                              causal=causal)
    dx, dqkv, xn = tfa.attn_block_bwd_plain(tw["x"], tw["g"], qkv, tw["w_eff"],
                                            tw["wo"], heads=HEADS, causal=causal)
    for got, w in zip((dx, *tfa._param_grads(xn, dqkv, attn, tw["g"], *_attn(tw))),
                      want):
        _close(got, w, "fp32")
    dx2, dqkv2, xn2, attn2 = tfa.attn_block_bwd_recompute_plain(
        tw["x"], tw["g"], *_attn(tw)[:3], heads=HEADS, causal=causal)
    for got, w in zip((dx2, *tfa._param_grads(xn2, dqkv2, attn2, tw["g"],
                                              *_attn(tw))), want):
        _close(got, w, "fp32")


def test_cls_backwards_match_the_twin_vjp():
    """The CLS backward, dense and in the rank-2H factored form, fp32,
    against jax.vjp of row 0 of the twin."""
    jw, tw = _both(_arrays(3, g_rows=1), "fp32")
    want = _vjp(jw, False, rows=1)
    _, qkv, attn = tfa.attn_block_stash_plain(tw["x"], *_attn(tw), heads=HEADS,
                                              q_rows=1)
    for bwd in (tfa.attn_block_cls_bwd_plain, tfa.attn_block_cls_bwd_factored_plain):
        dx, dqkv, xn = bwd(tw["x"], tw["g"], qkv, tw["w_eff"], tw["wo"], heads=HEADS)
        for got, w in zip((dx, *tfa._param_grads(xn, dqkv, attn, tw["g"],
                                                 *_attn(tw))), want):
            _close(got, w, "fp32")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_text_tower_matches_the_twin(dtype):
    jw, tw = _both(_arrays(4, layers=2), dtype)
    order = ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2")
    got = ttt.text_tower_plain(tw["x"], *(tw[n] for n in order), heads=HEADS)
    want = jtt.text_tower_reference(jw["x"], *(jw[n] for n in order), heads=HEADS)
    _close(got, want, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q8_out", [True, False])
def test_int8_attention_half_matches_the_twin(causal, q8_out):
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal((B, S, K)) * 0.5, jnp.bfloat16)
    scale = jnp.asarray(1 + 0.1 * rng.standard_normal(K), jnp.float32)
    bias = jnp.asarray(0.05 * rng.standard_normal(K), jnp.float32)
    w = jnp.asarray(rng.standard_normal((K, 3 * K)) * K ** -0.5, jnp.float32)
    kb = jnp.asarray(0.02 * rng.standard_normal(3 * K), jnp.float32)
    wo = jnp.asarray(rng.standard_normal((K, K)) * K ** -0.5, jnp.bfloat16)
    bo = jnp.asarray(0.02 * rng.standard_normal(K), jnp.float32)
    ref = (jq.ln_attn_block_q8_reference if q8_out
           else jq.ln_attn_block_q8qkv_reference)
    want = ref(x, scale, bias, w, kb, wo, bo, heads=HEADS, causal=causal)

    def t(a):
        return torch.tensor(np.asarray(jnp.asarray(a, jnp.float32))).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)

    got = tq.ln_attn_block_q8(t(x), t(scale), t(bias), t(w), t(kb), t(wo), t(bo),
                              heads=HEADS, causal=causal, q8_out=q8_out)
    _close(got, want, "bf16", Q8_REL)
