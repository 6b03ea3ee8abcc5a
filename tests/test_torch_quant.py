"""The port's int8 (W8A8) ops against uml_tpu.ops.quant on the CPU.

Small shapes: K=128, 2 heads of 64, M=512, S in {9, 17}, and the int8
attention half also at the m64 edges of the fused QKV + attention kernel,
S in {64, 65, 129, 197}; inputs from a numpy seed, handed to both
packages.  Tolerances:

* quantize_weight: integers and scales bit for bit (the same elementwise
  fp32 math on the same fp32 weights).
* the row quantizers: integers equal except one step on at most 0.1% of
  the entries, scales within rtol 1e-6 (the row mean and E[x^2] are summed
  in another order, which moves a value sitting on a .5 tie).
* the plain half-blocks against uml_tpu's jnp references, bf16:
  max |port - ref| <= 2^-6 * max|ref| (two bf16 ulps of the largest
  output; beyond the tie flips above, the port's attention keeps fp32
  scores where the reference stores them in bf16).
* against the Pallas kernels in interpret mode (heavy): <= 3e-2 * max|ref|
  for the attention half, 2e-2 for the MLP half, the bounds uml_tpu's own
  kernel-vs-reference tests state: the Pallas kernel drops the k-bias,
  adds the v-bias after the softmax, runs a max-free exp2 softmax and
  quantizes its fp32 attention output (the port quantizes the bf16 one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import quant as jq
from uml_tpu.ops.fused_attention import fold_ln_into_matmul as jax_fold
from uml_tpu.ops.ln_matmul import _ACTIVATIONS
from uml_tpu_torch.ops import quant as tq

K, HEADS, M, B = 128, 2, 512, 2
REL = 2.0 ** -6
FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _params(seed, s):
    """x bf16 [B,S,K]; LN scale/bias; fp32 QKV and c_fc kernels; bf16
    out_proj and c_proj (the dtypes the model hands the int8 ops)."""
    rng = np.random.default_rng(seed)
    bf = jnp.bfloat16
    return dict(
        x=jnp.asarray(rng.standard_normal((B, s, K)) * 0.5, bf),
        scale=jnp.asarray(1 + 0.1 * rng.standard_normal(K), jnp.float32),
        bias=jnp.asarray(0.05 * rng.standard_normal(K), jnp.float32),
        w=jnp.asarray(rng.standard_normal((K, 3 * K)) * K ** -0.5, jnp.float32),
        kb=jnp.asarray(0.02 * rng.standard_normal(3 * K), jnp.float32),
        wo=jnp.asarray(rng.standard_normal((K, K)) * K ** -0.5, bf),
        bo=jnp.asarray(0.02 * rng.standard_normal(K), jnp.float32),
        w1=jnp.asarray(rng.standard_normal((K, M)) * K ** -0.5, jnp.float32),
        b1=jnp.asarray(0.02 * rng.standard_normal(M), jnp.float32),
        w2=jnp.asarray(rng.standard_normal((M, K)) * M ** -0.5, bf),
        b2=jnp.asarray(0.02 * rng.standard_normal(K), jnp.float32),
    )


def _torch(p):
    """The same arrays as torch tensors (bf16 stays bf16)."""
    out = {}
    for k, v in p.items():
        t = _t(_np(v))
        out[k] = t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    return out


def _assert_ints_close(got, want):
    got = got.numpy().astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= FLIP_SHARE, (diff > 0).mean()


def _assert_rel(got, want, bound):
    got = got.float().numpy()
    want = _np(want).astype(np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("shape", [(K, 3 * K), (M, K)])
def test_quantize_weight_bit_for_bit(shape):
    w = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    q, s = tq.quantize_weight(_t(w))
    jq_, js = jq.quantize_weight(jnp.asarray(w))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("which", ["ln", "rows", "quick_gelu", "gelu_exact",
                                   "identity"])
def test_row_quantizers_match(which):
    rng = np.random.default_rng(1)
    width = K if which in ("ln", "rows") else M
    xf = (rng.standard_normal((B * 17, width)) * 2.0).astype(np.float32)
    if which == "ln":
        (q, s), (jq_, js) = (tq.ln_quantize_rows(_t(xf), 1e-5),
                             jq._ln_quantize_rows(jnp.asarray(xf), 1e-5))
    elif which == "rows":
        (q, s), (jq_, js) = (tq.quantize_rows(_t(xf)),
                             jq._quantize_rows(jnp.asarray(xf)))
    else:
        act = None if which == "identity" else which
        (q, s), (jq_, js) = (tq.act_quantize_rows(_t(xf), act),
                             jq._act_quantize_rows(jnp.asarray(xf), act,
                                                   _ACTIVATIONS))
    assert q.dtype == torch.int8 and s.shape == (B * 17, 1)
    _assert_ints_close(q, jq_)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)


def test_rounding_is_half_up():
    """Exact .5 ties go up (torch.round would send 0.5 to 0 and 2.5 to 2)."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5]],
                   np.float32)                       # scale = 127 / 127 = 1
    q, s = tq.quantize_rows(_t(row))
    assert float(s) == 1.0
    np.testing.assert_array_equal(q.numpy(), [[127, 1, 2, 3, 0, -1, -2, 127]])
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq._quantize_rows(
        jnp.asarray(row))[0]))
    qw, _ = tq.quantize_weight(_t(row.T))
    np.testing.assert_array_equal(qw.numpy().T, q.numpy())


def test_zero_rows_are_safe():
    z = torch.zeros(3, K)
    for q, s in (tq.quantize_rows(z), tq.ln_quantize_rows(z, 1e-5),
                 tq.act_quantize_rows(z, "quick_gelu")):
        assert torch.all(q == 0) and torch.isfinite(s).all()
    q, s = tq.quantize_weight(z)
    assert torch.all(q == 0) and torch.isfinite(s).all()


def test_q8_dot_is_exact_past_fp32():
    """127 * 127 * 3072 is past 2^24: the product is exact (float64)."""
    k = 3072
    xq = torch.full((2, k), 127, dtype=torch.int8)
    wq = torch.full((k, 4), 127, dtype=torch.int8)
    wq[0, 0] = 126             # exact sum 127^2 k - 127: fp32 spacing is 4 here
    one = torch.ones(1)
    acc = tq.q8_dot(xq, one[:, None].expand(2, 1), wq, one.expand(4))
    assert acc[0, 0].item() == float(np.float32(127 * 127 * k - 127))
    assert acc[0, 1].item() == float(127 * 127 * k)


@pytest.mark.parametrize("s", [9, 17])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q8_out", [True, False])
def test_attn_half_matches_reference(s, causal, q8_out):
    p = _params(2, s)
    t = _torch(p)
    ref_fn = (jq.ln_attn_block_q8_reference if q8_out
              else jq.ln_attn_block_q8qkv_reference)
    want = ref_fn(p["x"], p["scale"], p["bias"], p["w"], p["kb"], p["wo"],
                  p["bo"], heads=HEADS, causal=causal)
    n = tq.attn_block_q8.launches
    got = tq.ln_attn_block_q8(t["x"], t["scale"], t["bias"], t["w"], t["kb"],
                              t["wo"], t["bo"], heads=HEADS, causal=causal,
                              q8_out=q8_out)
    assert tq.attn_block_q8.launches == n          # the CPU runs no kernel
    assert got.dtype == torch.bfloat16
    _assert_rel(got, want, REL)


@pytest.mark.parametrize("s", [64, 65, 129, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_half_matches_reference_at_tile_edges(s, causal):
    p = _params(7, s)
    t = _torch(p)
    want = jq.ln_attn_block_q8_reference(p["x"], p["scale"], p["bias"], p["w"],
                                         p["kb"], p["wo"], p["bo"], heads=HEADS,
                                         causal=causal)
    got = tq.ln_attn_block_q8(t["x"], t["scale"], t["bias"], t["w"], t["kb"],
                              t["wo"], t["bo"], heads=HEADS, causal=causal)
    _assert_rel(got, want, REL)


@pytest.mark.heavy
@pytest.mark.parametrize("s", [64, 65, 129, 197])
def test_attn_half_matches_pallas_interpret_at_tile_edges(s):
    p = _params(8, s)
    (wq, wsc), b_eff, (woq, wosc), _, _, _ = _prequantized(p)
    want = jq._block_q8_fwd(p["x"], wq, wsc, b_eff, (woq, wosc), p["bo"], 1e-5,
                            HEADS, 64, False, True, q8_out=True)
    got = tq.attn_block_q8(_torch(p)["x"], _t(wq), _t(wsc), _t(b_eff),
                           (_t(woq), _t(wosc)), _t(p["bo"]), heads=HEADS)
    _assert_rel(got, want, 3e-2)


@pytest.mark.parametrize("s", [9, 17])
def test_mlp_half_matches_reference(s):
    p = _params(3, s)
    t = _torch(p)
    want = jq.ln_mlp_block_q8_reference(
        p["x"], p["scale"], p["bias"], p["w1"], p["b1"], p["w2"], p["b2"],
        activation="quick_gelu")
    got = tq.ln_mlp_block_q8(t["x"], t["scale"], t["bias"], t["w1"], t["b1"],
                             t["w2"], t["b2"], activation="quick_gelu")
    _assert_rel(got, want, REL)


@pytest.mark.parametrize("s", [9, 17])
def test_mlp_half_gelu_exact_matches_reference(s):
    """DINO's int8 MLP half (exact GELU) against uml_tpu's jnp reference."""
    p = _params(13, s)
    t = _torch(p)
    want = jq.ln_mlp_block_q8_reference(
        p["x"], p["scale"], p["bias"], p["w1"], p["b1"], p["w2"], p["b2"],
        eps=1e-6, activation="gelu_exact")
    got = tq.ln_mlp_block_q8(t["x"], t["scale"], t["bias"], t["w1"], t["b1"],
                             t["w2"], t["b2"], eps=1e-6, activation="gelu_exact")
    _assert_rel(got, want, REL)


def test_mlp_half_without_activation_raises():
    """uml_tpu's default activation (None, the identity) needs each row's
    abs-max for the int8 hidden: not ported, so the wrapper raises, off the
    card too (and ln_mlp_block_q8's default with it); the plain version
    still computes it."""
    p = _torch(_params(14, 9))
    with pytest.raises(ValueError, match="ROADMAP"):
        tq.ln_mlp_block_q8(p["x"], p["scale"], p["bias"], p["w1"], p["b1"],
                           p["w2"], p["b2"])
    w1q, w1sc = tq.quantize_weight(p["w1"])
    w2q, w2sc = tq.quantize_weight(p["w2"])
    with pytest.raises(ValueError, match="ROADMAP"):
        tq.mlp_block_q8(p["x"], w1q, w1sc, p["b1"], w2q, w2sc, p["b2"],
                        activation=None)
    out = tq.mlp_block_q8_plain(p["x"], w1q, w1sc, p["b1"], w2q, w2sc, p["b2"],
                                activation=None)
    assert torch.isfinite(out.float()).all()


def _prequantized(p):
    w_eff, b_eff = jax_fold(p["scale"], p["bias"], p["w"], p["kb"])
    w1_eff, b1_eff = jax_fold(p["scale"], p["bias"], p["w1"], p["b1"])
    return (jq.quantize_weight(w_eff), b_eff, jq.quantize_weight(p["wo"]),
            jq.quantize_weight(w1_eff), b1_eff, jq.quantize_weight(p["w2"]))


@pytest.mark.heavy
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q8_out", [True, False])
def test_attn_half_matches_pallas_interpret(causal, q8_out):
    p = _params(4, 17)
    (wq, wsc), b_eff, (woq, wosc), _, _, _ = _prequantized(p)
    wo_ops = (woq, wosc) if q8_out else (p["wo"],)
    want = jq._block_q8_fwd(p["x"], wq, wsc, b_eff, wo_ops, p["bo"], 1e-5,
                            HEADS, 64, causal, True, q8_out=q8_out)
    got = tq.attn_block_q8(
        _torch(p)["x"], _t(wq), _t(wsc), _t(b_eff),
        tuple(_t(_np(w)).to(torch.bfloat16) if w.dtype == jnp.bfloat16
              else _t(w) for w in wo_ops),
        _t(p["bo"]), heads=HEADS, causal=causal, q8_out=q8_out)
    _assert_rel(got, want, 3e-2)


@pytest.mark.heavy
def test_mlp_half_matches_pallas_interpret():
    p = _params(5, 17)
    _, _, _, (w1q, w1sc), b1_eff, (w2q, w2sc) = _prequantized(p)
    want = jq._mlp_q8_fwd(p["x"], w1q, w1sc, b1_eff, w2q, w2sc, p["b2"], 1e-5,
                          "quick_gelu", True)
    got = tq.mlp_block_q8(_torch(p)["x"], _t(w1q), _t(w1sc), _t(b1_eff),
                          _t(w2q), _t(w2sc), _t(p["b2"]))
    _assert_rel(got, want, 2e-2)


@pytest.mark.heavy
def test_mlp_half_gelu_exact_matches_pallas_interpret():
    """Against the Pallas kernel in interpret mode, whose GELU is the
    sigmoid-quintic fit (2e-2, the bound of the quick_gelu case)."""
    p = _params(15, 17)
    _, _, _, (w1q, w1sc), b1_eff, (w2q, w2sc) = _prequantized(p)
    want = jq._mlp_q8_fwd(p["x"], w1q, w1sc, b1_eff, w2q, w2sc, p["b2"], 1e-6,
                          "gelu_exact", True)
    got = tq.mlp_block_q8(_torch(p)["x"], _t(w1q), _t(w1sc), _t(b1_eff),
                          _t(w2q), _t(w2sc), _t(p["b2"]), eps=1e-6,
                          activation="gelu_exact")
    _assert_rel(got, want, 2e-2)


def test_ops_are_inference_only():
    p = _torch(_params(6, 9))
    x = p["x"].float().requires_grad_()
    with pytest.raises(RuntimeError, match="inference-only"):
        tq.ln_mlp_block_q8(x, p["scale"], p["bias"], p["w1"], p["b1"],
                           p["w2"], p["b2"], activation="quick_gelu")
    with torch.no_grad():
        tq.ln_mlp_block_q8(x, p["scale"], p["bias"], p["w1"], p["b1"],
                           p["w2"], p["b2"], activation="quick_gelu")
