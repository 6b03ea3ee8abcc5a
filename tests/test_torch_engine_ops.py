"""The plain versions of the products and passes that the wgmma kernels
of uml_tpu_torch compute, against uml_tpu on the CPU.

The MLP half runs as two products on the wgmma engine (``ops/gemm.py``'s
QUICK_GELU or GELU_STASH triple, then RESIDUAL), the out-projections as
the RESIDUAL triple, and the attention backward as two passes
(``ops/fused_attention.py::attn_bwd``: dq and the softmax statistics,
then dk and dv from them).  On the CPU each wrapper runs its plain
version; here those are held, at K = 128, 2 heads of 64 and S at the
64-row tile edges, against:

* the MLP forward with its stash, ``_mlp_block_fwd_stash`` in interpret
  mode (bf16, the triples' one dtype: 1e-2 of the largest entry, the
  bound of tests/test_torch_train_ops.py); the triple without the stash
  gives the same bits as with it, and the two triples compose
  ``mlp_block_stash_plain`` (pre bit for bit, out within one bf16
  rounding: the triple adds the bias before the residual);
* the out-projection, jnp's fp32-accumulated product of the same bf16
  operands plus bias and residual (one bf16 rounding of the same sum
  apart: 2^-8 of the largest entry);
* the two passes: dq, dk and dv against the dqkv of
  ``_block_bwd_stash_call`` in interpret mode fed JAX's own stash (fp32,
  atol = rtol = 2e-3), and in both dtypes against the port's
  ``attn_block_bwd_plain`` on the same stash (fp32: 1e-5; bf16: 2^-7 of
  the largest entry, the two evaluate p and D in other orders before one
  bf16 rounding); the statistics are (m, 1/l, D) of the fp32 softmax;
* the MLP backward's recompute with a bf16 dy (the DACT triple, row 19's
  first product), dpre and yact against ``_mlp_bwd_call`` in interpret
  mode on the same dy (bf16, 2^-6 of the largest entry: the two evaluate
  the sigmoid and its derivative in other orders before one bf16
  rounding, the bound tests/test_torch_train_ops.py holds row 19 to);
* the int8 product on the K-major weight ([N, K], what the card's int8
  GEMM reads: ``q8_gemm``'s plain version) against ``_q8_dot`` on random
  int8 operands made with numpy, at both towers' widths: exactly, and
  each epilogue exactly against the same jnp composition around it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu.ops import quant as jq
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import gemm
from uml_tpu_torch.ops import ln_matmul as tlm

K, HEADS, B = 128, 2, 2
M = 4 * K
EDGES = [9, 63, 64, 65, 129]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arrays(seed, s):
    rng = np.random.default_rng(seed)

    def rnd(*shape, std=1.0):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return dict(x=rnd(B, s, K), g=rnd(B, s, K), w_eff=rnd(K, 3 * K, std=K ** -0.5),
                b_eff=rnd(3 * K, std=0.1), wo=rnd(K, K, std=K ** -0.5),
                bo=rnd(K, std=0.1), w1=rnd(K, M, std=K ** -0.5), b1=rnd(M, std=0.1),
                w2=rnd(M, K, std=M ** -0.5), b2=rnd(K, std=0.1))


def _both(arrays, dtype):
    """(jax dict, torch dict): biases fp32, the rest in the compute dtype."""
    jdt, tdt = DTYPES[dtype]
    j = {n: jnp.asarray(a, jnp.float32 if n[0] == "b" else jdt)
         for n, a in arrays.items()}
    t = {n: torch.tensor(a).to(torch.float32 if n[0] == "b" else tdt)
         for n, a in arrays.items()}
    return j, t


def _close(got, want, dtype, name, bf16_rel=1e-2, fp32_tol=2e-3):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=fp32_tol, rtol=fp32_tol, err_msg=name)
        return
    err, bound = np.abs(got - want).max(), bf16_rel * np.abs(want).max()
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


@pytest.mark.parametrize("s", EDGES)
def test_mlp_triples_match_the_stash_forward(s):
    """bf16, the kernels' one dtype."""
    jw, tw = _both(_arrays(400 + s, s), "bf16")
    x2d = tw["x"].reshape(B * s, K)
    hidden, pre = gemm.ln_gemm(x2d, tw["w1"], tw["b1"], triple="GELU_STASH")
    assert torch.equal(hidden, gemm.ln_gemm(x2d, tw["w1"], tw["b1"], triple="QUICK_GELU"))
    out = gemm.ln_gemm(hidden, tw["w2"], tw["b2"], x2d, triple="RESIDUAL")
    want_out, want_pre = tlm.mlp_block_stash_plain(x2d, tw["w1"], tw["b1"], tw["w2"],
                                                   tw["b2"])
    assert torch.equal(pre, want_pre)
    # the triple adds (acc + b2) + x, the plain block x + acc + b2: one
    # bf16 rounding of the same fp32 sum apart at most
    _close(out, want_out.float().numpy(), "bf16", "out vs mlp_block_stash_plain",
           bf16_rel=2.0 ** -8)
    jout, jpre = jlm._mlp_block_fwd_stash(jw["x"], jw["w1"], jw["b1"], jw["w2"],
                                          jw["b2"], 1e-5, "quick_gelu", True)
    _close(out.view(B, s, K), jout, "bf16", "out")
    _close(pre.view(B, s, M), jpre, "bf16", "pre")


@pytest.mark.parametrize("s", EDGES)
def test_residual_triple_matches_jnp(s):
    jw, tw = _both(_arrays(500 + s, s), "bf16")
    a, res = tw["g"].reshape(B * s, K), tw["x"].reshape(B * s, K)
    got = gemm.ln_gemm(a, tw["wo"], tw["bo"], res, triple="RESIDUAL")
    assert got.dtype == torch.bfloat16
    want = (jnp.dot(jnp.asarray(a.float().numpy()), jnp.asarray(tw["wo"].float().numpy()),
                    preferred_element_type=jnp.float32)
            + jw["bo"] + jnp.asarray(res.float().numpy()))
    _close(got, want, "bf16", "out", bf16_rel=2.0 ** -8)


def _stash(tw, causal):
    _, qkv, _ = tfa.attn_block_stash_plain(tw["x"], tw["w_eff"], tw["b_eff"], tw["wo"],
                                           tw["bo"], heads=HEADS, causal=causal)
    dattn = (tw["g"].float() @ tw["wo"].float().t()).to(qkv.dtype)
    return qkv, dattn


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGES)
def test_attn_bwd_passes_match_the_stash_backward(s, causal, dtype):
    jw, tw = _both(_arrays(600 + s, s), dtype)
    qkv, dattn = _stash(tw, causal)
    dq, stats = tfa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal)
    assert stats.shape == (B, HEADS, s, 4) and stats.dtype == torch.float32
    assert bool((stats[..., 1] > 0).all()) and bool((stats[..., 3] == 0).all())
    dk, dv = tfa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal, stats=stats)
    got = torch.cat([dq, dk, dv], dim=-1)
    _, want, _ = tfa.attn_block_bwd_plain(tw["x"], tw["g"], qkv, tw["w_eff"], tw["wo"],
                                          heads=HEADS, causal=causal)
    _close(got, want.float().numpy(), dtype, "dqkv vs attn_block_bwd_plain",
           bf16_rel=2.0 ** -7, fp32_tol=1e-5)
    if dtype == "fp32":
        _, jqkv, _ = jfa._block_fwd_stash(jw["x"], jw["w_eff"], jw["b_eff"], jw["wo"],
                                          jw["bo"], 1e-5, HEADS, 64, causal, True)
        jwant = jfa._block_bwd_stash_call(jw["x"], jw["g"], jqkv, jw["w_eff"], jw["b_eff"],
                                          jw["wo"], 1e-5, HEADS, 64, causal, True)
        _close(got, jwant[1], dtype, "dqkv vs _block_bwd_stash_call")


@pytest.mark.parametrize("causal", [False, True])
def test_attn_bwd_statistics_are_the_softmax_of_the_scores(causal):
    """m is each row's largest scaled score, 1/l the reciprocal of
    rowsum(exp(s - m)), D = rowsum(p * dP): jnp in fp32 on the same
    operands, 1e-5."""
    s = 65
    _, tw = _both(_arrays(700, s), "fp32")
    qkv, dattn = _stash(tw, causal)
    _, stats = tfa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal)
    q, k, v = (jnp.asarray(t.numpy()) for t in
               qkv.view(B, s, 3, HEADS, 64).permute(2, 0, 3, 1, 4))
    do = jnp.asarray(dattn.view(B, s, HEADS, 64).transpose(1, 2).numpy())
    sc = jnp.einsum("bhqd,bhkd->bhqk", q, k) / 8.0
    if causal:
        sc = jnp.where(jnp.tril(jnp.ones((s, s), bool)), sc, -jnp.inf)
    p = jnp.exp(sc - sc.max(-1, keepdims=True))
    l = p.sum(-1)
    dp = jnp.einsum("bhqd,bhkd->bhqk", do, v)
    want = jnp.stack([sc.max(-1), 1.0 / l, (p / l[..., None] * dp).sum(-1)], -1)
    np.testing.assert_allclose(stats[..., :3].numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("s", EDGES)
def test_dact_triple_matches_the_mlp_bwd_kernel(s):
    """bf16 dy [rows, M] as row 19 takes it -> (dpre, yact)."""
    jw, tw = _both(_arrays(800 + s, s), "bf16")
    dy = np.random.default_rng(900 + s).standard_normal((B, s, M)).astype(np.float32)
    jdy, tdy = jnp.asarray(dy, jnp.bfloat16), torch.tensor(dy).to(torch.bfloat16)
    x2d = tw["x"].reshape(B * s, K)
    dpre, yact = gemm.ln_gemm(x2d, tw["w1"], tw["b1"], tdy.reshape(B * s, M),
                              triple="DACT")
    assert dpre.dtype == yact.dtype == torch.bfloat16
    _, _, jdpre, jyact = jlm._mlp_bwd_call(jw["x"], jdy, jw["b1"], jw["w1"], 1e-5,
                                           "quick_gelu", True)
    _close(dpre.view(B, s, M), jdpre, "bf16", "dpre", bf16_rel=2.0 ** -6)
    _close(yact.view(B, s, M), jyact, "bf16", "yact", bf16_rel=2.0 ** -6)


# (K, N) of every int8 product: ViT-B/16 QKV, out-projection, c_fc, c_proj;
# the text tower's
Q8_WIDTHS = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
             (512, 1536), (512, 512), (512, 2048), (2048, 512)]


@pytest.mark.parametrize("kn", Q8_WIDTHS)
@pytest.mark.parametrize("epi", ["F32", "BF16", "RESIDUAL"])
def test_q8_product_on_the_k_major_weight_matches_q8_dot(kn, epi):
    k, n = kn
    rows = 17
    rng = np.random.default_rng(k + n)
    a = rng.integers(-127, 128, (rows, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)      # [in, out]
    rs = rng.uniform(1e-3, 2e-2, rows).astype(np.float32)
    cs = rng.uniform(1e-3, 2e-2, n).astype(np.float32)
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    res = rng.standard_normal((rows, n)).astype(np.float32)
    w_nk = torch.from_numpy(w).t().contiguous()             # K-major [N, K]
    got = gemm.q8_gemm(torch.from_numpy(a), w_nk, torch.from_numpy(rs),
                       torch.from_numpy(cs), torch.from_numpy(bias),
                       torch.from_numpy(res).to(torch.bfloat16), epi=epi)
    y = jq._q8_dot(jnp.asarray(a), jnp.asarray(rs)[:, None], jnp.asarray(w),
                   jnp.asarray(cs))
    if epi == "F32":
        # the product itself, with a zero bias: exactly _q8_dot
        zero = torch.zeros(n)
        plain = gemm.q8_gemm(torch.from_numpy(a), w_nk, torch.from_numpy(rs),
                             torch.from_numpy(cs), zero, epi="F32")
        assert np.array_equal(plain.numpy(), np.asarray(y))
        want = y + jnp.asarray(bias)
    elif epi == "BF16":
        want = (y + jnp.asarray(bias)).astype(jnp.bfloat16)
    else:
        want = ((jnp.asarray(res, jnp.bfloat16).astype(jnp.float32) + y)
                + jnp.asarray(bias)).astype(jnp.bfloat16)
    assert got.dtype == (torch.float32 if epi == "F32" else torch.bfloat16)
    assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
