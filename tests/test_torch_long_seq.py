"""Sequence lengths past the port's old shared-memory gates, against
uml_tpu on the CPU.

The attention of every fused block streams K/V now (flash_attention.cu
forward, a two-pass dq kernel and the chunked CLS backward), so the port
takes the S that uml_tpu takes: CLIP ViT-L/14's S = 257 (K = 1024, 16
heads, M = 4096) and S = 785 at ViT-B/16 widths (K = 768, 12 heads,
M = 3072).  Inputs are numpy draws from a seed handed to both packages.

* The LN row pre-pass of the wgmma engine: ``ln_rows_plain`` against the
  jnp twin ``ln_matmul_reference`` (uml_tpu/ops/ln_matmul.py:44-51) with a
  unit scale, a zero bias and an identity weight, which leaves its raw,
  rounded LN: within one ulp of the compute dtype (the two sum the row
  statistics in other orders).
* The plain versions of row 7 (``attn_block_bwd_recompute``) and row 20
  (``mlp_bwd_dw``) against ``_block_bwd_call`` and ``_mlp_bwd_dw_call`` in
  interpret mode, with the bounds of tests/test_torch_train_ops.py (a share
  of the reference's largest entry: 2e-3 for row 7 and 1e-4 for row 20 in
  fp32, 2^-6 in bf16).
* The wrappers' checks take S = 257 and 785 and still refuse an fp32
  operand and a width that is not a multiple of 64.
* ``attention_plain`` (P rounded once, against the row's final max) at
  S = 257 and 785 against ``mha_reference`` run in fp32 (unrounded
  probabilities), and ``gemm_at`` on the CPU against jnp at every row-chunk
  count it takes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import ln_matmul as tlm
from uml_tpu_torch.ops import text_tower as ttt
from uml_tpu_torch.ops import tower_q8 as ttq

# (S, K, heads, M): ViT-L/14, and ViT-B/16 widths at a long sequence
SHAPES = {"vit_l14_s257": (257, 1024, 16, 4096), "vit_b_s785": (785, 768, 12, 3072)}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
REL = {"row7": {"fp32": 2e-3, "bf16": 2.0 ** -6},
       "row20": {"fp32": 1e-4, "bf16": 2.0 ** -6}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(shape, dtype, seed):
    """x, g [1, S, K] and one layer's post-fold weights as (jax, torch)."""
    s, k, _, m = SHAPES[shape]
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)

    def rnd(*dims, std=1.0):
        return (std * rng.standard_normal(dims)).astype(np.float32)

    arrays = dict(x=rnd(1, s, k), g=rnd(1, s, k),
                  w_eff=rnd(k, 3 * k, std=k ** -0.5), b_eff=rnd(3 * k, std=0.1),
                  wo=rnd(k, k, std=k ** -0.5), w1=rnd(k, m, std=k ** -0.5),
                  b1=rnd(m, std=0.1), w2=rnd(m, k, std=m ** -0.5))
    biases = ("b_eff", "b1")
    j = {n: jnp.asarray(a, jnp.float32 if n in biases else jdt)
         for n, a in arrays.items()}
    t = {n: torch.tensor(a).to(torch.float32 if n in biases else tdt)
         for n, a in arrays.items()}
    return j, t


def _close_rel(got, want, rel, name):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("rows,k", [(9, 128), (257, 1024), (785, 768)])
def test_ln_rows_plain_matches_jnp_raw_ln(rows, k, dtype):
    jdt, tdt = DTYPES[dtype]
    x = (3.0 * np.random.default_rng(rows).standard_normal((rows, k)) + 0.5
         ).astype(np.float32)
    want = jlm.ln_matmul_reference(
        jnp.asarray(x, jdt), jnp.ones(k), jnp.zeros(k), jnp.eye(k, dtype=jdt),
        jnp.zeros(k))
    got = tlm.ln_rows_plain(torch.tensor(x).to(tdt))
    assert got.dtype == tdt
    ulp = 2.0 ** -7 if dtype == "bf16" else 2.0 ** -22
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=ulp, atol=1e-6)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_attn_recompute_backward_long_seq_matches_pallas(shape, dtype):
    """#7 at S = 257 and 785; dqkv compares directly, though the TPU
    kernel recomputes qkv without the k-bias: dq, dk and dv do not depend
    on it."""
    heads = SHAPES[shape][2]
    jw, tw = _inputs(shape, dtype, 70)
    got = tfa.attn_block_bwd_recompute(tw["x"], tw["g"], tw["w_eff"], tw["b_eff"],
                                       tw["wo"], heads=heads)
    want = jfa._block_bwd_call(jw["x"], jw["g"], jw["w_eff"], jw["b_eff"],
                               jw["wo"], 1e-5, heads, 64, False, True, il=0)
    for name, a, b in zip(("dx", "dqkv", "xn", "attn"), got, want):
        _close_rel(a, b, REL["row7"][dtype], name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_mlp_bwd_dw_long_seq_matches_pallas(shape, dtype):
    jw, tw = _inputs(shape, dtype, 71)
    got = tlm.mlp_bwd_dw(tw["x"], tw["g"], tw["b1"], tw["w1"], tw["w2"])
    want = jlm._mlp_bwd_dw_call(jw["x"], jw["g"], jw["b1"], jw["w1"], jw["w2"],
                                1e-5, "quick_gelu", True)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2"), got, want):
        _close_rel(a, b, REL["row20"][dtype], name)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_wrapper_checks_take_long_seq(shape):
    """The checks the wrappers run before a launch, on CPU tensors: every
    S passes; an fp32 operand and a width that is not a multiple of 64 do
    not."""
    s, k, heads, m = SHAPES[shape]
    _, tw = _inputs(shape, "bf16", 72)
    attn = (tw["w_eff"], tw["b_eff"], tw["wo"], torch.zeros(k))
    assert tfa._check_fwd(tw["x"], *attn, heads) == (1, s, k, heads * 64)
    tfa._check_bwd(tw["x"], tw["g"], None, tw["w_eff"], tw["wo"], heads, s)
    tfa._check_bwd(tw["x"], tw["g"][:, :1].contiguous(), None, tw["w_eff"],
                   tw["wo"], heads, 1)
    assert tfa.supports_fused_attention(k, heads, 64, s)
    assert ttt.supports_text_tower(k, heads, 64, s, m)
    assert ttq.supports_tower_q8(k, heads, 64, s, m)
    with pytest.raises(TypeError):
        tfa._check_fwd(tw["x"].float(), *attn, heads)
    with pytest.raises(TypeError):
        tfa._check_bwd(tw["x"], tw["g"].float(), None, tw["w_eff"], tw["wo"],
                       heads, s)
    narrow = tw["x"][..., :k - 32].contiguous()
    with pytest.raises(ValueError):
        tfa._check_fwd(narrow, *attn, heads)
    with pytest.raises(ValueError):
        tfa._check_bwd(narrow, narrow, None, tw["w_eff"], tw["wo"], heads, s)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [257, 785])
def test_attention_plain_long_seq_matches_fp32_witness(s, causal, dtype):
    """The fused halves' plain attention (one rounding of P, against the
    row's final max) against uml_tpu's mha_reference run in fp32 on the
    same inputs, whose probabilities are not rounded: in fp32 within 2e-5
    of the largest entry, in bf16 within 2^-7 (P and the output rounded
    once each)."""
    from uml_tpu.ops.attention import mha_reference

    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s + causal)
    q, k, v = (rng.standard_normal((1, 2, s, 64)).astype(np.float32)
               for _ in range(3))
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    got = tfa.attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tdt
    want = mha_reference(*(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)),
                         causal=causal)
    _close_rel(got, want, 2e-5 if dtype == "fp32" else 2.0 ** -7, "attn")


@pytest.mark.parametrize("splits", [0, 1, 3, 8])
def test_gemm_at_plain_matches_jnp(splits):
    """gemm_at on the CPU (its plain version, whatever the chunk count)
    against jnp's fp32-accumulated a^T b of the same bf16 operands."""
    from uml_tpu_torch.ops import gemm

    rng = np.random.default_rng(splits)
    a, b = (rng.standard_normal((785, n)).astype(np.float32) for n in (128, 192))
    ta, tb = (torch.tensor(t).to(torch.bfloat16) for t in (a, b))
    got = gemm.gemm_at(ta, tb, splits=splits)
    want = jnp.dot(jnp.asarray(ta.float().numpy()).T,
                   jnp.asarray(tb.float().numpy()),
                   preferred_element_type=jnp.float32)
    _close_rel(got, want, 1e-5, "gemm_at")


@pytest.mark.parametrize("splits", [-1, 9])
def test_gemm_at_refuses_chunk_counts_it_does_not_take(splits):
    from uml_tpu_torch.ops import gemm

    a = torch.zeros(9, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        gemm.gemm_at(a, a, splits=splits)
