"""The training ops of uml_tpu_torch against uml_tpu's on the CPU.

Each training port's plain PyTorch version (what a CPU tensor runs, and
what the CUDA kernel is held to on the card) against the JAX package on
the same numpy inputs, at small shapes: K=128, 2 heads of 64, S in
{9, 17}, fp32 and bf16.  The JAX Pallas kernels run in interpret mode, as
tests/test_fused_attention.py and tests/test_ln_matmul.py run them.

* #5 the stash forward vs ``_block_fwd_stash``: out, attn, and qkv
  against JAX's bias-free stash plus b_eff (the port's stash includes
  b_eff; the gradients are the same, see ops/fused_attention.py);
* #6 the stash backward (dx, and dW/db as AttnBlockFn assembles them) vs
  ``jax.vjp`` of ``_raw_block_reference``, and (dx, dqkv, xn) vs
  ``_block_bwd_stash_call`` fed JAX's own stash;
* #8 the CLS backward vs ``_block_bwd_cls_call`` with the JAX cotangent
  zero in rows 1-7 (its [B, 8, K] tile is sublane padding);
* #9 the MLP stash forward + ``mlp_bwd_via_stash`` vs
  ``_mlp_block_fwd_stash`` + ``_mlp_bwd_via_stash``, each side on its own
  stash.

Bounds are the JAX package's own: fp32 ``assert_allclose`` with atol =
rtol = 2e-3 (tests/test_fused_attention.py:297-299), bf16 max abs error
<= 1e-2 * max|reference| (tests/test_ln_matmul.py:283-318): the two
packages round intermediates (qkv with or without the bias, the dO and
p products) to bf16 at different points.  The #5 forward against the
TPU kernel takes tests/test_torch_ops.py's 2^-6 * max|reference| in
bf16: that kernel drops the k-bias and adds the v-bias after the
normalization (fused_attention.py:195-200), so at S=9 a single attention
output of the stash lands 1.1% of the largest one away.  The autograd
Functions' plain backward is held to ``torch.autograd`` of the plain
forward in fp32 with atol = rtol = 1e-4 (the same math in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import ln_matmul as tlm

K, HEADS, B = 128, 2, 3
M = 4 * K
FP32_TOL = 2e-3
BF16_REL = 1e-2
FWD_BF16_REL = 2.0 ** -6
AUTOGRAD_TOL = 1e-4
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
MATRICES = ("w_eff", "wo", "w1", "w2")   # cast to the compute dtype; biases fp32


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _weights(rng):
    def rnd(*shape, std):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    return dict(w_eff=rnd(K, 3 * K, std=K ** -0.5), b_eff=rnd(3 * K, std=0.1),
                wo=rnd(K, K, std=K ** -0.5), bo=rnd(K, std=0.1),
                w1=rnd(K, M, std=K ** -0.5), b1=rnd(M, std=0.1),
                w2=rnd(M, K, std=M ** -0.5), b2=rnd(K, std=0.1))


def _inputs(seed, s, dtype, g_rows=None):
    """x, cotangent g and the weights, as (jax dict, torch dict)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrays = _weights(rng)
    arrays["x"] = rng.standard_normal((B, s, K)).astype(np.float32)
    arrays["g"] = rng.standard_normal((B, g_rows or s, K)).astype(np.float32)
    cast = MATRICES + ("x", "g")
    j = {n: jnp.asarray(a, jdt if n in cast else jnp.float32)
         for n, a in arrays.items()}
    t = {n: torch.tensor(a).to(tdt if n in cast else torch.float32)
         for n, a in arrays.items()}
    return j, t


def _close(got, want, dtype, name="", bf16_rel=BF16_REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL,
                                   err_msg=name)
        return
    err = np.abs(got - want).max()
    bound = bf16_rel * np.abs(want).max()
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


def _attn_args(w):
    return w["w_eff"], w["b_eff"], w["wo"], w["bo"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [9, 17])
def test_attn_stash_forward_matches_pallas(dtype, causal, s):
    jw, tw = _inputs(s, s, dtype)
    out, qkv, attn = tfa.attn_block_stash_plain(
        tw["x"], *_attn_args(tw), heads=HEADS, causal=causal)
    jout, jqkv, jattn = jfa._block_fwd_stash(
        jw["x"], *_attn_args(jw), 1e-5, HEADS, 64, causal, True)
    _close(out, jout, dtype, "out", FWD_BF16_REL)
    _close(attn, jattn, dtype, "attn", FWD_BF16_REL)
    _close(qkv, jqkv.astype(jnp.float32) + jw["b_eff"], dtype, "qkv",
           FWD_BF16_REL)


def _port_attn_grads(tw, causal):
    """(dx, dw_eff, db_eff, dwo, dbo) from the plain stash forward and
    backward, assembled as AttnBlockFn does."""
    _, qkv, attn = tfa.attn_block_stash_plain(tw["x"], *_attn_args(tw),
                                              heads=HEADS, causal=causal)
    dx, dqkv, xn = tfa.attn_block_bwd_plain(tw["x"], tw["g"], qkv, tw["w_eff"],
                                            tw["wo"], heads=HEADS, causal=causal)
    return (dx, *tfa._param_grads(xn, dqkv, attn, tw["g"], *_attn_args(tw))), \
        (dx, dqkv, xn)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [9, 17])
def test_attn_stash_backward_matches_vjp_and_pallas(dtype, causal, s):
    jw, tw = _inputs(100 + s, s, dtype)
    grads, (dx, dqkv, xn) = _port_attn_grads(tw, causal)

    _, vjp = jax.vjp(
        lambda x, w_eff, b_eff, wo, bo: jfa._raw_block_reference(
            x, w_eff, b_eff, wo, bo, heads=HEADS, causal=causal, eps=1e-5),
        jw["x"], *_attn_args(jw))
    for name, got, want in zip(("dx", "dw_eff", "db_eff", "dwo", "dbo"),
                               grads, vjp(jw["g"])):
        _close(got, want, dtype, name)

    _, jqkv, _ = jfa._block_fwd_stash(jw["x"], *_attn_args(jw), 1e-5, HEADS,
                                      64, causal, True)
    want = jfa._block_bwd_stash_call(jw["x"], jw["g"], jqkv, jw["w_eff"],
                                     jw["b_eff"], jw["wo"], 1e-5, HEADS, 64,
                                     causal, True)
    for name, got, w in zip(("dx", "dqkv", "xn"), (dx, dqkv, xn), want):
        _close(got, w, dtype, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_attn_cls_backward_matches_pallas(dtype, s):
    jw, tw = _inputs(200 + s, s, dtype, g_rows=1)
    out, qkv, attn = tfa.attn_block_stash_plain(tw["x"], *_attn_args(tw),
                                                heads=HEADS, q_rows=1)
    dx, dqkv, xn = tfa.attn_block_cls_bwd_plain(tw["x"], tw["g"], qkv,
                                                tw["w_eff"], tw["wo"],
                                                heads=HEADS)
    g8 = jnp.zeros((B, jfa.CLS_ROWS, K), jw["g"].dtype).at[:, :1].set(jw["g"])
    want = jfa._block_bwd_cls_call(jw["x"], g8, jw["w_eff"], jw["b_eff"],
                                   jw["wo"], 1e-5, HEADS, 64, True)
    for name, got, w in zip(("dx", "dqkv", "xn"), (dx, dqkv, xn), want):
        _close(got, w, dtype, name)
    _close(attn, want[3][:, :1], dtype, "attn")
    assert out.shape == (B, 1, K)


def _mlp_args(w):
    return w["w1"], w["b1"], w["w2"], w["b2"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_mlp_stash_forward_and_backward_match_jax(dtype, s):
    jw, tw = _inputs(300 + s, s, dtype)
    out, pre = tlm.mlp_block_stash_plain(tw["x"], *_mlp_args(tw))
    jout, jpre = jlm._mlp_block_fwd_stash(jw["x"], *_mlp_args(jw), 1e-5,
                                          "quick_gelu", True)
    _close(out, jout, dtype, "out")
    _close(pre, jpre, dtype, "pre")
    grads = tlm.mlp_bwd_via_stash(tw["x"], tw["g"], pre, *_mlp_args(tw))
    want = jlm._mlp_bwd_via_stash(jw["x"], jw["g"], jpre, *_mlp_args(jw),
                                  1e-5, "quick_gelu")
    for name, got, w in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, want):
        _close(got, w, dtype, name)


@pytest.mark.parametrize("bsz,s,m", [(64, 197, 3072), (128, 197, 3072),
                                     (512, 197, 3072), (8, 50, 512)])
def test_mlp_stash_gate_matches_jax(monkeypatch, bsz, s, m):
    assert tlm.MLP_STASH_MAX_BYTES == jlm.MLP_STASH_MAX_BYTES
    for env in ("auto", "0", "1"):
        monkeypatch.setenv("UML_MLP_STASH", env)
        assert tlm.mlp_stash_enabled(bsz, s, m, 2) == \
            jlm._mlp_stash_enabled(bsz, s, m, 2)


def _leaves(seed, s, g_rows=None):
    """fp32 torch leaves that require a gradient: x, g and the weights."""
    _, tw = _inputs(seed, s, "fp32", g_rows)
    return {n: t.requires_grad_(n != "g") for n, t in tw.items()}


def _autograd_close(fn_out, plain_out, g, leaves):
    got = torch.autograd.grad(fn_out, leaves, g)
    want = torch.autograd.grad(plain_out, leaves, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=AUTOGRAD_TOL,
                                   rtol=AUTOGRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_fn_matches_autograd_of_plain(causal):
    t = _leaves(400, 17)
    leaves = [t["x"], *_attn_args(t)]
    out = tfa.AttnBlockFn.apply(*leaves, HEADS, causal, 1e-5)
    ref = tfa.attn_block_plain(*leaves, heads=HEADS, causal=causal)
    _autograd_close(out, ref, t["g"], leaves)


def test_attn_block_cls_fn_matches_autograd_of_plain():
    t = _leaves(401, 17, g_rows=1)
    leaves = [t["x"], *_attn_args(t)]
    out = tfa.AttnBlockClsFn.apply(*leaves, HEADS, 1e-5)
    ref = tfa.attn_block_cls_plain(*leaves, heads=HEADS)
    _autograd_close(out, ref, t["g"], leaves)


@pytest.mark.parametrize("stash", ["0", "1"])
def test_mlp_block_fn_matches_autograd_of_plain(monkeypatch, stash):
    """Both branches of the memory gate: the stash backward, and the
    recompute VJP of the plain twin."""
    monkeypatch.setenv("UML_MLP_STASH", stash)
    t = _leaves(402, 17)
    leaves = [t["x"], *_mlp_args(t)]
    out = tlm.MlpBlockFn.apply(*leaves, 1e-5)
    ref = tlm.mlp_block_plain(*leaves)
    _autograd_close(out, ref, t["g"], leaves)
