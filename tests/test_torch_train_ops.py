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
  stash;
* #7 the recompute backward vs ``_block_bwd_call`` (dx, dqkv, xn, attn,
  and dW/db assembled as tests/test_fused_attention.py does), causal and
  not; #19 ``mlp_bwd`` vs ``_mlp_bwd_call`` on the same dy, and
  ``mlp_bwd_via_kernel``'s five grads vs the assembly of
  tests/test_ln_matmul.py; #20 ``mlp_bwd_dw`` vs ``_mlp_bwd_dw_call``.
  These hold each output to a share of the reference's largest entry:
  2e-3 (#7, the bound of the JAX package's own test of that kernel) or
  1e-4 (#19, #20) in fp32, 2^-6 in bf16.

Bounds are the JAX package's own: fp32 ``assert_allclose`` with atol =
rtol = 2e-3 (tests/test_fused_attention.py:297-299), bf16 max abs error
<= 1e-2 * max|reference| (tests/test_ln_matmul.py:283-318): the two
packages round intermediates (qkv with or without the bias, the dO and
p products) to bf16 at different points.  S runs over {9, 17} and the
64-row tile edges {64, 65, 129} of the CUDA kernels.  At S = 129 the bf16
dqkv against ``_block_bwd_stash_call`` takes 2^-6 (LONG_S_DQKV_BF16_REL:
the two roundings drift apart with the number of keys), and the port's
dqkv is held within 1e-2 of a float64 evaluation besides.  The #5 forward against the
TPU kernel takes tests/test_torch_ops.py's 2^-6 * max|reference| in
bf16: that kernel drops the k-bias and adds the v-bias after the
normalization (fused_attention.py:195-200), so at S=9 a single attention
output of the stash lands 1.1% of the largest one away.  The autograd
Functions' plain backward is held to ``torch.autograd`` of the plain
forward in fp32 with atol = rtol = 1e-4 (the same math in another order),
on every backward route that UML_BWD_STASH, UML_MLP_STASH and UML_MLP_BWD
select (a spy on the ops shows which ran).
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
# bf16 dqkv against the TPU stash backward at S >= LONG_S keys: each
# package rounds p, dO and dS (the TPU kernel also q * scale * log2(e)) to
# bf16 at its own points, and over 129 keys both drift up to ~1% of the
# largest entry from the float64 values, in other directions.  Held to
# the forward's 2^-6 there; the port alone stays within BF16_REL of a
# float64 evaluation (checked beside it).
LONG_S = 129
LONG_S_DQKV_BF16_REL = FWD_BF16_REL
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
@pytest.mark.parametrize("s", [9, 17, 64, 65, 129])
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
    long_bf16 = dtype == "bf16" and s >= LONG_S
    for name, got, w in zip(("dx", "dqkv", "xn"), (dx, dqkv, xn), want):
        _close(got, w, dtype, name,
               LONG_S_DQKV_BF16_REL if long_bf16 and name == "dqkv" else BF16_REL)
    if long_bf16:
        # the port's own rounding stays within BF16_REL of the exact values
        _close(dqkv, _dqkv_f64(tw, causal), dtype, "dqkv vs float64")


def _dqkv_f64(tw, causal):
    """The attention backward's dqkv evaluated in float64 from the same
    bf16 inputs (no intermediate rounding), as numpy."""
    d = {n: t.double() for n, t in tw.items()}
    s = d["x"].shape[1]
    qkv = tlm.raw_layer_norm(d["x"], 1e-5) @ d["w_eff"] + d["b_eff"]
    q, k, v = qkv.view(B, s, 3, HEADS, 64).permute(2, 0, 3, 1, 4)
    do = (d["g"] @ d["wo"].t()).view(B, s, HEADS, 64).transpose(1, 2)
    sc = q @ k.transpose(-1, -2) / 8
    if causal:
        sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), float("-inf"))
    p = torch.softmax(sc, -1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    dqkv = torch.stack([ds @ k / 8, ds.transpose(-1, -2) @ q / 8,
                        p.transpose(-1, -2) @ do])
    return dqkv.permute(1, 3, 0, 2, 4).reshape(B, s, 3 * K).numpy()


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
@pytest.mark.parametrize("s", [9, 17, 64, 65, 129])
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


# db1 of the stash backward against _mlp_bwd_via_stash on one stash: both
# sum the unrounded fp32 dpre, so with dy in fp32 on both sides they differ
# by summation order and the activation's last bits (2e-7 quick_gelu, 2e-6
# exact GELU at S = 65); a dy rounded to bf16 first (2^-9 an element) moves
# db1 by ~2e-3 of its largest entry
DY_F32_REL = 1e-5


@pytest.mark.parametrize("activation,eps", [("quick_gelu", 1e-5), ("gelu_exact", 1e-6)])
def test_mlp_stash_backward_keeps_dy_in_fp32(activation, eps):
    """The plain twin's dy = g @ w2^T stays fp32, as _mlp_bwd_via_stash's
    dot (preferred_element_type=f32) does: its db1 lies within DY_F32_REL
    of the reference's on the same bf16 stash, where the same sum of a dy
    rounded to bf16 lands farther away."""
    jw, tw = _inputs(500, 65, "bf16")
    _, pre = tlm.mlp_block_stash_plain(tw["x"], *_mlp_args(tw), eps=eps,
                                       activation=activation)
    jpre = jnp.asarray(pre.float().numpy(), jnp.bfloat16)
    want = np.asarray(jlm._mlp_bwd_via_stash(jw["x"], jw["g"], jpre, *_mlp_args(jw),
                                             eps, activation)[2])
    got = tlm.mlp_bwd_via_stash_plain(tw["x"], tw["g"], pre, *_mlp_args(tw), eps=eps,
                                      activation=activation)[2]
    dact = tlm.act_and_grad(pre.float(), activation)[1]
    dy16 = (tw["g"].float() @ tw["w2"].float().t()).to(torch.bfloat16).float()
    rounded = (dy16 * dact).reshape(-1, M).sum(0)

    def rel(a):
        return np.abs(a.numpy() - want).max() / np.abs(want).max()

    assert rel(got) <= DY_F32_REL < rel(rounded), (rel(got), rel(rounded))


@pytest.mark.parametrize("bsz,s,m", [(64, 197, 3072), (128, 197, 3072),
                                     (512, 197, 3072), (8, 50, 512)])
def test_mlp_stash_gate_matches_jax(monkeypatch, bsz, s, m):
    assert tlm.MLP_STASH_MAX_BYTES == jlm.MLP_STASH_MAX_BYTES
    for env in ("auto", "0", "1"):
        monkeypatch.setenv("UML_MLP_STASH", env)
        assert tlm.mlp_stash_enabled(bsz, s, m, 2) == \
            jlm._mlp_stash_enabled(bsz, s, m, 2)


def _close_rel(got, want, rel, name=""):
    """max |got - want| <= rel * max |want|."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


RECOMPUTE_REL = {"fp32": 2e-3, "bf16": 2.0 ** -6}
MLP_BWD_REL = {"fp32": 1e-4, "bf16": 2.0 ** -6}


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [9, 17, 33])
def test_attn_recompute_backward_matches_pallas(dtype, causal, s):
    """#7: dq, dk and dv do not depend on the k-bias (the softmax cancels
    it), so dqkv compares directly although the TPU kernel recomputes qkv
    without it."""
    jw, tw = _inputs(500 + s, s, dtype)
    dx, dqkv, xn, attn = tfa.attn_block_bwd_recompute(
        tw["x"], tw["g"], tw["w_eff"], tw["b_eff"], tw["wo"], heads=HEADS,
        causal=causal)
    want = jfa._block_bwd_call(jw["x"], jw["g"], jw["w_eff"], jw["b_eff"],
                               jw["wo"], 1e-5, HEADS, 64, causal, True, il=0)
    rel = RECOMPUTE_REL[dtype]
    for name, got, w in zip(("dx", "dqkv", "xn", "attn"), (dx, dqkv, xn, attn),
                            want):
        _close_rel(got, w, rel, name)
    jdx, jdqkv, jxn, jattn = want
    nums = (((0, 1), (0, 1)), ((), ()))
    f32 = jnp.float32
    jgrads = (jax.lax.dot_general(jxn, jdqkv, nums, preferred_element_type=f32),
              jnp.sum(jdqkv.astype(f32), axis=(0, 1)),
              jax.lax.dot_general(jattn, jw["g"], nums, preferred_element_type=f32),
              jnp.sum(jw["g"].astype(f32), axis=(0, 1)))
    grads = tfa._param_grads(xn, dqkv, attn, tw["g"], *_attn_args(tw))
    for name, got, w in zip(("dw_eff", "db_eff", "dwo", "dbo"), grads, jgrads):
        _close_rel(got, w, rel, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_mlp_bwd_kernel_matches_pallas(dtype, s):
    """#19 on the same dy = g @ w2^T rounded to the compute dtype, then
    the five grads of mlp_bwd_via_kernel against the assembly of
    tests/test_ln_matmul.py around the Pallas kernel."""
    jw, tw = _inputs(600 + s, s, dtype)
    dy_np = np.asarray(jnp.asarray(jax.lax.dot_general(
        jw["g"], jw["w2"], (((2,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jw["x"].dtype), jnp.float32))
    jdy = jnp.asarray(dy_np, jw["x"].dtype)
    tdy = torch.tensor(dy_np).to(tw["x"].dtype)
    got = tlm.mlp_bwd(tw["x"], tdy, tw["b1"], tw["w1"])
    want = jlm._mlp_bwd_call(jw["x"], jdy, jw["b1"], jw["w1"], 1e-5,
                             "quick_gelu", True)
    rel = MLP_BWD_REL[dtype]
    for name, a, b in zip(("dx_ln", "xn", "dpre", "yact"), got, want):
        _close_rel(a, b, rel, name)

    dx_ln, xn, dpre, yact = want
    nums = (((0, 1), (0, 1)), ((), ()))
    f32 = jnp.float32
    jgrads = ((dx_ln.astype(f32) + jw["g"].astype(f32)).astype(jw["x"].dtype),
              jax.lax.dot_general(xn, dpre, nums, preferred_element_type=f32),
              jnp.sum(dpre.astype(f32), axis=(0, 1)),
              jax.lax.dot_general(yact, jw["g"], nums, preferred_element_type=f32),
              jnp.sum(jw["g"].astype(f32), axis=(0, 1)))
    grads = tlm.mlp_bwd_via_kernel(tw["x"], tw["g"], *_mlp_args(tw))
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, jgrads):
        _close_rel(a, b, rel, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_mlp_bwd_dw_kernel_matches_pallas(monkeypatch, dtype, s):
    """#20: dx and the fp32 weight gradients summed over every row."""
    monkeypatch.delenv("UML_MLP_BWD_G", raising=False)
    jw, tw = _inputs(700 + s, s, dtype)
    got = tlm.mlp_bwd_dw(tw["x"], tw["g"], tw["b1"], tw["w1"], tw["w2"])
    want = jlm._mlp_bwd_dw_call(jw["x"], jw["g"], jw["b1"], jw["w1"], jw["w2"],
                                1e-5, "quick_gelu", True)
    for name, a, b in zip(("dx", "dw1", "db1", "dw2"), got, want):
        _close_rel(a, b, MLP_BWD_REL[dtype], name)
    assert all(t.dtype == torch.float32 for t in got[1:])


def _spy(monkeypatch, module, names):
    """Count the calls of ``module.<name>`` for each name (the autograd
    Functions look the ops up in their module at call time)."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*args, _fn=getattr(module, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return calls


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


@pytest.mark.parametrize("stash", ["1", "0"])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_fn_matches_autograd_of_plain(monkeypatch, causal, stash):
    """UML_BWD_STASH=1 stashes a non-causal half and reads the stash back;
    "0", or any causal half, runs attn_block and the recompute backward."""
    monkeypatch.setenv("UML_BWD_STASH", stash)
    calls = _spy(monkeypatch, tfa, ("attn_block_stash", "attn_block_bwd",
                                    "attn_block", "attn_block_bwd_recompute"))
    t = _leaves(400, 17)
    leaves = [t["x"], *_attn_args(t)]
    out = tfa.AttnBlockFn.apply(*leaves, HEADS, causal, 1e-5)
    ref = tfa.attn_block_plain(*leaves, heads=HEADS, causal=causal)
    _autograd_close(out, ref, t["g"], leaves)
    stashed = stash == "1" and not causal
    assert calls == {"attn_block_stash": int(stashed), "attn_block_bwd": int(stashed),
                     "attn_block": int(not stashed),
                     "attn_block_bwd_recompute": int(not stashed)}


def test_attn_block_cls_fn_matches_autograd_of_plain():
    t = _leaves(401, 17, g_rows=1)
    leaves = [t["x"], *_attn_args(t)]
    out = tfa.AttnBlockClsFn.apply(*leaves, HEADS, 1e-5)
    ref = tfa.attn_block_cls_plain(*leaves, heads=HEADS)
    _autograd_close(out, ref, t["g"], leaves)


@pytest.mark.parametrize("mlp_bwd", [None, "kernel", "dw"])
@pytest.mark.parametrize("stash", ["0", "1"])
def test_mlp_block_fn_matches_autograd_of_plain(monkeypatch, stash, mlp_bwd):
    """Both branches of the memory gate: the stash backward (whatever
    UML_MLP_BWD says), and without the stash the backward UML_MLP_BWD
    picks: the recompute VJP of the plain twin (unset), mlp_bwd
    ("kernel") or mlp_bwd_dw ("dw")."""
    monkeypatch.setenv("UML_MLP_STASH", stash)
    if mlp_bwd is None:
        monkeypatch.delenv("UML_MLP_BWD", raising=False)
    else:
        monkeypatch.setenv("UML_MLP_BWD", mlp_bwd)
    calls = _spy(monkeypatch, tlm, ("mlp_block_stash", "mlp_bwd_via_stash",
                                    "mlp_block", "mlp_bwd", "mlp_bwd_dw"))
    t = _leaves(402, 17)
    leaves = [t["x"], *_mlp_args(t)]
    out = tlm.MlpBlockFn.apply(*leaves, 1e-5)
    ref = tlm.mlp_block_plain(*leaves)
    _autograd_close(out, ref, t["g"], leaves)
    want = dict.fromkeys(calls, 0)
    if stash == "1":
        want.update(mlp_block_stash=1, mlp_bwd_via_stash=1)
    else:
        want["mlp_block"] = 1
        if mlp_bwd == "kernel":
            want["mlp_bwd"] = 1
        elif mlp_bwd == "dw":
            want["mlp_bwd_dw"] = 1
    assert calls == want


# -- the MLP backward's default on the card, TF32 plain VJPs (fault F1) -----

def test_mlp_bwd_mode_defaults_to_the_kernel_on_the_card(monkeypatch):
    """UML_MLP_BWD unset: row 19 ("kernel") for a tensor on the card, the
    plain VJP (None) on the CPU; a value set is taken on both."""
    from types import SimpleNamespace

    card, cpu = SimpleNamespace(is_cuda=True), torch.zeros(1)
    monkeypatch.delenv("UML_MLP_BWD", raising=False)
    assert tlm.mlp_bwd_mode(card) == "kernel"
    assert tlm.mlp_bwd_mode(cpu) is None
    for mode in ("kernel", "dw", "plain"):
        monkeypatch.setenv("UML_MLP_BWD", mode)
        assert tlm.mlp_bwd_mode(card) == mode == tlm.mlp_bwd_mode(cpu)


@pytest.mark.parametrize("flag", [False, True])
def test_tf32_products_restore_the_global_flag(flag):
    from uml_tpu_torch.ops._vjp import tf32_products

    matmul = torch.backends.cuda.matmul
    old = matmul.allow_tf32
    try:
        matmul.allow_tf32 = flag
        with tf32_products(True):
            assert matmul.allow_tf32
        assert matmul.allow_tf32 is flag
        with tf32_products(False):
            assert matmul.allow_tf32 is flag
        with pytest.raises(RuntimeError), tf32_products(True):
            raise RuntimeError("inside")
        assert matmul.allow_tf32 is flag
    finally:
        matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_vjp_keeps_fp32_products_on_the_cpu(dtype):
    """TF32 is for bf16 activations on the card only: a CPU tensor of
    either dtype runs its plain VJP with the global flag as it is."""
    from uml_tpu_torch.ops._vjp import plain_vjp

    seen = []

    def fn(x, w):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return x.float() @ w

    x = torch.ones(2, 3, dtype=dtype)
    w = torch.ones(3, 4)
    gx, gw = plain_vjp(fn, (x, w), (torch.ones(2, 4),), (True, True))
    assert seen == [torch.backends.cuda.matmul.allow_tf32]
    assert gx.dtype == dtype and gw.shape == (3, 4)


@pytest.mark.parametrize("mlp_bwd", [None, "plain"])
def test_mlp_block_fn_plain_backward_matches_jax_vjp(monkeypatch, mlp_bwd):
    """With the stash off, the CPU's default backward (and UML_MLP_BWD=
    plain anywhere) is the plain VJP: its five gradients against jax.vjp
    of uml_tpu's _mlp_block (whose CPU backward is the VJP of its jnp
    twin), fp32 at the file's bound."""
    monkeypatch.setenv("UML_MLP_STASH", "0")
    if mlp_bwd is None:
        monkeypatch.delenv("UML_MLP_BWD", raising=False)
    else:
        monkeypatch.setenv("UML_MLP_BWD", mlp_bwd)
    calls = _spy(monkeypatch, tlm, ("mlp_bwd", "mlp_bwd_dw"))
    jw, tw = _inputs(404, 17, "fp32")
    _, vjp = jax.vjp(lambda *a: jlm._mlp_block(*a, 1e-5, "quick_gelu"),
                     jw["x"], *_mlp_args(jw))
    want = vjp(jw["g"])
    leaves = [tw["x"].requires_grad_(), *(t.requires_grad_() for t in _mlp_args(tw))]
    tlm.MlpBlockFn.apply(*leaves, 1e-5).backward(tw["g"])
    for name, leaf, w in zip(("x", "w1", "b1", "w2", "b2"), leaves, want):
        _close(leaf.grad, w, "fp32", name)
    assert calls == {"mlp_bwd": 0, "mlp_bwd_dw": 0}
