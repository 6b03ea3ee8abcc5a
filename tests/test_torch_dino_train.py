"""The DINO / DINOv2 full-model finetune of uml_tpu_torch against uml_tpu's
on the CPU: the exact-GELU training rows, ``MlpBlockFn`` with exact GELU,
one step of ``make_uml_dino_head(freeze_backbone=False)`` and the finetune
CLI's full-model grid with ``--vision_model``.

Inputs come from numpy seeds; the JAX Pallas kernels run in interpret
mode, as tests/test_ln_matmul.py runs them.  Tolerances:

* the activation: ``act_and_grad(x, "gelu_exact")`` within 1e-6 of a
  float64 evaluation, within 1e-5 abs of uml_tpu's ``_act_grad`` (its
  rational erf is within 3.5e-6 of erf) and within 1e-4 of ``jax.grad``
  of ``_gelu_exact_f32`` (the bound of
  tests/test_ln_matmul.py::test_kernel_gelu_exact_accuracy), over [-12,
  12] and the values next to 0;
* rows 9, 19, 20 and the stash backward in fp32: 1e-4 (atol = rtol, or of
  the largest entry for the row sums) against the jnp references, whose
  erf is XLA's; 5e-4 against the interpreted Pallas kernels, whose GELU is
  the sigmoid-quintic fit (7.8e-5 from erf) and whose GELU' uses the
  rational erf, the bound of tests/test_torch_unfused_ops.py; in bf16 the
  bounds of tests/test_torch_train_ops.py (1e-2 of the largest entry for
  the stash forward and backward, 2^-6 for rows 19 and 20);
* ``MlpBlockFn``: the five gradients within 1e-4 of the largest entry of
  ``jax.vjp`` of uml_tpu's ``_mlp_block`` (its CPU backward is the VJP of
  the jnp twin), fp32, in every backward mode;
* the step: fp32 loss within rtol 1e-5 and every gradient leaf within
  1e-4 of its largest entry; bf16 loss within 1% and every leaf's
  gradient cosine at least 0.99 (the bounds of chip_smoke.py's card-vs-CPU
  step).  The attention k-bias has an exact zero gradient (the softmax
  cancels it): both packages give rounding noise there, so the q and v
  thirds of ``qkv.bias`` are held, as tests/test_torch_train.py holds
  CLIP's in_proj_bias.

The tiny configs are 128 wide with 2 heads of 64: the port's attention
(the kernels and their plain versions) takes head dim 64, the head dim of
every DINO and CLIP config.
"""

import contextlib
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.models import dino as jdino
from uml_tpu.models import uml_head as jhead
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu.train import supervised as jsup
from uml_tpu_torch.models import dino as tdino
from uml_tpu_torch.models import uml_head as thead
from uml_tpu_torch.models.convert import dino_state_dict_from_jax, uml_head_params_from_jax
from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops import gemm
from uml_tpu_torch.ops import ln_matmul as tlm
from uml_tpu_torch.train import supervised as tsup

K, B = 128, 3
M = 4 * K
EPS = 1e-6
GELU = "gelu_exact"
REF_TOL = 1e-4
KERNEL_TOL = 5e-4
STASH_BF16_REL = 1e-2
BWD_BF16_REL = 2.0 ** -6
STEP_RTOL = {"loss": 1e-5, "grad": 1e-4}
BF16_LOSS_RTOL = 1e-2
BF16_MIN_COSINE = 0.99
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel_close(got, want, rel, name=""):
    """max |got - want| <= rel * max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err, bound = np.abs(got - want).max(), rel * np.abs(want).max()
    assert err <= bound, f"{name}: max abs err {err} > {bound}"


def _allclose(got, want, tol, name=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=name)


# -- the activation ------------------------------------------------------------

def test_act_and_grad_gelu_exact_matches_jax():
    x = np.concatenate([np.linspace(-12, 12, 200001),
                        [0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7, 2e-38, -2e-38]])
    x = x.astype(np.float32)
    act, grad = tlm.act_and_grad(torch.from_numpy(x), GELU)
    jx = jnp.asarray(x)
    # against float64: gelu and gelu' within 1e-6; XLA's fp32 erf lies
    # up to 2e-6 from erf near its saturation, so the jnp GELU within 5e-6
    x64 = x.astype(np.float64)
    cdf = 0.5 * (1 + np.array([math.erf(v / math.sqrt(2)) for v in x64]))
    assert np.abs(act.numpy() - x64 * cdf).max() < 1e-6
    assert np.abs(grad.numpy() - (cdf + x64 * np.exp(-0.5 * x64 * x64)
                                  / math.sqrt(2 * math.pi))).max() < 1e-6
    assert np.abs(act.numpy() - np.asarray(jlm._gelu_exact_f32(jx))).max() < 5e-6
    assert np.abs(grad.numpy() - np.asarray(jlm._act_grad(jx, GELU))).max() < 1e-5
    want = np.asarray(jax.vmap(jax.grad(jlm._gelu_exact_f32))(jx))
    assert np.abs(grad.numpy() - want).max() < 1e-4
    # quick_gelu keeps its values; the identity and unknown names raise
    q_act, q_grad = tlm.act_and_grad(torch.from_numpy(x))
    assert np.abs(q_grad.numpy() - np.asarray(jlm._act_grad(jx, "quick_gelu"))).max() < 1e-5
    np.testing.assert_allclose(q_act.numpy(), tlm.quick_gelu_f32(torch.from_numpy(x)).numpy(),
                               atol=1e-6, rtol=0)
    for bad in (None, "gelu"):
        with pytest.raises(ValueError, match="training forms"):
            tlm.act_and_grad(torch.from_numpy(x), bad)


# -- rows 9, 19, 20 ------------------------------------------------------------

def _inputs(seed, s, dtype):
    """x, the cotangent g, dy = g @ w2^T rounded to the compute dtype, and
    the post-fold MLP weights, as (jax dict, torch dict)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    a = {"x": rng.standard_normal((B, s, K)),
         "g": rng.standard_normal((B, s, K)),
         "w1": rng.standard_normal((K, M)) * K ** -0.5,
         "b1": 0.1 * rng.standard_normal(M),
         "w2": rng.standard_normal((M, K)) * M ** -0.5,
         "b2": 0.1 * rng.standard_normal(K)}
    a = {n: v.astype(np.float32) for n, v in a.items()}
    cast = ("x", "g", "w1", "w2")
    j = {n: jnp.asarray(v, jdt if n in cast else jnp.float32) for n, v in a.items()}
    t = {n: torch.tensor(v).to(tdt if n in cast else torch.float32) for n, v in a.items()}
    dy = np.asarray(jnp.asarray(jax.lax.dot_general(
        j["g"], j["w2"], (((2,), (1,)), ((), ())),
        preferred_element_type=jnp.float32).astype(jdt), jnp.float32))
    j["dy"], t["dy"] = jnp.asarray(dy, jdt), torch.tensor(dy).to(tdt)
    return j, t


def _mlp(w):
    return w["w1"], w["b1"], w["w2"], w["b2"]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17, 65])
def test_row9_stash_forward_and_backward_match_jax(dtype, s):
    """The stash forward (out, pre) against the jnp twin and the
    interpreted kernel; the stash backward against ``_mlp_bwd_via_stash``,
    each package on its own stash."""
    jw, tw = _inputs(100 + s, s, dtype)
    out, pre = tlm.mlp_block_stash_plain(tw["x"], *_mlp(tw), eps=EPS, activation=GELU)
    kout, kpre = jlm._mlp_block_fwd_stash(jw["x"], *_mlp(jw), EPS, GELU, True)
    ref = jlm._raw_mlp_block_reference(jw["x"], *_mlp(jw), eps=EPS, activation=GELU)
    grads = tlm.mlp_bwd_via_stash(tw["x"], tw["g"], pre, *_mlp(tw), eps=EPS,
                                  activation=GELU)
    want = jlm._mlp_bwd_via_stash(jw["x"], jw["g"], kpre, *_mlp(jw), EPS, GELU)
    names = ("dx", "dw1", "db1", "dw2", "db2")
    if dtype == "fp32":
        _allclose(out, ref, REF_TOL, "out vs the jnp twin")
        _allclose(out, kout, KERNEL_TOL, "out vs the kernel")
        _allclose(pre, kpre, REF_TOL, "pre")
        for name, a, b in zip(names, grads, want):
            _rel_close(a, b, REF_TOL, name)
    else:
        for name, a, b in (("out", out, kout), ("pre", pre, kpre), *zip(names, grads, want)):
            _rel_close(a, b, STASH_BF16_REL, name)


def _vjp_reference(jw):
    """The five gradients by jax.vjp of the jnp twin (XLA's erf)."""
    _, vjp = jax.vjp(lambda *a: jlm._raw_mlp_block_reference(
        *a, eps=EPS, activation=GELU), jw["x"], *_mlp(jw))
    return vjp(jw["g"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17, 65])
def test_row19_matches_the_kernel_and_the_vjp(dtype, s):
    """``mlp_bwd_plain`` against ``_mlp_bwd_call`` on the same dy, then the
    five gradients of ``mlp_bwd_via_kernel`` against jax.vjp (fp32)."""
    jw, tw = _inputs(200 + s, s, dtype)
    got = tlm.mlp_bwd_plain(tw["x"], tw["dy"], tw["b1"], tw["w1"], eps=EPS,
                            activation=GELU)
    want = jlm._mlp_bwd_call(jw["x"], jw["dy"], jw["b1"], jw["w1"], EPS, GELU, True)
    rel = KERNEL_TOL if dtype == "fp32" else BWD_BF16_REL
    for name, a, b in zip(("dx_ln", "xn", "dpre", "yact"), got, want):
        _rel_close(a, b, rel, name)
    if dtype == "fp32":
        grads = tlm.mlp_bwd_via_kernel(tw["x"], tw["g"], *_mlp(tw), eps=EPS,
                                       activation=GELU)
        for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                              _vjp_reference(jw)):
            _rel_close(a, b, REF_TOL, name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17, 65])
def test_row20_matches_the_kernel_and_the_vjp(monkeypatch, dtype, s):
    """``mlp_bwd_dw_plain`` against ``_mlp_bwd_dw_call``, then the five
    gradients of ``mlp_bwd_dw_via_kernel`` against jax.vjp (fp32)."""
    monkeypatch.delenv("UML_MLP_BWD_G", raising=False)
    jw, tw = _inputs(300 + s, s, dtype)
    got = tlm.mlp_bwd_dw_plain(tw["x"], tw["g"], tw["b1"], tw["w1"], tw["w2"],
                               eps=EPS, activation=GELU)
    want = jlm._mlp_bwd_dw_call(jw["x"], jw["g"], jw["b1"], jw["w1"], jw["w2"],
                                EPS, GELU, True)
    rel = KERNEL_TOL if dtype == "fp32" else BWD_BF16_REL
    for name, a, b in zip(("dx", "dw1", "db1", "dw2"), got, want):
        _rel_close(a, b, rel, name)
    assert all(t.dtype == torch.float32 for t in got[1:])
    if dtype == "fp32":
        grads = tlm.mlp_bwd_dw_via_kernel(tw["x"], tw["g"], *_mlp(tw), eps=EPS,
                                          activation=GELU)
        for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads,
                              _vjp_reference(jw)):
            _rel_close(a, b, REF_TOL, name)


@pytest.mark.parametrize("triple", ["GELU_EXACT_STASH", "DACT_EXACT", "DACT_F32_EXACT"])
def test_engine_triples_compose_the_exact_gelu_rows(triple):
    """The engine's exact-GELU triples (ops/gemm.py's plain versions, what
    the card's products are held to) give the rows' plain values bit for
    bit: row 9's (hidden, pre), row 19's (dpre, yact), row 20's (dpre,
    yact) and the column sums of its fp32 dpre per 128-row tile."""
    _, tw = _inputs(400, 65, "bf16")
    rows = B * 65
    x2d = tw["x"].reshape(rows, K)
    if triple == "GELU_EXACT_STASH":
        hidden, pre = gemm.ln_gemm(x2d, tw["w1"], tw["b1"], triple=triple, eps=EPS)
        want_pre = tlm.mlp_block_stash_plain(tw["x"], *_mlp(tw), eps=EPS,
                                             activation=GELU)[1]
        y = tlm.ln_rows_plain(x2d, EPS).float() @ tw["w1"].float() + tw["b1"]
        assert torch.equal(pre, want_pre.reshape(rows, M))
        assert torch.equal(hidden, tlm.gelu_exact_f32(y).to(torch.bfloat16))
        return
    if triple == "DACT_EXACT":
        dpre, yact = gemm.ln_gemm(x2d, tw["w1"], tw["b1"], tw["dy"].reshape(rows, M),
                                  triple=triple, eps=EPS)
        _, _, want_dpre, want_yact = tlm.mlp_bwd_plain(
            tw["x"], tw["dy"], tw["b1"], tw["w1"], eps=EPS, activation=GELU)
    else:
        dy32 = tw["g"].float().reshape(rows, K) @ tw["w2"].float().t()
        dpre, yact, part = gemm.ln_gemm(x2d, tw["w1"], tw["b1"], dy32, triple=triple,
                                        eps=EPS)
        pre = tlm.ln_rows_plain(x2d, EPS).float() @ tw["w1"].float() + tw["b1"]
        act, dact = tlm.act_and_grad(pre, GELU)
        want_dpre, want_yact = (dy32 * dact).to(torch.bfloat16), act.to(torch.bfloat16)
        want_part = torch.stack([c.sum(0) for c in (dy32 * dact).split(128)])
        torch.testing.assert_close(part, want_part, rtol=1e-6, atol=1e-6)
        assert torch.allclose(part.sum(0), tlm.mlp_bwd_dw_plain(
            tw["x"], tw["g"], tw["b1"], tw["w1"], tw["w2"], eps=EPS,
            activation=GELU)[2], rtol=1e-5, atol=1e-5)
    assert torch.equal(dpre, want_dpre.reshape(rows, M))
    assert torch.equal(yact, want_yact.reshape(rows, M))


# -- the wrappers' C arguments -------------------------------------------------

@pytest.fixture
def recorder(monkeypatch):
    """The C call (and the CUDA device context around it) replaced by a
    recorder of each call's name and arguments: the wrappers then run on
    meta tensors."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("activation,code", [("quick_gelu", 1), ("gelu_exact", 2)])
def test_training_wrappers_pass_the_activation_code(recorder, activation, code):
    """Rows 9, 19 and 20 hand their C entry the activation code after
    (rows, K, M), one argument per SIGNATURES entry; None raises first."""
    s = 257
    x, g = _meta(B, s, K), _meta(B, s, K)
    w1, w2, dy = _meta(K, M), _meta(M, K), _meta(B, s, M)
    b1, b2 = _meta(M, dtype=torch.float32), _meta(K, dtype=torch.float32)
    kw = dict(eps=EPS, activation=activation)
    tlm.mlp_block_stash(x, w1, b1, w2, b2, **kw)
    tlm.mlp_bwd(x, dy, b1, w1, **kw)
    tlm.mlp_bwd_dw(x, g, b1, w1, w2, **kw)
    names = [name for name, _ in recorder]
    assert names == ["uml_mlp_block_stash", "uml_mlp_bwd", "uml_mlp_bwd_dw"]
    for (name, args), at in zip(recorder, (9, 9, 15)):
        assert len(args) == len(_build.SIGNATURES[name])
        assert args[at:at + 5] == (B * s, K, M, code, EPS)
    for fn, args in ((tlm.mlp_block_stash, (x, w1, b1, w2, b2)),
                     (tlm.mlp_bwd, (x, dy, b1, w1)), (tlm.mlp_bwd_dw, (x, g, b1, w1, w2))):
        with pytest.raises(ValueError, match="training forms"):
            fn(*args, eps=EPS, activation=None)
    assert len(recorder) == 3


@pytest.mark.parametrize("activation,code", [("quick_gelu", 1), ("gelu_exact", 2)])
def test_stash_backward_wrapper_passes_the_activation_code(recorder, activation, code):
    """The stash backward on a tensor off the CPU: one uml_mlp_bwd_stash
    call with one argument per SIGNATURES entry, the activation code and
    eps after (rows, K, M), one count on its launch counter, five grads
    in the parameters' shapes and dtypes; None raises before any call."""
    s = 257
    x, g, pre = _meta(B, s, K), _meta(B, s, K), _meta(B, s, M)
    w1, w2 = _meta(K, M), _meta(M, K)
    b1, b2 = _meta(M, dtype=torch.float32), _meta(K, dtype=torch.float32)
    n = tlm.mlp_bwd_via_stash.launches
    grads = tlm.mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, eps=EPS,
                                  activation=activation)
    (name, args), = recorder
    assert name == "uml_mlp_bwd_stash"
    assert len(args) == len(_build.SIGNATURES[name])
    assert args[14:19] == (B * s, K, M, code, EPS)
    assert tlm.mlp_bwd_via_stash.launches == n + 1
    assert [(t.shape, t.dtype) for t in grads] == [
        (p.shape, p.dtype) for p in (x, w1, b1, w2, b2)]
    with pytest.raises(ValueError, match="training forms"):
        tlm.mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, eps=EPS, activation=None)
    with pytest.raises(ValueError):     # a stash of another width
        tlm.mlp_bwd_via_stash(x, g, _meta(B, s, 2 * M), w1, b1, w2, b2, eps=EPS,
                              activation=activation)
    assert len(recorder) == 1


# -- MlpBlockFn --------------------------------------------------------------

def _spy(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*args, _fn=getattr(tlm, name), _name=name, **kwargs):
            calls[_name] += 1
            assert kwargs.get("activation") == GELU, (_name, kwargs)
            return _fn(*args, **kwargs)
        monkeypatch.setattr(tlm, name, counted)
    return calls


@pytest.mark.parametrize("mlp_bwd", [None, "kernel", "dw", "plain"])
@pytest.mark.parametrize("stash", ["1", "0"])
def test_mlp_block_fn_gelu_exact_matches_jax_vjp(monkeypatch, stash, mlp_bwd):
    """All five gradients of MlpBlockFn with exact GELU against jax.vjp of
    uml_tpu's ``_mlp_block`` (fp32): with the stash (its backward whatever
    UML_MLP_BWD says), and without it the backward UML_MLP_BWD picks (the
    plain VJP unset on the CPU and for "plain", row 19 for "kernel", row
    20 for "dw"); each op is called with exact GELU."""
    monkeypatch.setenv("UML_MLP_STASH", stash)
    if mlp_bwd is None:
        monkeypatch.delenv("UML_MLP_BWD", raising=False)
    else:
        monkeypatch.setenv("UML_MLP_BWD", mlp_bwd)
    calls = _spy(monkeypatch, ("mlp_block_stash", "mlp_bwd_via_stash", "mlp_block",
                               "mlp_bwd", "mlp_bwd_dw"))
    jw, tw = _inputs(500, 17, "fp32")
    _, vjp = jax.vjp(lambda *a: jlm._mlp_block(*a, EPS, GELU), jw["x"], *_mlp(jw))
    want = vjp(jw["g"])
    leaves = [tw["x"].requires_grad_(), *(t.requires_grad_() for t in _mlp(tw))]
    out = tlm.MlpBlockFn.apply(*leaves, EPS, GELU)
    _allclose(out, jlm._raw_mlp_block_reference(jw["x"], *_mlp(jw), eps=EPS,
                                                activation=GELU), REF_TOL, "out")
    out.backward(tw["g"])
    for name, leaf, w in zip(("x", "w1", "b1", "w2", "b2"), leaves, want):
        _rel_close(leaf.grad, w, REF_TOL, name)
    expect = dict.fromkeys(calls, 0)
    if stash == "1":
        expect.update(mlp_block_stash=1, mlp_bwd_via_stash=1)
    else:
        expect["mlp_block"] = 1
        if mlp_bwd in ("kernel", "dw"):
            expect["mlp_bwd" if mlp_bwd == "kernel" else "mlp_bwd_dw"] = 1
    assert calls == expect


# -- one step of the DINO head -------------------------------------------------

# (patch, layerscale): DINOv2 (patch 16 at 32 px: S = 5), DINO v1 (no
# LayerScale), patch 8 (S = 17)
STEP_CONFIGS = {"dinov2_p16": (16, True), "dino_v1_p16": (16, False),
                "dinov2_p8": (8, True)}
TEXT_DIM, N_CLASSES, ALPHA = 8, 3, 0.5


def _config(patch, layerscale):
    return jdino.DinoConfig(K, 2, 2, patch, image_size=32, layerscale=layerscale,
                            pretrain_image_size=32)


def _variables(cfg, seed):
    """uml_tpu's flax tree with every leaf drawn from a numpy seed (the
    draws of tests/test_torch_dino.py): LayerScale in [0.2, 1.2], LN scales
    near 1, biases, class token and position embeddings nonzero."""
    model = jdino.DinoViT(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros(
        (1, cfg.image_size, cfg.image_size, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("kernel"):
            a = rng.standard_normal(s.shape) * int(np.prod(s.shape[:-1])) ** -0.5
        elif "layerscale" in name:
            a = rng.uniform(0.2, 1.2, s.shape)
        elif "norm" in name and name.endswith("scale"):
            a = 1 + 0.1 * rng.standard_normal(s.shape)
        else:
            a = 0.05 * rng.standard_normal(s.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, 32 * 32 * 3), dtype=np.uint8),
            rng.integers(0, N_CLASSES, B).astype(np.int64),
            np.ones(B, np.float32),
            rng.standard_normal((4, TEXT_DIM)).astype(np.float32),
            rng.integers(0, N_CLASSES, 4).astype(np.int64),
            np.array([1, 1, 1, 0], np.float32))


def _jax_step(cfg, variables, batch, jdt):
    """(head params as numpy, loss, its gradient) by jax.value_and_grad
    of uml_tpu's UML loss through make_uml_dino_head(freeze_backbone=False)."""
    model = jdino.DinoViT(cfg, dtype=jdt)
    jm = jhead.make_uml_dino_head(model, variables, N_CLASSES, text_indim=TEXT_DIM,
                                  learnable_temp=True, freeze_backbone=False)
    params = jm.init_params(seed=0)
    params["img_scale"], params["txt_scale"] = jnp.float32(1.3), jnp.float32(0.7)
    img, lab, w, txt, tlab, tw = (jnp.asarray(a) for a in batch)

    def loss_fn(p):
        feats, _ = jm.image_features_train(p, img)
        s_img, s_txt = jm._scales(p)
        return (jsup._weighted_ce(feats @ p["head_w"] * s_img, lab, w)
                + ALPHA * jsup._weighted_ce(txt @ p["head_w"] * s_txt, tlab, tw))

    loss, grads = jax.value_and_grad(loss_fn)(params)
    as_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return as_np(params), float(loss), as_np(grads)


def _port_step(cfg, params, batch, tdt):
    tcfg = tdino.DinoConfig(**{f: getattr(cfg, f) for f in (
        "hidden_size", "num_layers", "num_heads", "patch_size", "image_size",
        "mlp_ratio", "layerscale", "ln_eps", "pretrain_image_size")})
    model = thead.make_uml_dino_head(tdino.DinoViT(tcfg, dtype=tdt), N_CLASSES,
                                     text_indim=TEXT_DIM, learnable_temp=True,
                                     freeze_backbone=False)
    model.load_state_tree(uml_head_params_from_jax(params))
    img, lab, w, txt, tlab, tw = (torch.from_numpy(a) for a in batch)
    s_img, s_txt = model.scales()
    loss = (tsup.weighted_ce(model.image_features(img) @ model.head_w * s_img, lab, w)
            + ALPHA * tsup.weighted_ce(txt @ model.head_w * s_txt, tlab, tw))
    loss.backward()
    return model, loss.item()


def _grad_pairs(model, jgrads):
    """(name, port gradient, JAX gradient) of every trainable leaf: the
    head's, and the backbone's in the port's layout (convert.py maps a
    gradient tree as it maps the parameters); the q and v thirds of each
    qkv.bias."""
    want = {f"backbone.{k}": v for k, v in
            dino_state_dict_from_jax(jgrads["backbone"]).items()}
    want.update({k: torch.tensor(np.asarray(v, np.float32)) for k, v in jgrads.items()
                 if k != "backbone"})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    assert "img_proj_w" in got
    for key in sorted(want):
        g, w = got[key].float(), want[key].float()
        if key.endswith("qkv.bias"):
            g, w = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (g, w))
        yield key, g, w


@pytest.mark.parametrize("config", list(STEP_CONFIGS))
def test_dino_head_step_matches_jax_fp32(config):
    """One step's loss and every gradient of make_uml_dino_head(
    freeze_backbone=False) against jax.value_and_grad, fp32: the port's
    DinoViT under autograd (AttnBlockFn / AttnBlockClsFn, MlpBlockFn with
    exact GELU, the LN and LayerScale folds by autograd) against uml_tpu's
    blocks, weights carried across by convert.py."""
    cfg = _config(*STEP_CONFIGS[config])
    batch = _batch(7)
    params, jloss, jgrads = _jax_step(cfg, _variables(cfg, seed=len(config)), batch,
                                      jnp.float32)
    model, loss = _port_step(cfg, params, batch, torch.float32)
    np.testing.assert_allclose(loss, jloss, rtol=STEP_RTOL["loss"])
    pairs = list(_grad_pairs(model, jgrads))
    # the head's 4 leaves, the embeddings' and the final LN's 6, 12 a
    # block and its 2 LayerScales
    assert len(pairs) == 4 + 6 + 2 * (14 if cfg.layerscale else 12)
    for key, g, w in pairs:
        err = (g - w).abs().max().item()
        assert err <= STEP_RTOL["grad"] * w.abs().max().item(), (key, err)


@pytest.mark.parametrize("config", ["dinov2_p16", "dinov2_p8"])
def test_dino_head_step_matches_jax_bf16(config):
    """The same step in bf16: loss within 1%, every gradient leaf's cosine
    with uml_tpu's at least 0.99."""
    cfg = _config(*STEP_CONFIGS[config])
    batch = _batch(8)
    params, jloss, jgrads = _jax_step(cfg, _variables(cfg, seed=20), batch, jnp.bfloat16)
    model, loss = _port_step(cfg, params, batch, torch.bfloat16)
    assert abs(loss - jloss) <= BF16_LOSS_RTOL * abs(jloss)
    for key, g, w in _grad_pairs(model, jgrads):
        cos = float((g * w).sum() / (g.norm() * w.norm() + 1e-30))
        assert cos >= BF16_MIN_COSINE, (key, cos)


def test_head_tree_from_jax_reads_a_dino_backbone():
    """uml_head_params_from_jax reads a DINO backbone by its leaves (no
    ``visual`` tower) through dino_state_dict_from_jax; the port's DINO
    head's state_tree saves the DINO state_dict as ``backbone``."""
    cfg = _config(16, True)
    variables = _variables(cfg, seed=1)
    tree = uml_head_params_from_jax({"head_w": np.zeros((TEXT_DIM, N_CLASSES)),
                                     "img_proj_w": np.ones((K, TEXT_DIM)),
                                     "backbone": variables})
    assert tree["backbone"].keys() == dino_state_dict_from_jax(variables).keys()
    model, _ = _port_step(cfg, jhead.make_uml_dino_head(
        jdino.DinoViT(cfg), variables, N_CLASSES, text_indim=TEXT_DIM,
        learnable_temp=True, freeze_backbone=False).init_params(seed=0), _batch(0),
        torch.float32)
    saved = model.state_tree()
    assert set(saved) == {"head_w", "img_proj_w", "img_scale", "txt_scale", "backbone"}
    assert saved["backbone"].keys() == tree["backbone"].keys()
    assert torch.equal(saved["backbone"]["blocks.1.layerscale2"],
                       tree["backbone"]["blocks.1.layerscale2"])


# -- the finetune CLI ----------------------------------------------------------

def _cli_common(root):
    from tests.test_torch_features_cli import DINO, LM

    return ["--data_dir", root, "--indices_dir", f"{root}/indices",
            "--feature_dir", f"{root}/features", "--dataset", "caltech101",
            "--vision_model", DINO, "--language_model", LM, "--allow-random-init",
            "--train-shot", "2", "--seed", "1", "--mesh", "off"]


@pytest.mark.heavy
def test_finetune_cli_dino_full_model(tmp_path, monkeypatch):
    """``finetune --vision_model <tiny DINOv2> --hyperparams smoke_full
    --allow-random-init`` on the CPU (the tiny seeded checkpoint of
    tests/test_torch_features_cli.py::tiny_dino, S = 257, its text cache
    written by the port's ``features``): test_result.pth holds finite
    accuracies and a DINO ``backbone`` beside ``head_w`` and
    ``img_proj_w``, and every tensor of the backbone moved from the
    checkpoint's."""
    from tests.test_data_fewshot import make_caltech_fixture
    from tests.test_torch_features_cli import DINO, LM, tiny_dino
    from uml_tpu_torch.cli import features as torch_features
    from uml_tpu_torch.cli import finetune as torch_ft
    from uml_tpu_torch.cli import generate_fewshot as torch_gf
    from uml_tpu_torch.data.feature_cache import load_cache

    root = make_caltech_fixture(str(tmp_path / "data"))
    tiny_dino(monkeypatch)
    monkeypatch.setenv("UML_TORCH_DEVICE", "cpu")
    common = _cli_common(root)
    torch_gf.main(torch_gf.build_parser().parse_args(common[:4] + [
        "--dataset", "caltech101", "--train-shot", "2", "--seed", "1"]))
    args = torch_features.build_parser().parse_args(
        common + ["--text-augmentation", "hand_crafted", "--batch-size", "8",
                  "--num-workers", "2"])
    args.overwrite, args.force_rerun = False, False
    torch_features.main(args)
    exp = str(tmp_path / "experiments")
    args = torch_ft.build_parser().parse_args(common + [
        "--result_dir", exp, "--text_type", "hand_crafted", "--modality",
        "crossmodal", "--alpha", "0.5", "--hyperparams", "smoke_full"])
    args.overwrite, args.force_rerun = False, False
    torch_ft.main(args)
    (path,) = [os.path.join(d, f) for d, _, files in os.walk(exp) for f in files
               if f == "test_result.pth"]
    result = load_cache(path)
    assert np.isfinite(result["test_acc"]) and np.isfinite(result["val_acc"])
    assert set(result["model"]) == {"head_w", "img_proj_w", "backbone"}
    init = tdino.load_dino(DINO, allow_random_init=True).state_dict()
    trained = result["model"]["backbone"]
    assert set(trained) == set(init) and "blocks.1.layerscale2" in trained
    assert f"{DINO}-{LM}" in path
    still = [k for k in init if torch.equal(torch.as_tensor(trained[k]), init[k])]
    assert not still, still


@pytest.mark.parametrize("flags", [["--quant", "int8"], ["--ckpt_every", "5"]])
def test_finetune_refuses_int8_and_checkpoints_with_dino(flags):
    """The DINO full-model grid takes both flags before any work:
    ``--quant`` is accepted and ignored, as uml_tpu's finetune ignores it
    (the int8 modes, the mixed ones too, serve the features CLI only), and
    ``--ckpt_every`` saves and resumes (tests/test_torch_checkpoint.py)."""
    from tests.test_torch_features_cli import DINO
    from uml_tpu_torch.cli import finetune as torch_ft

    dino = ["--vision_model", DINO, "--hyperparams", "smoke_full", "--mesh", "off"]
    if flags[0] == "--quant":
        for quant in ("int8", "int8_mlp", "int8_attn", "int8_qkv"):
            torch_ft.check_ported(torch_ft.build_parser().parse_args(
                dino + ["--quant", quant]))
    else:
        args = torch_ft.build_parser().parse_args(dino + flags)
        torch_ft.check_ported(args)
        assert args.ckpt_every == 5
    torch_ft.check_ported(torch_ft.build_parser().parse_args(dino))
