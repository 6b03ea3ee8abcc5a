"""uml_tpu_torch.ops against uml_tpu.ops on the CPU.

Each port's plain PyTorch version (what a CPU tensor runs) is held against
both the JAX post-fold twin and the JAX Pallas kernel in interpret mode
(as tests/test_fused_attention.py and tests/test_text_tower.py run it),
on the same numpy inputs, at small shapes: K=128, 2 heads of 64,
S in {9, 17}; the attention halves' stash and CLS forms also at the
m64 edges of the fused QKV + attention kernel, S in {64, 65, 129, 197}.

Tolerances: fp32 max abs error 1e-4 (the same math, other summation
order).  bf16: max abs error 2^-6 * max|reference|, two bf16 ulps of the
largest output: the TPU kernel drops the k-bias and adds the v-bias after
normalization while the twin adds b_eff before the bf16 rounding of qkv
(fused_attention.py:195-200 vs :521-522), and the twin stores the scores
in bf16, so single intermediates round to a neighbouring bf16 value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu.ops import text_tower as jtt
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import ln_matmul as tlm
from uml_tpu_torch.ops import text_tower as ttt

K, HEADS, B = 128, 2, 3
M = 4 * K
FP32_ATOL = 1e-4
BF16_REL = 2.0 ** -6

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _weights(rng, layers=None):
    """Post-fold half-block weights as fp32 numpy, optionally stacked."""
    lead = () if layers is None else (layers,)

    def rnd(*shape, std):
        return (std * rng.standard_normal(lead + shape)).astype(np.float32)

    return dict(w_eff=rnd(K, 3 * K, std=K ** -0.5), b_eff=rnd(3 * K, std=0.1),
                wo=rnd(K, K, std=K ** -0.5), bo=rnd(K, std=0.1),
                w1=rnd(K, M, std=K ** -0.5), b1=rnd(M, std=0.1),
                w2=rnd(M, K, std=M ** -0.5), b2=rnd(K, std=0.1))


MATRICES = ("w_eff", "wo", "w1", "w2")   # cast to the compute dtype; biases fp32


def _jax(w, jdt):
    return {n: jnp.asarray(a, jdt if n in MATRICES else jnp.float32)
            for n, a in w.items()}


def _torch(w, tdt):
    return {n: torch.tensor(a).to(tdt if n in MATRICES else torch.float32)
            for n, a in w.items()}


def _assert_close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    bound = FP32_ATOL if dtype == "fp32" else BF16_REL * np.abs(want).max()
    assert err <= bound, f"max abs err {err} > {bound}"


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [9, 17])
def test_attn_block_matches_twin_and_pallas(dtype, causal, s):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    args_j = (jx, jw["w_eff"], jw["b_eff"], jw["wo"], jw["bo"])
    got = tfa.attn_block_plain(tx, tw["w_eff"], tw["b_eff"], tw["wo"],
                               tw["bo"], heads=HEADS, causal=causal)
    twin = jfa._raw_block_reference(*args_j, heads=HEADS, causal=causal,
                                    eps=1e-5)
    pallas = jfa._block_fwd(*args_j, 1e-5, HEADS, 64, causal, True)
    _assert_close(got, twin, dtype)
    _assert_close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_attn_block_cls_matches_row0(dtype, s):
    """[B,1,K] against row 0 of the JAX CLS kernel's [B,8,K]."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(100 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    args_j = (jnp.asarray(x, jdt), jw["w_eff"], jw["b_eff"], jw["wo"], jw["bo"])
    got = tfa.attn_block_cls_plain(torch.tensor(x).to(tdt), tw["w_eff"],
                                   tw["b_eff"], tw["wo"], tw["bo"], heads=HEADS)
    pallas = jfa._block_cls_fwd(*args_j, 1e-5, HEADS, 64, True)[:, :1]
    twin = jfa._raw_block_reference(*args_j, heads=HEADS, causal=False,
                                    eps=1e-5)[:, :1]
    _assert_close(got, pallas, dtype)
    _assert_close(got, twin, dtype)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 65, 129, 197])
def test_attn_block_stash_matches_twin_and_pallas_at_tile_edges(causal, s):
    """The stash forward (out, qkv, attn; what the fused kernel's plain
    version computes) at the m64 edges, bf16, against _block_fwd_stash in
    interpret mode (its qkv is bias-free: compared with b_eff added) and
    out against the twin."""
    rng = np.random.default_rng(400 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jnp.bfloat16), _torch(w, torch.bfloat16)
    args_j = (jnp.asarray(x, jnp.bfloat16), jw["w_eff"], jw["b_eff"], jw["wo"],
              jw["bo"])
    out, qkv, attn = tfa.attn_block_stash_plain(
        torch.tensor(x).to(torch.bfloat16), tw["w_eff"], tw["b_eff"], tw["wo"],
        tw["bo"], heads=HEADS, causal=causal)
    jout, jqkv, jattn = jfa._block_fwd_stash(*args_j, 1e-5, HEADS, 64, causal, True)
    _assert_close(out, jout, "bf16")
    _assert_close(attn, jattn, "bf16")
    _assert_close(qkv, jqkv.astype(jnp.float32) + jw["b_eff"], "bf16")
    _assert_close(out, jfa._raw_block_reference(*args_j, heads=HEADS, causal=causal,
                                                eps=1e-5), "bf16")


@pytest.mark.parametrize("s", [64, 65, 129, 197])
def test_attn_block_cls_matches_row0_at_tile_edges(s):
    """The CLS half at the m64 edges, bf16: [B,1,K] against row 0 of the
    JAX CLS kernel in interpret mode and of the twin."""
    rng = np.random.default_rng(500 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jnp.bfloat16), _torch(w, torch.bfloat16)
    args_j = (jnp.asarray(x, jnp.bfloat16), jw["w_eff"], jw["b_eff"], jw["wo"],
              jw["bo"])
    got = tfa.attn_block_cls_plain(torch.tensor(x).to(torch.bfloat16), tw["w_eff"],
                                   tw["b_eff"], tw["wo"], tw["bo"], heads=HEADS)
    _assert_close(got, jfa._block_cls_fwd(*args_j, 1e-5, HEADS, 64, True)[:, :1],
                  "bf16")
    _assert_close(got, jfa._raw_block_reference(*args_j, heads=HEADS, causal=False,
                                                eps=1e-5)[:, :1], "bf16")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_mlp_block_matches_twin_and_pallas(dtype, s):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(200 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    args_j = (jnp.asarray(x, jdt), jw["w1"], jw["b1"], jw["w2"], jw["b2"])
    got = tlm.mlp_block_plain(torch.tensor(x).to(tdt), tw["w1"], tw["b1"],
                              tw["w2"], tw["b2"])
    twin = jlm._raw_mlp_block_reference(*args_j, eps=1e-5,
                                        activation="quick_gelu")
    pallas = jlm._mlp_block_fwd(*args_j, 1e-5, "quick_gelu", True)
    _assert_close(got, twin, dtype)
    _assert_close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_mlp_block_gelu_exact_matches_reference_and_pallas(dtype, s):
    """DINO's MLP half (exact GELU): the plain version against
    mlp_block_reference (the LN unit, so that it is the post-fold function;
    fp32 1e-4) and against the Pallas kernel in interpret mode, whose
    sigmoid-quintic fit of GELU errs by up to 7.8e-5 (fp32 5e-4)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(600 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    jx = jnp.asarray(x, jdt)
    got = tlm.mlp_block_plain(torch.tensor(x).to(tdt), tw["w1"], tw["b1"],
                              tw["w2"], tw["b2"], activation="gelu_exact")
    ref = jlm.mlp_block_reference(jx, jnp.ones(K), jnp.zeros(K), jw["w1"],
                                  jw["b1"], jw["w2"], jw["b2"],
                                  activation="gelu_exact")
    pallas = jlm._mlp_block_fwd(jx, jw["w1"], jw["b1"], jw["w2"], jw["b2"],
                                1e-5, "gelu_exact", True)
    _assert_close(got, ref, dtype)
    if dtype == "fp32":
        assert np.abs(got.numpy() - np.asarray(pallas)).max() <= 5e-4
    else:
        _assert_close(got, pallas, dtype)


def test_ln_mlp_block_defaults_to_no_activation():
    """ln_mlp_block with no activation is uml_tpu's default, the identity
    (ln_matmul.py:654-655), on the wrapper and the post-fold op alike."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((B, 17, K)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(K)).astype(np.float32)
    w = _weights(rng)
    mnames = ("w1", "b1", "w2", "b2")
    want = jlm.ln_mlp_block(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), *(jnp.asarray(w[n]) for n in mnames))
    got = tlm.ln_mlp_block(torch.tensor(x), torch.tensor(scale),
                           torch.tensor(bias), *(torch.tensor(w[n]) for n in mnames))
    _assert_close(got, want, "fp32")
    _assert_close(got, jlm.mlp_block_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        *(jnp.asarray(w[n]) for n in mnames), activation=None), "fp32")
    tw = _torch(w, torch.float32)
    plain = tlm.mlp_block(torch.tensor(x), *(tw[n] for n in mnames),
                          activation=None)
    _assert_close(plain, jlm._raw_mlp_block_reference(
        jnp.asarray(x), *(jnp.asarray(w[n]) for n in mnames), eps=1e-5,
        activation=None), "fp32")


@pytest.mark.parametrize("activation", [None, "quick_gelu", "gelu_exact"])
def test_mlp_wrappers_pass_the_activation_code(monkeypatch, activation):
    """On a tensor off the CPU (meta tensors here, the C call recorded),
    mlp_block hands uml_mlp_block the activation code of csrc/ln_gemm.cuh
    and mlp_block_q8 hands it to uml_mlp_block_q8 (which takes the two
    GELUs), one argument per SIGNATURES entry."""
    import contextlib
    import types

    from uml_tpu_torch.ops import _build
    from uml_tpu_torch.ops import quant as tq

    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *a: calls.append((name, a)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    f32, i8 = torch.float32, torch.int8
    x = meta(B, 257, K)
    tlm.mlp_block(x, meta(K, M), meta(M, dtype=f32), meta(M, K),
                  meta(K, dtype=f32), activation=activation)
    code = {None: 0, "quick_gelu": 1, "gelu_exact": 2}[activation]
    (name, args), = calls
    assert name == "uml_mlp_block" and len(args) == len(_build.SIGNATURES[name])
    assert args[8:12] == (B * 257, K, M, code)
    q8_args = (meta(K, M, dtype=i8), meta(M, dtype=f32), meta(M, dtype=f32),
               meta(M, K, dtype=i8), meta(K, dtype=f32), meta(K, dtype=f32))
    if activation is None:
        with pytest.raises(ValueError, match="ROADMAP"):
            tq.mlp_block_q8(x, *q8_args, activation=activation)
        return
    tq.mlp_block_q8(x, *q8_args, activation=activation)
    name, args = calls[1]
    assert name == "uml_mlp_block_q8" and len(args) == len(_build.SIGNATURES[name])
    assert args[11:15] == (B * 257, K, M, code)


def test_mlp_block_fn_refuses_another_activation():
    """MlpBlockFn trains quick_gelu (its default) and DINO's exact GELU;
    any other activation, uml_tpu's identity (None) among them, raises
    before any work."""
    rng = np.random.default_rng(13)
    tw = _torch(_weights(rng), torch.float32)
    x = torch.tensor(rng.standard_normal((B, 9, K)), dtype=torch.float32,
                     requires_grad=True)
    mlp = (tw["w1"], tw["b1"], tw["w2"], tw["b2"])
    for act in (None, "gelu"):
        with pytest.raises(ValueError, match="training forms"):
            tlm.MlpBlockFn.apply(x, *mlp, 1e-5, act)
    for act in ("quick_gelu", "gelu_exact"):
        x.grad = None
        tlm.MlpBlockFn.apply(x, *mlp, 1e-5, act).sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [9, 17])
def test_text_tower_matches_reference_and_pallas(dtype, s):
    """L=2 causal layers; the JAX tower kernel runs in interpret mode."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(300 + s)
    x = rng.standard_normal((B, s, K)).astype(np.float32)
    w = _weights(rng, layers=2)
    jw, tw = _jax(w, jdt), _torch(w, tdt)
    order = ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2")
    got = ttt.text_tower_plain(torch.tensor(x).to(tdt),
                               *(tw[n] for n in order), heads=HEADS)
    jargs = (jnp.asarray(x, jdt), *(jw[n] for n in order))
    ref = jtt.text_tower_reference(*jargs, heads=HEADS)
    pallas = jtt._tower(*jargs, HEADS, 64, 1e-5)   # CPU backend -> interpret
    _assert_close(got, ref, dtype)
    _assert_close(got, pallas, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_fold_ln_into_matmul_matches(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    scale = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(K)).astype(np.float32)
    kernel = rng.standard_normal((K, 3 * K)).astype(np.float32) / np.sqrt(K)
    kbias = (0.1 * rng.standard_normal(3 * K)).astype(np.float32)
    jw, jb = jfa.fold_ln_into_matmul(jnp.asarray(scale), jnp.asarray(bias),
                                     jnp.asarray(kernel, jdt),
                                     jnp.asarray(kbias))
    tw, tb = tfa.fold_ln_into_matmul(torch.tensor(scale), torch.tensor(bias),
                                     torch.tensor(kernel).to(tdt),
                                     torch.tensor(kbias))
    assert tw.dtype == tdt and tb.dtype == torch.float32
    # the scale multiply is one fp32 product per element: bit-equal
    np.testing.assert_array_equal(tw.float().numpy(),
                                  np.asarray(jw.astype(jnp.float32)))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_pre_fold_api_matches_jax_reference(causal):
    """ln_attn_block / ln_mlp_block (LN params unfolded, uml_tpu's
    signatures) against uml_tpu's unfolded references, fp32."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, 17, K)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(K)).astype(np.float32)
    w = _weights(rng)
    names = ("w_eff", "b_eff", "wo", "bo")
    want = jfa.ln_attn_block_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        *(jnp.asarray(w[n]) for n in names), heads=HEADS, causal=causal)
    got = tfa.ln_attn_block(torch.tensor(x), torch.tensor(scale),
                            torch.tensor(bias),
                            *(torch.tensor(w[n]) for n in names),
                            heads=HEADS, causal=causal)
    _assert_close(got, want, "fp32")
    mnames = ("w1", "b1", "w2", "b2")
    want = jlm.mlp_block_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        *(jnp.asarray(w[n]) for n in mnames), activation="quick_gelu")
    got = tlm.ln_mlp_block(torch.tensor(x), torch.tensor(scale),
                           torch.tensor(bias),
                           *(torch.tensor(w[n]) for n in mnames),
                           activation="quick_gelu")
    _assert_close(got, want, "fp32")


def test_cpu_tensors_take_the_plain_route():
    """A wrapper given CPU tensors returns its plain version's result and
    launches nothing (the launch counters stay where they were)."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((B, 9, K)), dtype=torch.bfloat16)
    tw = _torch(_weights(rng), torch.bfloat16)
    tw2 = _torch(_weights(rng, layers=2), torch.bfloat16)
    attn = (tw["w_eff"], tw["b_eff"], tw["wo"], tw["bo"])
    mlp = (tw["w1"], tw["b1"], tw["w2"], tw["b2"])
    tower = tuple(tw2[n] for n in ("w_eff", "b_eff", "wo", "bo", "w1", "b1",
                                   "w2", "b2"))
    wrappers = (tfa.attn_block, tfa.attn_block_cls, tlm.mlp_block,
                ttt.text_tower)
    before = [w.launches for w in wrappers]
    pairs = [
        (tfa.attn_block(x, *attn, heads=HEADS, causal=True),
         tfa.attn_block_plain(x, *attn, heads=HEADS, causal=True)),
        (tfa.attn_block_cls(x, *attn, heads=HEADS),
         tfa.attn_block_cls_plain(x, *attn, heads=HEADS)),
        (tlm.mlp_block(x, *mlp), tlm.mlp_block_plain(x, *mlp)),
        (ttt.text_tower(x, *tower, heads=HEADS),
         ttt.text_tower_plain(x, *tower, heads=HEADS)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    assert [w.launches for w in wrappers] == before
