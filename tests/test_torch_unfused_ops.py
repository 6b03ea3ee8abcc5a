"""The stand-alone ops of uml_tpu_torch (ln_matmul, add_ln_matmul,
ln_qkv_attention, layer_norm, flash_attention, multi_head_attention,
dense_attention_bshd, mha_plain) against uml_tpu's on the CPU.

Each op's plain PyTorch version (what a CPU tensor runs) is held against
uml_tpu's jnp twin and against the Pallas kernel in interpret mode, called
as uml_tpu's own tests call it, on the same numpy inputs at small shapes.

Tolerances, fp32 (the same math in another summation order): 2e-4 abs and
rel for the products, 2e-5 abs for attention, 1e-5 for ``t`` and
layer_norm; ``gelu_exact`` against the Pallas kernel 5e-4 (that kernel fits
erf-GELU by a sigmoid of a quintic, max abs err 7.8e-5 before the product
amplifies it; the port uses erf), against the twin 2e-4.  bf16: max abs
error 2^-6 of the largest output (single intermediates round to the
neighbouring bf16 value).  Gradients, fp32, against ``jax.grad`` of the
uml_tpu op: 1e-4 abs and rel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import attention as jat
from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu.ops.layer_norm import layer_norm as j_layer_norm
from uml_tpu.ops.layer_norm import layer_norm_reference
from uml_tpu_torch import ops as tops
from uml_tpu_torch.ops import attention as tat
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import ln_matmul as tlm
from uml_tpu_torch.ops.layer_norm import layer_norm_plain, supports_layer_norm

BF16_REL = 2.0 ** -6
GRAD_TOL = 1e-4
ACTS = [None, "quick_gelu", "gelu_exact"]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, atol, rtol=0.0):
    got = got.detach().float().numpy()
    want = _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _close_bf16(got, want):
    got, want = got.detach().float().numpy(), _np(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), BF16_REL * np.abs(want).max()
    assert err <= bound, f"max abs err {err} > {bound}"


def _ln_matmul_inputs(seed, shape, m, with_delta=False):
    """fp32 numpy (x[, delta], scale, bias, w, b) for LN -> matmul."""
    rng = np.random.default_rng(seed)
    k = shape[-1]
    f = np.float32
    out = [rng.standard_normal(shape).astype(f)]
    if with_delta:
        out.append(rng.standard_normal(shape).astype(f))
    out += [(1 + 0.1 * rng.standard_normal(k)).astype(f),
            (0.1 * rng.standard_normal(k)).astype(f),
            (rng.standard_normal((k, m)) / np.sqrt(k)).astype(f),
            (0.1 * rng.standard_normal(m)).astype(f)]
    return out


def _cast(arrays, jdt, tdt, matrices):
    """numpy -> (jax, torch) lists; ``matrices`` indexes the activations
    and weights that take the compute dtype, the rest stay fp32."""
    j = [jnp.asarray(a, jdt if i in matrices else jnp.float32)
         for i, a in enumerate(arrays)]
    t = [torch.tensor(a).to(tdt if i in matrices else torch.float32)
         for i, a in enumerate(arrays)]
    return j, t


# -- ln_matmul (TPU kernels _ln_matmul_kernel, _ln_matmul_kernel_3d) ---------

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape", [(37, 128), (3, 17, 128)])
def test_ln_matmul_fp32_matches_twin_and_pallas(shape, act):
    arrays = _ln_matmul_inputs(0, shape, 256)
    (jx, js, jb, jw, jbb), (tx, ts, tb, tw, tbb) = _cast(
        arrays, jnp.float32, torch.float32, (0, 3))
    want = jlm.ln_matmul_reference(jx, js, jb, jw, jbb, activation=act)
    w_eff, b_eff = jfa.fold_ln_into_matmul(js, jb, jw, jbb)
    if len(shape) == 2:
        pallas = jlm._ln_matmul_fwd_impl(jx, w_eff, b_eff, 1e-5, 256, True, act)
    else:
        pallas = jlm._ln_matmul_fwd_3d(jx, w_eff, b_eff, 1e-5, 1, True, act)
    plain = tlm.ln_matmul_plain(tx, ts, tb, tw, tbb, activation=act)
    pallas_tol = 5e-4 if act == "gelu_exact" else 2e-4
    # the Pallas kernel takes the LN affine folded into w and b, the port
    # applies it unfolded: one function within the fp32 tolerance
    for got in (plain,
                tlm.ln_matmul(tx, ts, tb, tw, tbb, activation=act),
                tlm.ln_matmul(tx, ts, tb, tw, tbb, activation=act,
                              impl="pallas")):
        _close(got, want, 2e-4, 2e-4)
        _close(got, pallas, pallas_tol, pallas_tol)
        _close(got, jlm._raw_ln_matmul_reference(jx, w_eff, b_eff, eps=1e-5,
                                                 activation=act), 2e-4, 2e-4)


@pytest.mark.parametrize("act", ACTS)
def test_ln_matmul_bf16_matches_twin(act):
    arrays = _ln_matmul_inputs(1, (3, 17, 128), 256)
    (jx, js, jb, jw, jbb), (tx, ts, tb, tw, tbb) = _cast(
        arrays, jnp.bfloat16, torch.bfloat16, (0, 3))
    want = jlm.ln_matmul_reference(jx, js, jb, jw, jbb, activation=act)
    got = tlm.ln_matmul_plain(tx, ts, tb, tw, tbb, activation=act)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)
    for impl in ("auto", "pallas"):
        assert torch.equal(got, tlm.ln_matmul(tx, ts, tb, tw, tbb,
                                              activation=act, impl=impl))


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("act", [None, "quick_gelu"])
def test_ln_matmul_grads_match_jax(impl, act):
    arrays = _ln_matmul_inputs(2, (2, 9, 128), 192)
    jargs, targs = _cast(arrays, jnp.float32, torch.float32, (0, 3))
    cot = np.random.default_rng(3).standard_normal((2, 9, 192)).astype(np.float32)
    want = jax.grad(lambda *a: (jlm.ln_matmul(*a, activation=act, impl=impl)
                                * jnp.asarray(cot)).sum(),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [t.requires_grad_() for t in targs]
    (tlm.ln_matmul(*targs, activation=act, impl=impl)
     * torch.tensor(cot)).sum().backward()
    for t, w in zip(targs, want):
        _close(t.grad, w, GRAD_TOL, GRAD_TOL)


# -- add_ln_matmul (TPU kernel _add_ln_matmul_kernel) -------------------------

@pytest.mark.parametrize("act", ACTS)
def test_add_ln_matmul_fp32_matches_twin_and_pallas(act):
    arrays = _ln_matmul_inputs(3, (3, 17, 256), 512, with_delta=True)
    jargs, targs = _cast(arrays, jnp.float32, torch.float32, (0, 1, 4))
    t_ref, out_ref = jlm.add_ln_matmul_reference(*jargs, activation=act)
    t_pal, out_pal = jlm._add_ln_matmul_fwd_3d(*jargs, 1e-5, act, True)
    pallas_tol = 5e-4 if act == "gelu_exact" else 2e-4
    for impl in ("auto", "pallas", "reference"):
        t, out = tlm.add_ln_matmul(*targs, activation=act, impl=impl)
        _close(t, t_ref, 1e-5)
        _close(t, t_pal, 1e-5)
        _close(out, out_ref, 2e-4, 2e-4)
        _close(out, out_pal, pallas_tol, pallas_tol)


def test_add_ln_matmul_gelu_shorthand_and_bf16():
    arrays = _ln_matmul_inputs(4, (2, 9, 128), 256, with_delta=True)
    jargs, targs = _cast(arrays, jnp.bfloat16, torch.bfloat16, (0, 1, 4))
    t_ref, out_ref = jlm.add_ln_matmul_reference(*jargs,
                                                 activation="quick_gelu")
    t, out = tlm.add_ln_matmul(*targs, gelu=True)
    assert t.dtype == out.dtype == torch.bfloat16
    # t is one bf16 rounding of the same fp32 sum on both sides
    np.testing.assert_array_equal(t.float().numpy(), _np(t_ref))
    _close_bf16(out, out_ref)
    # the statistics are those of the unrounded sum, not of the bf16 t
    t2, out2 = tlm.add_ln_matmul_plain(*targs, activation="quick_gelu")
    assert torch.equal(t, t2) and torch.equal(out, out2)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_add_ln_matmul_grads_match_jax(impl):
    arrays = _ln_matmul_inputs(5, (2, 9, 128), 192, with_delta=True)
    jargs, targs = _cast(arrays, jnp.float32, torch.float32, (0, 1, 4))
    rng = np.random.default_rng(6)
    ct = rng.standard_normal((2, 9, 128)).astype(np.float32)
    co = rng.standard_normal((2, 9, 192)).astype(np.float32)

    def jloss(*a):
        t, out = jlm.add_ln_matmul(*a, gelu=True, impl=impl)
        return (t * jnp.asarray(ct)).sum() + (out * jnp.asarray(co)).sum()

    want = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)
    targs = [t.requires_grad_() for t in targs]
    t, out = tlm.add_ln_matmul(*targs, gelu=True, impl=impl)
    ((t * torch.tensor(ct)).sum() + (out * torch.tensor(co)).sum()).backward()
    for a, w in zip(targs, want):
        _close(a.grad, w, GRAD_TOL, GRAD_TOL)


def test_unknown_activation_raises_as_uml_tpu():
    arrays = _ln_matmul_inputs(7, (2, 5, 128), 128)
    jargs, targs = _cast(arrays, jnp.float32, torch.float32, (0, 3))
    with pytest.raises(KeyError):
        jlm.ln_matmul(*jargs, activation="relu")
    with pytest.raises(KeyError):
        tlm.ln_matmul(*targs, activation="relu")


def test_supports_ln_matmul_is_a_shape_and_dtype_gate():
    assert tlm.supports_ln_matmul(768, 3072)
    assert tlm.supports_ln_matmul(768, 2304, torch.bfloat16)
    # no VMEM gate: a [4096, 16384] weight streams in tiles
    assert tlm.supports_ln_matmul(4096, 16384)
    assert not tlm.supports_ln_matmul(768, 3072, torch.float32)
    assert not tlm.supports_ln_matmul(100, 3072)
    assert not tlm.supports_ln_matmul(768, 1000)


# -- layer_norm (TPU kernel _ln_kernel) ---------------------------------------

@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(5, 96), (3, 17, 128), (2, 3, 4, 64)])
def test_layer_norm_matches_twin_and_pallas(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    k = shape[-1]
    arrays = [(3 + 2 * rng.standard_normal(shape)).astype(np.float32),
              (1 + 0.1 * rng.standard_normal(k)).astype(np.float32),
              (0.1 * rng.standard_normal(k)).astype(np.float32)]
    jargs, targs = _cast(arrays, jdt, tdt, (0,))
    twin = layer_norm_reference(*jargs, 1e-5)
    pallas = j_layer_norm(*jargs, 1e-5, impl="pallas")
    for impl in ("auto", "pallas", "reference"):
        got = tops.layer_norm(*targs, impl=impl)
        assert got.dtype == tdt and got.shape == tuple(shape)
        if dtype == "fp32":
            _close(got, twin, 1e-5)
            _close(got, pallas, 1e-5)
        else:
            _close_bf16(got, twin)
            _close_bf16(got, pallas)


def test_layer_norm_takes_the_two_pass_variance():
    """A row with a large mean: E[x^2] - E[x]^2 loses the variance in fp32,
    mean((x - mean)^2) does not."""
    rng = np.random.default_rng(9)
    x = (1000.0 + rng.standard_normal((4, 128))).astype(np.float32)
    ones, zeros = np.ones(128, np.float32), np.zeros(128, np.float32)
    want = layer_norm_reference(jnp.asarray(x), jnp.asarray(ones),
                                jnp.asarray(zeros), 1e-5)
    got = layer_norm_plain(torch.tensor(x), torch.tensor(ones),
                           torch.tensor(zeros), 1e-5)
    # the two row means differ by ~1e-4 (fp32 sums of values near 1000)
    _close(got, want, 2e-3)
    fast = tlm.raw_layer_norm(torch.tensor(x), 1e-5)
    assert (fast - got).abs().max() > 1e-2


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_layer_norm_grads_match_jax(impl):
    rng = np.random.default_rng(10)
    arrays = [rng.standard_normal((3, 7, 64)).astype(np.float32),
              (1 + 0.1 * rng.standard_normal(64)).astype(np.float32),
              (0.1 * rng.standard_normal(64)).astype(np.float32)]
    cot = rng.standard_normal((3, 7, 64)).astype(np.float32)
    jargs, targs = _cast(arrays, jnp.float32, torch.float32, (0,))
    want = jax.grad(lambda *a: (j_layer_norm(*a, impl=impl)
                                * jnp.asarray(cot)).sum(),
                    argnums=(0, 1, 2))(*jargs)
    targs = [t.requires_grad_() for t in targs]
    (tops.layer_norm(*targs, impl=impl) * torch.tensor(cot)).sum().backward()
    for a, w in zip(targs, want):
        _close(a.grad, w, GRAD_TOL, GRAD_TOL)


def test_layer_norm_takes_bf16_scale_and_bias():
    """bf16 scale and bias give the output of their fp32 values."""
    rng = np.random.default_rng(11)
    x = torch.tensor(rng.standard_normal((3, 5, 64)).astype(np.float32))
    scale = torch.tensor((1 + 0.1 * rng.standard_normal(64)).astype(np.float32))
    bias = torch.tensor((0.1 * rng.standard_normal(64)).astype(np.float32))
    want = tops.layer_norm(x, scale, bias)
    got = tops.layer_norm(x, scale.bfloat16().float(), bias.bfloat16().float())
    assert got.shape == want.shape
    _close(tops.layer_norm(x, scale.bfloat16(), bias.bfloat16()), got, 0.0)


def test_supports_layer_norm():
    assert supports_layer_norm(768, torch.bfloat16)
    assert supports_layer_norm(4096, torch.float32)
    assert not supports_layer_norm(100, torch.float32)
    assert not supports_layer_norm(768, torch.float16)


# -- attention (TPU kernel _flash_kernel) -------------------------------------

def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("shape,causal", [
    ((1, 2, 77, 64), True),
    ((2, 2, 50, 64), False),
    ((1, 1, 130, 64), True),
    ((1, 2, 50, 128), False),
])
def test_flash_attention_fp32_matches_twin_and_pallas(shape, causal):
    jargs, targs = _cast(_qkv(0, shape), jnp.float32, torch.float32, (0, 1, 2))
    twin = jat.mha_reference(*jargs, causal=causal)
    pallas = jat.flash_attention(*jargs, causal=causal)
    for got in (tops.flash_attention(*targs, causal=causal),
                tat.attention_plain(*targs, causal=causal),
                tops.mha_plain(*targs, causal=causal),
                tops.multi_head_attention(*targs, causal=causal),
                tops.multi_head_attention(*targs, causal=causal, impl="pallas")):
        _close(got, twin, 2e-5)
        _close(got, pallas, 2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_mha_plain_bf16_keeps_scores_in_bf16(causal):
    """Bit-level twin of mha_reference's storage scheme: the bf16 result is
    within two bf16 ulps of the largest output, and it differs from the
    fp32-score version (the scheme is really applied)."""
    jargs, targs = _cast(_qkv(1, (2, 2, 33, 64)), jnp.bfloat16, torch.bfloat16,
                         (0, 1, 2))
    want = jat.mha_reference(*jargs, causal=causal)
    got = tops.mha_plain(*targs, causal=causal)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want)
    tight = np.abs(got.float().numpy() - _np(want)).max()
    loose = np.abs(tat.attention_plain(*targs, causal=causal)
                   .float().numpy() - _np(want)).max()
    assert tight <= loose


def test_mha_plain_additive_mask_matches():
    jargs, targs = _cast(_qkv(2, (1, 2, 19, 64)), jnp.float32, torch.float32,
                         (0, 1, 2))
    mask = np.random.default_rng(3).standard_normal((19, 19)).astype(np.float32)
    want = jat.mha_reference(*jargs, mask=jnp.asarray(mask))
    _close(tops.mha_plain(*targs, mask=torch.tensor(mask)), want, 2e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_dense_attention_bshd_matches(causal, dtype):
    jdt, tdt = DTYPES[dtype]
    jargs, targs = _cast(_qkv(4, (2, 21, 2, 64)), jdt, tdt, (0, 1, 2))
    want = jat.dense_attention_bshd(*jargs, causal=causal)
    got = tops.dense_attention_bshd(*targs, causal=causal)
    assert got.shape == (2, 21, 2, 64)
    if dtype == "fp32":
        _close(got, want, 2e-5)
        # and the same function as the [B, H, S, D] one
        bhsd = tops.mha_plain(*(t.transpose(1, 2) for t in targs), causal=causal)
        _close(got, _np(jnp.asarray(bhsd.transpose(1, 2).numpy())), 2e-5)
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("causal", [False, True])
def test_multi_head_attention_grads_match_jax(impl, causal):
    jargs, targs = _cast(_qkv(5, (1, 2, 23, 64)), jnp.float32, torch.float32,
                         (0, 1, 2))
    cot = np.random.default_rng(6).standard_normal((1, 2, 23, 64)).astype(np.float32)
    want = jax.grad(lambda *a: (jat.multi_head_attention(
        *a, causal=causal, impl=impl) * jnp.asarray(cot)).sum(),
        argnums=(0, 1, 2))(*jargs)
    targs = [t.requires_grad_() for t in targs]
    (tops.multi_head_attention(*targs, causal=causal, impl=impl)
     * torch.tensor(cot)).sum().backward()
    for a, w in zip(targs, want):
        _close(a.grad, w, GRAD_TOL, GRAD_TOL)


def test_multi_head_attention_routing(monkeypatch):
    """auto: the dense plain attention on the CPU at any S (the kernel only
    on the card from S = 1024 up); pallas: the streaming op; anything else:
    the plain attention, as uml_tpu's."""
    calls = []
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **k: calls.append("flash") or a[0])
    monkeypatch.setattr(tat, "mha_plain",
                        lambda *a, **k: calls.append("plain") or a[0])
    q = torch.zeros(1, 1, 1100, 64)
    for impl in ("auto", "pallas", "reference", "fused", "whatever"):
        tat.multi_head_attention(q, q, q, impl=impl)
    assert calls == ["plain", "flash", "plain", "plain", "plain"]
    assert tat.FLASH_MIN_SEQ == jat._FLASH_MIN_SEQ == 1024
    assert tat.supports_flash_attention(64) and tat.supports_flash_attention(128)
    assert not tat.supports_flash_attention(96)
    assert not tat.supports_flash_attention(64, torch.float32)


# -- ln_qkv_attention (TPU kernel fused_attention._kernel) --------------------

def _ln_qkv_inputs(seed, s, k=128, heads=2):
    return _ln_matmul_inputs(seed, (2, s, k), 3 * heads * 64)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [9, 17])
def test_ln_qkv_attention_fp32_matches_twin_and_pallas(s, causal):
    jargs, targs = _cast(_ln_qkv_inputs(11, s), jnp.float32, torch.float32,
                         (0, 3))
    twin = jfa.ln_qkv_attention_reference(*jargs, heads=2, causal=causal)
    pallas = jfa.ln_qkv_attention(*jargs, heads=2, causal=causal, impl="pallas")
    for impl in ("auto", "pallas", "reference"):
        got = tops.ln_qkv_attention(*targs, heads=2, causal=causal, impl=impl)
        assert got.shape == (2, s, 128)
        _close(got, twin, 2e-4, 2e-4)
        _close(got, pallas, 2e-4, 2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_ln_qkv_attention_bf16_matches_twin(causal):
    jargs, targs = _cast(_ln_qkv_inputs(12, 17), jnp.bfloat16, torch.bfloat16,
                         (0, 3))
    want = jfa.ln_qkv_attention_reference(*jargs, heads=2, causal=causal)
    _close_bf16(tfa.ln_qkv_attention_plain(*targs, heads=2, causal=causal), want)


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_ln_qkv_attention_grads_match_jax(impl):
    jargs, targs = _cast(_ln_qkv_inputs(13, 9), jnp.float32, torch.float32,
                         (0, 3))
    cot = np.random.default_rng(14).standard_normal((2, 9, 128)).astype(np.float32)
    want = jax.grad(lambda *a: (jfa.ln_qkv_attention(
        *a, heads=2, causal=True, impl=impl) * jnp.asarray(cot)).sum(),
        argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [t.requires_grad_() for t in targs]
    (tops.ln_qkv_attention(*targs, heads=2, causal=True, impl=impl)
     * torch.tensor(cot)).sum().backward()
    for i, (a, w) in enumerate(zip(targs, want)):
        if i == 4:
            # the k-bias third has an exactly zero gradient (a constant
            # shift of a row's scores): both sides hold rounding noise there
            a_g, w = a.grad.reshape(3, -1)[[0, 2]], _np(w).reshape(3, -1)[[0, 2]]
            np.testing.assert_allclose(a_g.numpy(), w, atol=GRAD_TOL,
                                       rtol=GRAD_TOL)
        else:
            _close(a.grad, w, GRAD_TOL, GRAD_TOL)


def test_supports_fused_attention_gate():
    assert tfa.supports_fused_attention(768, 12, 64, 197)
    assert tfa.supports_fused_attention(512, 8, 64, 77)
    assert tfa.supports_fused_attention(768, 12, 64, 400)
    # any S: the attention streams K/V
    assert tfa.supports_fused_attention(768, 12, 64, 401)
    assert tfa.supports_fused_attention(1024, 16, 64, 785)
    assert not tfa.supports_fused_attention(768, 6, 128, 197)
    assert not tfa.supports_fused_attention(768, 12, 64, 197, torch.float32)


def test_public_exports_follow_uml_tpu():
    """uml_tpu.ops' attention and layer_norm exports under the port's
    names (mha_reference is mha_plain here), plus the LN -> matmul ops."""
    import uml_tpu.ops as jops

    renamed = {"mha_reference": "mha_plain"}
    for name in ("multi_head_attention", "mha_reference", "flash_attention",
                 "dense_attention_bshd", "layer_norm", "ln_attn_block_q8",
                 "ln_mlp_block_q8", "quantize_weight"):
        assert name in jops.__all__
        assert callable(getattr(tops, renamed.get(name, name)))
    assert "ln_qkv_attention" in tops.__all__
    # ln_matmul stays the module: its ops are reached through it
    assert callable(tops.ln_matmul.ln_matmul)
    assert callable(tops.ln_matmul.add_ln_matmul)


def test_launch_counters_stay_zero_on_the_cpu():
    """A CPU tensor takes the plain version: no wrapper counts a launch."""
    for fn in (tlm.ln_matmul, tlm.add_ln_matmul, tops.ln_qkv_attention,
               tops.layer_norm, tops.flash_attention):
        assert fn.launches == 0


def test_auto_is_the_kernel_on_the_card_and_the_plain_version_on_the_cpu():
    """The impl knob: "pallas" and, for a tensor on the card, "auto" take
    the kernel wrapper (which launches or raises, whatever the shape and
    dtype); "auto" on the CPU and any other value take the plain version."""
    from types import SimpleNamespace

    from uml_tpu_torch.ops._build import wants_kernel

    card, cpu = SimpleNamespace(is_cuda=True), torch.zeros(1)
    assert wants_kernel("auto", card) and wants_kernel("pallas", card)
    assert wants_kernel("pallas", cpu) and not wants_kernel("auto", cpu)
    for impl in ("reference", "fused", "whatever"):
        assert not wants_kernel(impl, card) and not wants_kernel(impl, cpu)


def test_attention_entry_points_default_to_non_causal():
    """Every attention entry point takes (q, k, v) alone, as uml_tpu's."""
    jargs, targs = _cast(_qkv(9, (1, 2, 11, 64)), jnp.float32, torch.float32,
                         (0, 1, 2))
    want = jat.mha_reference(*jargs)
    for fn in (tops.flash_attention, tat.attention_plain, tops.mha_plain,
               tops.multi_head_attention):
        _close(fn(*targs), want, 2e-5)
    _close(tops.dense_attention_bshd(*(t.transpose(1, 2) for t in targs)),
           jnp.swapaxes(want, 1, 2), 2e-5)
