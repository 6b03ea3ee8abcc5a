"""The int8 MLP in's two-pass form, and the int8 attention output's
quantization, on the CPU against the one-pass form and against uml_tpu.

On the card the int8 MLP in runs c_fc twice (``ops/gemm.py::q8_gemm``
ROWMAX, then ACTQ): the first pass folds the max of pre + b1 over each
128 columns of a row into the row's max (an atomicMax of ordered ints,
``gemm._ordered``), the second recomputes pre + b1 and quantizes
quick_gelu of it with the row's scale from that max, so no fp32
pre-activation is stored.  Here its plain twin (and ``q8_gemm``'s plain
version, which a CPU tensor takes) is held to ``quant.act_quantize_rows``
on the one-pass pre-activation, bit for bit (``torch.equal``: the same
fp32 values, and a max does not depend on its order), at M = 3,072 and M =
192 (whose last column tile holds 64), at one image's 197 rows and a
count past it, and on rows whose max sits on quick_gelu's negative lobe
(the scale is then the lobe's bound).  Against uml_tpu's
``_act_quantize_rows``: integers equal except one step on at most 0.1% of
the entries, scales within rtol 1e-6 (``test_torch_quant.py``'s
row-quantizer tolerance).

The int8 attention half quantizes the fp32 attention output, as the
Pallas kernel does (F6): ``qkv_attention_q8_plain`` against uml_tpu's
int8 QKV product and ``mha_reference`` in fp32 on the same inputs, within
2^-8 of the largest attention value (the port rounds P to bf16 once, the
reference keeps it fp32), and the quantized integers within one step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import quant as jq
from uml_tpu.ops.ln_matmul import _ACTIVATIONS
from uml_tpu_torch.ops import gemm
from uml_tpu_torch.ops import quant as tq

FLIP_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pre(rows, m, lobe, seed):
    """fp32 pre-activation [rows, m] and bias [m]; with ``lobe`` every
    other row lies below zero, so its max sits on the negative lobe."""
    rng = np.random.default_rng(seed)
    pre = (rng.standard_normal((rows, m)) * 2.0).astype(np.float32)
    if lobe:
        pre[::2] = -np.abs(pre[::2]) - 0.25
    b1 = (0.02 * rng.standard_normal(m)).astype(np.float32)
    return torch.from_numpy(pre), torch.from_numpy(b1)


def two_pass_act_quantize(pre, b1):
    """The card's two passes in plain PyTorch: the max of pre + b1 over each
    128 columns of a row (the engine's column tile, whose max the ROWMAX
    pass folds into the row's), reduced over the tiles; then pre + b1
    recomputed and quantized with the row's scale from that max."""
    partial = torch.stack([t.amax(-1) for t in (pre + b1).split(128, -1)])
    return tq.act_quantize_rows(pre + b1, "quick_gelu",
                                rowmax=partial.amax(0)[:, None])


@pytest.mark.parametrize("lobe", [False, True])
@pytest.mark.parametrize("rows", [197, 394])
@pytest.mark.parametrize("m", [3072, 192])
def test_two_pass_equals_act_quantize_rows(m, rows, lobe):
    pre, b1 = _pre(rows, m, lobe, seed=m + rows)
    q, scale = two_pass_act_quantize(pre, b1)
    want_q, want_s = tq.act_quantize_rows(pre + b1, "quick_gelu")
    assert q.dtype == torch.int8 and torch.equal(q, want_q)
    assert torch.equal(scale, want_s)
    if lobe:
        assert torch.all(scale[::2] == torch.tensor(tq.ACT_NEG_LOBE["quick_gelu"])
                         / tq.INT8_MAX)


@pytest.mark.parametrize("lobe", [False, True])
@pytest.mark.parametrize("m", [3072, 192])
def test_q8_gemm_rowmax_then_actq_equals_f32_then_act_quantize(m, lobe):
    """``q8_gemm`` on a CPU tensor (its plain version): ROWMAX's row
    maxima, then ACTQ, give the integers and scales of the F32 product
    followed by act_quantize_rows."""
    rng = np.random.default_rng(m)
    rows, k = 197, 128
    a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    rs = torch.from_numpy((rng.random(rows) * 0.02 + 1e-3).astype(np.float32))
    cs = torch.from_numpy((rng.random(m) * 0.02 + 1e-3).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(m)).astype(np.float32))
    if lobe:
        rs[::2] *= 1e-3
        bias = -bias.abs() - 0.2
    n = gemm.q8_gemm.launches
    rowmax = gemm.q8_gemm(a, w, rs, cs, bias, epi="ROWMAX")
    q, scale = gemm.q8_gemm(a, w, rs, cs, bias, epi="ACTQ", rowmax=rowmax)
    assert gemm.q8_gemm.launches == n          # the CPU runs no kernel
    pre = gemm.q8_gemm(a, w, rs, cs, bias, epi="F32")
    want_q, want_s = tq.act_quantize_rows(pre, "quick_gelu")
    assert torch.equal(rowmax, pre.amax(-1))
    assert torch.equal(q, want_q) and torch.equal(scale, want_s[:, 0])
    if lobe:
        assert (pre[::2].amax(-1) < 0).all()


@pytest.mark.parametrize("m", [3072, 192])
def test_q8_gemm_abs_max_then_quant_equals_f32_then_quantize_rows(m):
    """Without an activation (uml_tpu's identity): ``q8_gemm``'s ROWMAX
    pass keeps each row's max of |y + b| and ACTQ quantizes y + b itself
    with it, the integers and scales of the F32 product followed by
    ``quantize_rows``, bit for bit (every other row below zero, so its
    abs-max is its min)."""
    rng = np.random.default_rng(3 * m)
    rows, k = 197, 128
    a = torch.from_numpy(rng.integers(-127, 128, (rows, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    rs = torch.from_numpy((rng.random(rows) * 0.02 + 1e-3).astype(np.float32))
    cs = torch.from_numpy((rng.random(m) * 0.02 + 1e-3).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(m)).astype(np.float32))
    a[::2] = -a[::2].abs() - 1
    w = w.abs()
    absmax = gemm.q8_gemm(a, w, rs, cs, bias, epi="ROWMAX", activation=None)
    q, scale = gemm.q8_gemm(a, w, rs, cs, bias, epi="ACTQ", rowmax=absmax,
                            activation=None)
    pre = gemm.q8_gemm(a, w, rs, cs, bias, epi="F32")
    want_q, want_s = tq.quantize_rows(pre)
    assert torch.equal(absmax, pre.abs().amax(-1))
    assert (pre[::2].amax(-1) < 0).all() and (absmax[::2] > 0).all()
    assert torch.equal(q, want_q) and torch.equal(scale, want_s[:, 0])


def test_ordered_ints_keep_the_order_of_the_floats():
    """The ROWMAX pass keeps a row's max as an int whose signed order is the
    floats' (``gemm._ordered``, the kernels' q8_ordered): the map is its own
    inverse, and the max of the ints is the int of the max, -0, the
    infinities and subnormals included."""
    rng = np.random.default_rng(0)
    f = np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 30, 4096),
                        [0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45]]).astype(np.float32)
    t = torch.from_numpy(f)
    o = gemm._ordered(t.view(torch.int32))
    assert torch.equal(gemm._ordered(o).view(torch.float32), t)
    ranks = torch.argsort(o, stable=True)
    assert torch.all(t[ranks][1:] >= t[ranks][:-1])
    for rows in (t[:4096].view(64, 64), -t[-4096:].reshape(64, 64)):
        got = gemm._ordered(gemm._ordered(rows.contiguous().view(torch.int32)).amax(-1))
        assert torch.equal(got.view(torch.float32), rows.amax(-1))


@pytest.mark.parametrize("lobe", [False, True])
@pytest.mark.parametrize("m", [3072, 192])
def test_two_pass_matches_uml_tpu(m, lobe):
    pre, b1 = _pre(197, m, lobe, seed=7 * m)
    q, scale = two_pass_act_quantize(pre, b1)
    jq_, js = jq._act_quantize_rows(jnp.asarray((pre + b1).numpy()), "quick_gelu",
                                    _ACTIVATIONS)
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq_).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= FLIP_SHARE, (diff > 0).mean()
    np.testing.assert_allclose(scale.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("s", [17, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_int8_attention_output_matches_uml_tpu(s, causal):
    """F6's repair: the int8 half quantizes the fp32 attention output
    (``qkv_attention_q8_plain``, P rounded once to bf16 against the row's
    max), as the Pallas kernel does.  Against uml_tpu's functions on the
    same inputs: its int8 QKV product (``_ln_quantize_rows``, ``_q8_dot``,
    bf16 qkv) and ``mha_reference`` over that qkv in fp32 (fp32 scores,
    P unrounded), then ``_quantize_rows``: the attention within 2^-8 of
    its largest value, the integers within one step."""
    from uml_tpu.ops.attention import mha_reference

    heads, k, b = 2, 128, 2
    rng = np.random.default_rng(s + causal)
    x = rng.standard_normal((b, s, k)).astype(np.float32) * 0.5
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    w = rng.standard_normal((k, 3 * k)).astype(np.float32) * k ** -0.5
    b_eff = (0.02 * rng.standard_normal(3 * k)).astype(np.float32)
    wq, wsc = jq.quantize_weight(jnp.asarray(w))
    xq, xs = jq._ln_quantize_rows(jnp.asarray(xb.reshape(b * s, k)), 1e-5)
    qkv = (jq._q8_dot(xq, xs, wq, wsc) + b_eff).astype(jnp.bfloat16)
    qkv = qkv.astype(jnp.float32).reshape(b, s, 3, heads, 64).transpose(2, 0, 3, 1, 4)
    want = mha_reference(qkv[0], qkv[1], qkv[2], causal=causal)
    want = np.array(want.transpose(0, 2, 1, 3).reshape(b * s, heads * 64))
    got = tq.qkv_attention_q8_plain(torch.from_numpy(xb).to(torch.bfloat16),
                                    torch.from_numpy(np.array(wq)),
                                    torch.from_numpy(np.array(wsc)),
                                    torch.from_numpy(b_eff), heads=heads,
                                    causal=causal).reshape(b * s, -1)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 2.0 ** -8 * np.abs(want).max()
    q, _ = tq.quantize_rows(got)
    jq_, _ = jq._quantize_rows(jnp.asarray(want))
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(jq_).astype(np.int32))
    assert diff.max() <= 1, diff.max()
