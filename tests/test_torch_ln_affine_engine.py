"""Rows 14-17 on the wgmma engine, on the CPU: the LN pre-pass of the
affine and add prologues, the engine's exact-GELU epilogue, the C
entries' argument lists, and the profile filter of ``chip_smoke.py``.

On the card ``ln_matmul`` (rows 14, 15), ``add_ln_matmul`` (row 16) and
``ln_qkv_attention``'s QKV product (row 17) are two launches: the LN
pre-pass (``csrc/ln_gemm.cuh::ln_rows_kernel<PRO_LN_AFFINE |
PRO_ADD_LN_AFFINE>``) writes xn (and t), then ``wgmma_gemm_kernel`` runs
xn . w with the bias and the activation in its epilogue.  Their plain
forms (``ln_affine_rows_plain``, ``add_ln_affine_rows_plain`` and the
AFFINE* / ADD* triples of ``ops/gemm.py``) are held here, at K = 128, N in
{128, 192} and rows in {1, 127, 129, 2 x 197} (both sides of the engine's
128-row tile), on numpy inputs from a seed:

* composed, they give ``ln_matmul_plain`` / ``add_ln_matmul_plain`` (the
  ops' twins of uml_tpu's jnp references) bit for bit, in bf16;
* against uml_tpu's Pallas ``_ln_matmul_kernel``, ``_ln_matmul_kernel_3d``
  and ``_add_ln_matmul_kernel`` in interpret mode, called as
  tests/test_torch_unfused_ops.py calls them, at that file's tolerances:
  bf16 outputs within 2^-6 of the largest entry, t bit for bit; the fp32
  pre-pass alone (the Pallas kernels with an identity weight return the
  normalized rows) within 1e-5;
* the exact-GELU epilogue's plain form (``gelu_exact_f32`` of the fp32
  pre-activation, rounded to bf16 once) within one bf16 rounding of
  uml_tpu's ``_gelu_exact_f32``, and in fp32 within 5e-4 of the Pallas
  kernel, which fits erf-GELU by a sigmoid of a quintic (max abs err
  7.8e-5 before the product amplifies it).
"""

import contextlib
import ctypes
import importlib.util
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uml_tpu.ops import fused_attention as jfa
from uml_tpu.ops import ln_matmul as jlm
from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops import fused_attention as tfa
from uml_tpu_torch.ops import gemm as gm
from uml_tpu_torch.ops import ln_matmul as tlm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 128
ROWS = [1, 127, 129, 2 * 197]
NS = [128, 192]
ACTS = {None: "", "quick_gelu": "_QUICK_GELU", "gelu_exact": "_GELU_EXACT"}
BF16_REL = 2.0 ** -6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, rows, n):
    """fp32 numpy (x, delta, scale, bias, w, b): x and delta [rows, K]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return [rng.standard_normal((rows, K)).astype(f),
            rng.standard_normal((rows, K)).astype(f),
            (1 + 0.1 * rng.standard_normal(K)).astype(f),
            (0.1 * rng.standard_normal(K)).astype(f),
            (rng.standard_normal((K, n)) / np.sqrt(K)).astype(f),
            (0.1 * rng.standard_normal(n)).astype(f)]


def _torch(arrays, dtype):
    """x, delta and w in ``dtype``; scale, bias and b stay fp32."""
    return [torch.tensor(a).to(dtype if i in (0, 1, 4) else torch.float32)
            for i, a in enumerate(arrays)]


def _jax(arrays, dtype):
    return [jnp.asarray(a, dtype if i in (0, 1, 4) else jnp.float32)
            for i, a in enumerate(arrays)]


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close_bf16(got, want):
    got, want = got.float().numpy(), _np(want)
    assert got.shape == want.shape
    err, bound = np.abs(got - want).max(), BF16_REL * np.abs(want).max()
    assert err <= bound, f"max abs err {err} > {bound}"


# -- the pre-pass and the product compose to the ops' twins, bit for bit -----

@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("rows", ROWS)
def test_affine_prepass_and_product_give_ln_matmul_plain(rows, n, act):
    x, _, scale, bias, w, b = _torch(_inputs(rows + n, rows, n), torch.bfloat16)
    got = gm.ln_gemm(x, w, b, triple="AFFINE" + ACTS[act], ln=(scale, bias))
    want = tlm.ln_matmul_plain(x, scale, bias, w, b, activation=act)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # the pieces: the pre-pass's xn is the twin's rounded operand
    xn = tlm.ln_affine_rows_plain(x, scale, bias)
    assert torch.equal(gm.ln_gemm_plain(x, w, b, triple="AFFINE", ln=(scale, bias)),
                       (xn.float() @ w.float() + b).to(torch.bfloat16))
    if rows == 2 * 197:     # the 3-d form is the same rows
        want3 = tlm.ln_matmul_plain(x.view(2, 197, K), scale, bias, w, b,
                                    activation=act)
        assert torch.equal(got, want3.view(rows, n))


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("rows", ROWS)
def test_add_prepass_and_product_give_add_ln_matmul_plain(rows, n, act):
    x, delta, scale, bias, w, b = _torch(_inputs(rows + n + 1, rows, n),
                                         torch.bfloat16)
    out, t = gm.ln_gemm(x, w, b, triple="ADD" + ACTS[act], ln=(scale, bias),
                        delta=delta)
    t_want, out_want = tlm.add_ln_matmul_plain(x, delta, scale, bias, w, b,
                                               activation=act)
    assert torch.equal(t, t_want) and torch.equal(out, out_want)
    # t is one rounding of the fp32 sum, and the pre-pass normalizes the
    # unrounded sum, not t
    t2, xn = tlm.add_ln_affine_rows_plain(x, delta, scale, bias)
    assert torch.equal(t2, (x.float() + delta.float()).to(torch.bfloat16))
    assert torch.equal(xn, tlm.ln_affine_rows_plain(
        (x.float() + delta.float()), scale, bias).to(torch.bfloat16))


# -- the plain forms against uml_tpu's Pallas kernels (interpret mode) --------

@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("rows", ROWS)
def test_affine_triples_match_the_pallas_kernels(rows, act):
    arrays = _inputs(7 * rows, rows, 192)
    x, _, scale, bias, w, b = _torch(arrays, torch.bfloat16)
    jx, _, js, jb, jw, jbb = _jax(arrays, jnp.bfloat16)
    w_eff, b_eff = jfa.fold_ln_into_matmul(js, jb, jw, jbb)
    got = gm.ln_gemm(x, w, b, triple="AFFINE" + ACTS[act], ln=(scale, bias))
    _close_bf16(got, jlm._ln_matmul_fwd_impl(jx, w_eff, b_eff, 1e-5, 256, True, act))
    pallas3 = jlm._ln_matmul_fwd_3d(jx.reshape(1, rows, K), w_eff, b_eff, 1e-5, 1,
                                    True, act)
    _close_bf16(got, pallas3.reshape(rows, 192))


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("rows", ROWS)
def test_add_triples_match_the_pallas_kernel(rows, act):
    arrays = _inputs(11 * rows, rows, 192)
    x, delta, scale, bias, w, b = _torch(arrays, torch.bfloat16)
    jargs = _jax(arrays, jnp.bfloat16)
    jx, jd = (a.reshape(1, rows, K) for a in jargs[:2])
    t_pal, out_pal = jlm._add_ln_matmul_fwd_3d(jx, jd, *jargs[2:], 1e-5, act, True)
    out, t = gm.ln_gemm(x, w, b, triple="ADD" + ACTS[act], ln=(scale, bias),
                        delta=delta)
    np.testing.assert_array_equal(t.float().numpy(), _np(t_pal).reshape(rows, K))
    _close_bf16(out, out_pal.reshape(rows, 192))


@pytest.mark.parametrize("rows", ROWS)
def test_prepass_plain_forms_match_the_pallas_kernels_fp32(rows):
    """With an identity weight and no bias the Pallas kernels return their
    normalized rows (the LN affine folded into diag(scale) and the bias):
    the pre-passes' xn and t in fp32 within 1e-5."""
    arrays = _inputs(13 * rows, rows, K)
    x, delta, scale, bias, _, _ = _torch(arrays, torch.float32)
    jx, jd, js, jb, _, _ = _jax(arrays, jnp.float32)
    eye, zero = jnp.eye(K, dtype=jnp.float32), jnp.zeros(K, jnp.float32)
    w_eff, b_eff = jfa.fold_ln_into_matmul(js, jb, eye, zero)
    xn = tlm.ln_affine_rows_plain(x, scale, bias)
    np.testing.assert_allclose(
        xn.numpy(), _np(jlm._ln_matmul_fwd_impl(jx, w_eff, b_eff, 1e-5, 256, True)),
        atol=1e-5)
    t, xn_add = tlm.add_ln_affine_rows_plain(x, delta, scale, bias)
    t_pal, xn_pal = jlm._add_ln_matmul_fwd_3d(jx[None], jd[None], js, jb, eye, zero,
                                              1e-5, None, True)
    np.testing.assert_allclose(t.numpy(), _np(t_pal[0]), atol=1e-5)
    np.testing.assert_allclose(xn_add.numpy(), _np(xn_pal[0]), atol=1e-5)


@pytest.mark.parametrize("rows", ROWS)
def test_gelu_exact_epilogue_matches_uml_tpu(rows):
    """The epilogue's plain form on the fp32 pre-activation y of the plain
    pre-pass and product: rounded once to bf16, within one bf16 rounding
    (2^-8 relative) of uml_tpu's erf GELU; in fp32, within 5e-4 of the
    Pallas kernel's sigmoid-quintic fit."""
    arrays = _inputs(17 * rows, rows, 192)
    x, _, scale, bias, w, b = _torch(arrays, torch.float32)
    jx, _, js, jb, jw, jbb = _jax(arrays, jnp.float32)
    y = tlm.ln_affine_rows_plain(x, scale, bias) @ w + b
    want = _np(jlm._gelu_exact_f32(jnp.asarray(y.numpy())))
    got = tlm.gelu_exact_f32(y)
    rounded = got.to(torch.bfloat16).float().numpy()
    assert np.all(np.abs(rounded - want) <= 2.0 ** -8 * np.abs(want) + 1e-6)
    w_eff, b_eff = jfa.fold_ln_into_matmul(js, jb, jw, jbb)
    pallas = jlm._ln_matmul_fwd_impl(jx, w_eff, b_eff, 1e-5, 256, True, "gelu_exact")
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=5e-4, rtol=5e-4)


# -- the C entries and the wrappers that call them ----------------------------

_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "float": ctypes.c_float,
           "long long": ctypes.c_longlong}


def _c_entries():
    """{name: [ctypes types]} of every ``extern "C"`` function in
    csrc/*.cu, parsed from its parameter list."""
    entries = {}
    for path in sorted(os.listdir(_build.CSRC)):
        if not path.endswith(".cu"):
            continue
        with open(os.path.join(_build.CSRC, path)) as f:
            src = f.read()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
            types_ = []
            for p in params.split(","):
                ctype = " ".join(p.split()[:-1]).replace(" *", "*")
                types_.append(_CTYPES[ctype])
            entries[name] = types_
    return entries


def test_signatures_match_the_c_entries():
    entries = _c_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert argtypes == entries[name], name


@pytest.fixture
def recorder(monkeypatch):
    """Replace the C call (and the CUDA device context around it) with a
    recorder of each call's name and arguments; the wrappers then run on
    meta tensors, whose pointers are 0."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("act", list(ACTS))
def test_the_wrappers_pass_an_xn_scratch(recorder, act):
    """Each wrapper hands its C entry one argument per SIGNATURES entry,
    the row count of x's leading axes and the activation code; the scratch
    xn [rows, K] bf16 is allocated per call."""
    b, s, n = 2, 197, 192
    x, delta = _meta(b, s, K), _meta(b, s, K)
    scale, bias, bb = (_meta(m, dtype=torch.float32) for m in (K, K, n))
    w = _meta(K, n)
    tlm._ln_matmul_fwd(x, scale, bias, w, bb, 1e-5, act)
    tlm._add_ln_matmul_fwd(x, delta, scale, bias, w, bb, 1e-5, act)
    tfa._ln_qkv_attention_fwd(x, scale, bias, _meta(K, 3 * K), _meta(
        3 * K, dtype=torch.float32), 2, False, 1e-5)
    code = {None: 0, "quick_gelu": 1, "gelu_exact": 2}[act]
    (n1, a1), (n2, a2), (n3, a3) = recorder
    assert (n1, n2, n3) == ("uml_ln_matmul", "uml_add_ln_matmul", "uml_ln_qkv_attention")
    for name, args in recorder:
        assert len(args) == len(_build.SIGNATURES[name])
    assert a1[7:11] == (b * s, K, n, code)
    assert a2[9:13] == (b * s, K, n, code)
    assert a3[8:13] == (b, s, K, 2, 0)


def test_ln_gemm_takes_the_ln_operands_of_the_affine_triples(recorder):
    m, n = 129, 192
    a, delta, w = _meta(m, K), _meta(m, K), _meta(K, n)
    ln = (_meta(K, dtype=torch.float32), _meta(K, dtype=torch.float32))
    out, t = gm.ln_gemm(a, w, _meta(n, dtype=torch.float32), triple="ADD_GELU_EXACT",
                        ln=ln, delta=delta)
    assert out.shape == (m, n) and t.shape == (m, K)
    (name, args), = recorder
    assert name == "uml_ln_gemm" and len(args) == len(_build.SIGNATURES[name])
    # pro, epi, trans_b after M, N, K, ldres
    assert args[12:19] == (m, n, K, n, gm.PRO_ADD_LN_AFFINE, gm.EPI_GELU_EXACT, 0)
    with pytest.raises(ValueError):     # delta of another shape
        gm.ln_gemm(a, w, None, triple="ADD", ln=ln, delta=_meta(m + 1, K))


def test_every_affine_triple_has_its_codes():
    assert {name: codes for name, codes in gm.TRIPLES.items()
            if name.startswith(("AFFINE", "ADD"))} == {
        "AFFINE": (2, 0, False), "AFFINE_QUICK_GELU": (2, 1, False),
        "AFFINE_GELU_EXACT": (2, 7, False), "ADD": (3, 0, False),
        "ADD_QUICK_GELU": (3, 1, False), "ADD_GELU_EXACT": (3, 7, False)}
    with open(os.path.join(_build.CSRC, "ln_gemm.cuh")) as f:
        header = f.read()
    assert "PRO_LN_AFFINE = 2, PRO_ADD_LN_AFFINE = 3" in header
    assert "EPI_GELU_EXACT = 7" in header


# -- chip_smoke.py's profile filter -------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(key, device, us, annotation=None):
    from torch.autograd import DeviceType

    ev = types.SimpleNamespace(
        key=key, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        self_device_time_total=us, count=3)
    if annotation is not None:
        ev.is_user_annotation = annotation
    return ev


@pytest.mark.parametrize("flagged", [True, False])
def test_profile_filter_keeps_lambda_kernels_and_drops_annotations(flagged):
    """A kernel named with '#' (PyTorch's elementwise lambdas), a memcpy and
    a memset count as device time; a record_function range's device-side
    row does not, found by ``is_user_annotation`` or, on a build without
    it, by the name its CPU-side event carries; CPU events never count."""
    lam = ("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::(anonymous namespace)::launch_clamp_scalar"
           "(at::TensorIteratorBase&, c10::Scalar, c10::Scalar)::{lambda()#1}"
           "::operator()() const::{lambda(float)#1}, std::array<char*, 2ul> >")
    flag = (lambda v: v) if flagged else (lambda v: None)
    events = [
        _event(lam, True, 40, flag(False)),
        _event("Memcpy HtoD (Pageable -> Device)", True, 7, flag(False)),
        _event("Memset (Device)", True, 2, flag(False)),
        _event("wgmma_gemm_kernel<false, true, 9>", True, 90, flag(False)),
        _event("Optimizer.step#AdamW.step", True, 500, flag(True)),
        _event("Optimizer.step#AdamW.step", False, 0, flag(True)),
        _event("aten::add_", False, 40, flag(False)),
        _event("idle kernel", True, 0, flag(False)),
    ]
    rows = _chip_smoke()._device_rows(events)
    assert [key for key, _, _ in rows] == [
        lam, "Memcpy HtoD (Pageable -> Device)", "Memset (Device)",
        "wgmma_gemm_kernel<false, true, 9>"]
    assert [(t, c) for _, t, c in rows] == [(40, 3), (7, 3), (2, 3), (90, 3)]
