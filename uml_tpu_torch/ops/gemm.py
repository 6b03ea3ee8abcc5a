"""One product of the CUDA kernels on its own, with its plain version.

``ln_gemm`` launches one (prologue, epilogue, layout) triple of
``csrc/ln_gemm.cuh`` through ``csrc/gemm.cu``, ``gemm_at`` one weight-
gradient product of ``csrc/gemm_at.cuh``, ``q8_gemm`` one int8 product of
``csrc/q8_gemm.cuh``.  They are the products that the half-blocks (#1-#5,
#9, #10 with a bf16 out-projection), the training rows #6, #7, #8, #19
and #20, the int8 rows #10-#12 and the stand-alone ops #14-#17 launch
inside their own C calls, on the wgmma engine of
``csrc/wgmma_gemm.cuh``; no model calls these wrappers.
The card tests hold each against its plain version, and
``chip_smoke.py`` times each beside one cuBLAS call at its shape
(``torch.matmul``, or ``torch._int_mm`` for the int8 products).

The triples, as ``(pro, epi, trans_b)``:

* ``QKV`` (PRO_LN, EPI_NONE, False): bf16(rawLN(a)) @ w + bias -> bf16;
* ``TRANS_B`` (PRO_NONE, EPI_NONE, True): a @ w^T -> bf16 (g . wo^T);
* ``TRANS_B_F32`` (PRO_NONE, EPI_F32, True): a @ w^T -> fp32 (dqkv .
  W_eff^T, g . w2^T, dpre . w1^T);
* ``DACT_F32`` (PRO_LN, EPI_DACT_F32, False): y = bf16(rawLN(a)) @ w +
  bias in fp32 -> (dpre = bf16(dy * quick_gelu'(y)), yact =
  bf16(quick_gelu(y)), the column sums of the fp32 dpre per 128-row tile)
  with dy [M, N] fp32 (row 20);
* ``DACT`` (PRO_LN, EPI_DACT, False): the same with dy [M, N] bf16 and no
  column sums -> (dpre, yact) (row 19);
* ``DACT_EXACT``, ``DACT_F32_EXACT`` (PRO_LN, EPI_DACT_EXACT /
  EPI_DACT_F32_EXACT, False): the two with exact GELU, dpre = bf16(dy *
  (Phi(y) + y phi(y))), yact = bf16(y Phi(y)) (DINO's rows 19 and 20);
* ``QUICK_GELU`` (PRO_LN, EPI_QUICK_GELU, False): y = bf16(rawLN(a)) @ w
  + bias in fp32 -> bf16(quick_gelu(y)) (the MLP in); ``GELU_EXACT``
  (PRO_LN, EPI_GELU_EXACT, False) the same with exact GELU (DINO's MLP in);
* ``GELU_STASH`` (PRO_LN, EPI_GELU_STASH, False): the same -> (bf16(
  quick_gelu(y)), bf16(y)), the activation of the unrounded y (the MLP in
  of the training forward, with its pre-activation stash);
  ``GELU_EXACT_STASH`` (PRO_LN, EPI_GELU_EXACT_STASH, False) the same with
  exact GELU (DINO's row 9);
* ``RESIDUAL`` (PRO_NONE, EPI_RESIDUAL, False): bf16(a @ w + bias + res)
  with res [M, N] bf16 (the out-projections and the MLP out);
* ``AFFINE``, ``AFFINE_QUICK_GELU``, ``AFFINE_GELU_EXACT`` (PRO_LN_AFFINE,
  EPI_NONE / EPI_QUICK_GELU / EPI_GELU_EXACT, False): act(bf16(LN_affine(a))
  @ w + bias) -> bf16, the LN scale and bias ``ln`` applied in the
  pre-pass (rows 14, 15, and 17's QKV);
* ``ADD``, ``ADD_QUICK_GELU``, ``ADD_GELU_EXACT`` (PRO_ADD_LN_AFFINE, the
  same epilogues, False): the same of t32 = a + delta -> (out, bf16(t32))
  (row 16).

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises (bf16 operands, N and K multiples of 64;
gemm_at: P and N multiples of 64, any row count; q8_gemm: int8 operands,
the weight K-major [N, K]).  Every triple here runs on the engine.
``q8_gemm``'s ROWMAX and ACTQ are the two passes of the int8 MLP in
(rows #11, #12): each row's max of y + b, then the int8 hidden of
act(y + b) (quick_gelu, or exact GELU for DINO) with the row's scale from
that max: F32 followed by ``quant.act_quantize_rows``.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.ln_matmul import (act_and_grad,
                                         add_ln_affine_rows_plain,
                                         gelu_exact_f32, ln_affine_rows_plain,
                                         ln_rows_plain, quick_gelu_f32)
from uml_tpu_torch.ops.quant import Q8_MLP_ACT, act_quantize_rows, q8_dot

PRO_NONE, PRO_LN, PRO_LN_AFFINE, PRO_ADD_LN_AFFINE = 0, 1, 2, 3
EPI_NONE, EPI_QUICK_GELU, EPI_RESIDUAL, EPI_GELU_STASH = 0, 1, 2, 3
EPI_F32, EPI_DACT, EPI_DACT_F32, EPI_GELU_EXACT = 4, 5, 6, 7
EPI_GELU_EXACT_STASH, EPI_DACT_EXACT, EPI_DACT_F32_EXACT = 8, 9, 10
# the recompute epilogues: their activation, and whether dy is fp32
DACT_EPIS = {EPI_DACT: ("quick_gelu", False), EPI_DACT_F32: ("quick_gelu", True),
             EPI_DACT_EXACT: ("gelu_exact", False),
             EPI_DACT_F32_EXACT: ("gelu_exact", True)}
STASH_EPIS = {EPI_GELU_STASH: quick_gelu_f32, EPI_GELU_EXACT_STASH: gelu_exact_f32}
TRIPLES = {"QKV": (PRO_LN, EPI_NONE, False),
           "TRANS_B": (PRO_NONE, EPI_NONE, True),
           "TRANS_B_F32": (PRO_NONE, EPI_F32, True),
           "DACT": (PRO_LN, EPI_DACT, False),
           "DACT_F32": (PRO_LN, EPI_DACT_F32, False),
           "DACT_EXACT": (PRO_LN, EPI_DACT_EXACT, False),
           "DACT_F32_EXACT": (PRO_LN, EPI_DACT_F32_EXACT, False),
           "QUICK_GELU": (PRO_LN, EPI_QUICK_GELU, False),
           "GELU_EXACT": (PRO_LN, EPI_GELU_EXACT, False),
           "GELU_STASH": (PRO_LN, EPI_GELU_STASH, False),
           "GELU_EXACT_STASH": (PRO_LN, EPI_GELU_EXACT_STASH, False),
           "RESIDUAL": (PRO_NONE, EPI_RESIDUAL, False),
           **{f"{name}{tag}": (pro, epi, False)
              for name, pro in (("AFFINE", PRO_LN_AFFINE),
                                ("ADD", PRO_ADD_LN_AFFINE))
              for tag, epi in (("", EPI_NONE), ("_QUICK_GELU", EPI_QUICK_GELU),
                               ("_GELU_EXACT", EPI_GELU_EXACT))}}
ROW_TILE = 128  # rows of the engine's tile: one column-sum partial each
MAX_SPLITS = 8  # gemm_at's row chunks at most (GAT_MAX_SPLITS, gemm_at.cuh)


def ln_gemm_plain(a, w, bias=None, res=None, *, triple: str, eps: float = 1e-5,
                  ln=None, delta=None):
    """Plain version of ``ln_gemm``: the plain form of the triple's LN
    pre-pass, fp32 products of the bf16 operands, one rounding at the end,
    as the kernel computes them."""
    pro, epi, trans_b = TRIPLES[triple]
    t = None
    if pro == PRO_LN:
        x = ln_rows_plain(a, eps)
    elif pro == PRO_LN_AFFINE:
        x = ln_affine_rows_plain(a, *ln, eps)
    elif pro == PRO_ADD_LN_AFFINE:
        t, x = add_ln_affine_rows_plain(a, delta, *ln, eps)
    else:
        x = a
    y = x.float() @ (w.float().t() if trans_b else w.float())
    if bias is not None:
        y = y + bias.float()
    if epi in (EPI_NONE, EPI_QUICK_GELU, EPI_GELU_EXACT):
        act = {EPI_NONE: lambda v: v, EPI_QUICK_GELU: quick_gelu_f32,
               EPI_GELU_EXACT: gelu_exact_f32}[epi]
        out = act(y).to(torch.bfloat16)
        return out if t is None else (out, t)
    if epi == EPI_F32:
        return y
    if epi == EPI_RESIDUAL:
        return (y + res.float()).to(torch.bfloat16)
    if epi in STASH_EPIS:
        return STASH_EPIS[epi](y).to(torch.bfloat16), y.to(torch.bfloat16)
    activation, dy_f32 = DACT_EPIS[epi]
    act, dact = act_and_grad(y, activation)
    d = res.float() * dact
    if not dy_f32:
        return d.to(torch.bfloat16), act.to(torch.bfloat16)
    rows = d.shape[0]
    pad = -rows % ROW_TILE
    part = torch.cat([d, d.new_zeros(pad, d.shape[1])]).view(
        -1, ROW_TILE, d.shape[1]).sum(1)
    return d.to(torch.bfloat16), act.to(torch.bfloat16), part


def ln_gemm(a, w, bias=None, res=None, *, triple: str, eps: float = 1e-5,
            ln=None, delta=None):
    """a [M, K] bf16; w [K, N] (or [N, K] for the TRANS_B triples) bf16;
    bias [N] fp32 or None; res: dy [M, N] fp32 (DACT_F32*) or bf16 (DACT*),
    or the residual [M, N] bf16 (RESIDUAL); ln: the LN (scale, bias), [K]
    fp32 each (the AFFINE and ADD triples); delta [M, K] bf16 (the ADD
    triples) -> the triple's outputs (see the module docstring)."""
    if a.device.type == "cpu":
        return ln_gemm_plain(a, w, bias, res, triple=triple, eps=eps, ln=ln,
                             delta=delta)
    pro, epi, trans_b = TRIPLES[triple]
    m, k = a.shape
    n = w.shape[0] if trans_b else w.shape[1]
    _build.check_dims(N=n, K=k)
    bf16, f32, dev = torch.bfloat16, torch.float32, a.device
    _build.check_tensor("a", a, bf16, (m, k), dev)
    _build.check_tensor("w", w, bf16, (n, k) if trans_b else (k, n), dev)
    if bias is not None:
        _build.check_tensor("bias", bias, f32, (n,), dev)
    part_out = epi in DACT_EPIS and DACT_EPIS[epi][1]   # dy fp32, column sums
    if epi in DACT_EPIS:
        _build.check_tensor("dy", res, f32 if part_out else bf16, (m, n), dev)
    if epi == EPI_RESIDUAL:
        _build.check_tensor("res", res, bf16, (m, n), dev)
    ln_scale = ln_bias = None
    if pro in (PRO_LN_AFFINE, PRO_ADD_LN_AFFINE):
        ln_scale, ln_bias = ln
        _build.check_tensor("ln scale", ln_scale, f32, (k,), dev)
        _build.check_tensor("ln bias", ln_bias, f32, (k,), dev)
    if pro == PRO_ADD_LN_AFFINE:
        _build.check_tensor("delta", delta, bf16, (m, k), dev)
    with torch.cuda.device(dev):
        out = torch.empty((m, n), dtype=f32 if epi == EPI_F32 else bf16,
                          device=dev)
        xn = torch.empty_like(a) if pro != PRO_NONE else None
        t = torch.empty_like(a) if pro == PRO_ADD_LN_AFFINE else None
        aux = part = None
        if epi in DACT_EPIS or epi in STASH_EPIS:
            aux = torch.empty((m, n), dtype=bf16, device=dev)
        if part_out:
            part = torch.empty((-(-m // ROW_TILE), n), dtype=f32, device=dev)
        ptr = _build.ptr
        _build.launch("uml_ln_gemm", a.data_ptr(), w.data_ptr(), ptr(bias),
                      ptr(res), out.data_ptr(), ptr(aux), ptr(part), ptr(xn),
                      ptr(ln_scale), ptr(ln_bias), ptr(delta), ptr(t),
                      m, n, k, n, pro, epi, int(trans_b), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    ln_gemm.launches += 1
    if part_out:
        return out, aux, part
    if t is not None:
        return out, t
    return out if aux is None else (out, aux)


ln_gemm.launches = 0


def gemm_at_plain(a, b):
    """a [R, P], b [R, N] bf16 -> a^T b [P, N] in fp32."""
    return a.float().t() @ b.float()


def gemm_at(a, b, *, splits: int = 0):
    """a^T b with fp32 accumulation: a [R, P], b [R, N] bf16 -> [P, N]
    fp32.  ``splits``: the row chunks the kernel adds in order (1 ..
    MAX_SPLITS), or 0 for the launcher's choice; a workspace for the
    chunks' partials is allocated here."""
    if not 0 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits={splits}: takes 0 .. {MAX_SPLITS}")
    if a.device.type == "cpu":
        return gemm_at_plain(a, b)
    r, p = a.shape
    n = b.shape[1]
    _build.check_dims(P=p, N=n)
    dev = a.device
    _build.check_tensor("a", a, torch.bfloat16, (r, p), dev)
    _build.check_tensor("b", b, torch.bfloat16, (r, n), dev)
    with torch.cuda.device(dev):
        c = torch.empty((p, n), dtype=torch.float32, device=dev)
        slabs = (splits or MAX_SPLITS) - 1
        ws = torch.empty((max(slabs, 1), p, n), dtype=torch.float32, device=dev)
        _build.launch("uml_gemm_at", a.data_ptr(), b.data_ptr(), c.data_ptr(),
                      ws.data_ptr(), slabs * p * n, r, p, n, splits,
                      torch.cuda.current_stream(dev).cuda_stream)
    gemm_at.launches += 1
    return c


gemm_at.launches = 0


Q8_EPIS = {"BF16": 0, "F32": 1, "RESIDUAL": 2, "ROWMAX": 3, "ACTQ": 4}  # Q8_EPI_*
# ACTQ's epilogue by activation: Q8_EPI_ACTQ, Q8_EPI_ACTQ_GELU
Q8_ACTQ_EPI = {"quick_gelu": 4, "gelu_exact": 5}


def _ordered(bits):
    """int32 bits of fp32 values <-> ints whose signed order is the floats'
    (q8_gemm.cuh's q8_ordered, its own inverse): the form in which the
    ROWMAX pass keeps each row's max."""
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def q8_gemm_plain(a, w, row_scale, col_scale, bias, res=None, *, epi: str,
                  rowmax=None, activation="quick_gelu"):
    """Plain version of ``q8_gemm``: the integer product exact, then the
    epilogue in q8_gemm.cuh's order, each step rounded on its own.
    ROWMAX: each row's max of y + b -> [M]; ACTQ: act(y + b) quantized
    per row with the scale from ``rowmax`` (ROWMAX's output;
    ``quant.act_quantize_rows``' scale) -> (int8 [M, N], scale [M])."""
    y = q8_dot(a, row_scale[:, None], w.t(), col_scale)
    if epi == "RESIDUAL":
        y = res.float() + y
    y = y + bias
    if epi == "ROWMAX":
        return y.amax(-1)
    if epi == "ACTQ":
        q, scale = act_quantize_rows(y, activation, rowmax=rowmax[:, None])
        return q, scale[:, 0]
    return y if epi == "F32" else y.to(torch.bfloat16)


def q8_gemm(a, w, row_scale, col_scale, bias, res=None, *, epi: str,
            rowmax=None, activation="quick_gelu"):
    """a [M, K] int8; w [N, K] int8 (K-major: the transpose of the [in,
    out] kernel); row_scale [M], col_scale [N], bias [N] fp32; res [M, N]
    bf16 (RESIDUAL) -> [M, N]: bf16(y + b) (BF16), y + b in fp32 (F32) or
    bf16((res + y) + b) (RESIDUAL), y = ((float)(a . w^T) * row_scale) *
    col_scale; ROWMAX -> each row's max of y + b, [M] fp32; ACTQ with
    ``rowmax`` (ROWMAX's output) -> (int8 [M, N], fp32 [M]): the int8 MLP
    hidden of ``activation`` ('quick_gelu' or 'gelu_exact') and its row
    scales.  The kernels keep the maxima as ordered ints (``_ordered``);
    this wrapper converts them."""
    if activation not in Q8_MLP_ACT:
        raise ValueError(f"q8_gemm: activation={activation!r}; the ACTQ "
                         f"epilogue takes {list(Q8_MLP_ACT)}")
    if a.device.type == "cpu":
        return q8_gemm_plain(a, w, row_scale, col_scale, bias, res, epi=epi,
                             rowmax=rowmax, activation=activation)
    m, k = a.shape
    n = w.shape[0]
    _build.check_dims(N=n, K=k)
    i8, f32, dev = torch.int8, torch.float32, a.device
    _build.check_tensor("a", a, i8, (m, k), dev)
    _build.check_tensor("w", w, i8, (n, k), dev)
    _build.check_tensor("row_scale", row_scale, f32, (m,), dev)
    _build.check_tensor("col_scale", col_scale, f32, (n,), dev)
    _build.check_tensor("bias", bias, f32, (n,), dev)
    if epi == "RESIDUAL":
        _build.check_tensor("res", res, torch.bfloat16, (m, n), dev)
    if epi == "ACTQ":
        _build.check_tensor("rowmax", rowmax, f32, (m,), dev)
    with torch.cuda.device(dev):
        out = qscale = None
        if epi == "ROWMAX":
            # each row's first value: -inf
            rowmax = _ordered(torch.full((m,), float("-inf"), device=dev)
                              .view(torch.int32))
        elif epi == "ACTQ":
            rowmax = _ordered(rowmax.view(torch.int32))
            out = torch.empty((m, n), dtype=i8, device=dev)
            qscale = torch.empty(m, dtype=f32, device=dev)
        else:
            out = torch.empty((m, n), dtype=f32 if epi == "F32" else torch.bfloat16,
                              device=dev)
        _build.launch("uml_q8_gemm", a.data_ptr(), w.data_ptr(),
                      row_scale.data_ptr(), col_scale.data_ptr(),
                      bias.data_ptr(), _build.ptr(res), _build.ptr(out),
                      _build.ptr(rowmax), _build.ptr(qscale), m, n, k,
                      Q8_ACTQ_EPI[activation] if epi == "ACTQ" else Q8_EPIS[epi],
                      torch.cuda.current_stream(dev).cuda_stream)
    q8_gemm.launches += 1
    if epi == "ROWMAX":
        return _ordered(rowmax).view(f32)
    return (out, qscale) if epi == "ACTQ" else out


q8_gemm.launches = 0
