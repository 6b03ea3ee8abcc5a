"""Int8 (W8A8) inference half-blocks of the CLIP and DINO layers.

The port of uml_tpu/ops/quant.py: ``_block_q8_kernel`` (the int8
attention half, causal or not, with an int8 or a bf16 out-projection) and
``_mlp_q8_kernel`` (the int8 MLP half, quick_gelu for CLIP, exact GELU for
DINO).  Its own copy of the math, importing nothing of uml_tpu:

* weights: symmetric per-output-channel int8 of the LN-folded fp32
  weights (``quantize_weight``), scale = max(absmax, 1e-12) / 127;
* activations: symmetric per-row dynamic int8 (``quantize_rows``), fused
  with the raw LayerNorm (``ln_quantize_rows``: absmax from the row's max
  and min, then one (x - mean) * (rstd / scale) pass) or with the MLP
  activation (``act_quantize_rows``: the scale from act(rowmax(pre)) and
  the activation's negative-lobe bound, never a reduction over act(pre));
* rounding floor(x + 0.5) clamped to +-127 (round half up, not
  ``torch.round``'s half to even);
* the product exact in integers, dequantized as
  ((float)acc * row_scale) * col_scale, then the fp32 bias.

The plain versions compute the integer product in float64, exact below
2^53 (127^2 * 3072 ~ 4.95e7 is past fp32's 2^24), on the CPU and on the
card.  The attention output that the out-projection quantizes is the fp32
output of the attention, before any rounding, as the Pallas kernel
quantizes it (uml_tpu's jnp reference rounds it to bf16 first: near a
row's absmax one bf16 ulp is about an int8 step, so a kernel and its
plain version that each rounded to bf16 could land two steps apart).

Wrappers: ``attn_block_q8`` / ``mlp_block_q8`` take the plain version for
a CPU tensor and launch ``csrc/attn_block_q8.cu`` / ``csrc/mlp_block_q8.cu``
for a CUDA tensor, or raise; each counts its launches on ``.launches``.
``mlp_block_q8`` takes quick_gelu and exact GELU, on the card and off it;
uml_tpu's identity activation (None) raises: its int8 hidden needs each
row's abs-max, not the row max that the card's c_fc pass finds.
For S <= 256 (``qkv_attention_fused``) the int8 attention half runs its
QKV product and attention as the int8 instance of ``csrc/qkv_attention.cu``
(q, k, v in shared memory, no qkv scratch), counted on
``qkv_attention_q8.launches`` too; ``qkv_attention_q8`` launches that
kernel on its own (after ``ln_quantize_rows``), beside
``qkv_attention_q8_plain``.
They take the int8 weights in the JAX [in, out] layout; the kernels read
them K-major ([out, in]: wgmma takes 8-bit operands K-major only), as
``w.t().contiguous()``, which is free for a transposed view of a K-major
tensor (what the model caches: ``models/clip.py::_quantize``) and a copy
for a row-major [in, out] one.  ``_launch_attn_block_q8`` /
``_launch_mlp_block_q8`` take the K-major weights themselves and raise on
an [in, out] shape that differs from it.
``ln_attn_block_q8`` / ``ln_mlp_block_q8`` keep uml_tpu's pre-fold
signatures (quant.py:480-535).  Inference-only, as in uml_tpu
(quant.py:28-30): every op raises when autograd would want a gradient.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.fused_attention import (HEAD_DIM, QKV_ATTN_MAX_S,
                                               check_head_dim,
                                               _qkv_heads, attention_plain,
                                               count_attention,
                                               fold_ln_into_matmul,
                                               qkv_attention_fused, qkv_scratch)
from uml_tpu_torch.ops.ln_matmul import gelu_exact_f32, quick_gelu_f32

INT8_MAX = 127.0


def _to_int8(x: torch.Tensor) -> torch.Tensor:
    """Round half up (floor(x + 0.5)), clamp to +-127."""
    return torch.clamp(torch.floor(x + 0.5), -INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_weight(w: torch.Tensor):
    """fp weight [K, M] -> (int8 [K, M], fp32 column scales [M])."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(0), min=1e-12) / INT8_MAX
    return _to_int8(wf / scale[None, :]), scale


def quantize_rows(xf: torch.Tensor):
    """fp32 [..., K] -> (int8 [..., K], fp32 row scales [..., 1])."""
    scale = torch.clamp(xf.abs().amax(-1, keepdim=True), min=1e-12) / INT8_MAX
    return _to_int8(xf / scale), scale


def ln_quantize_rows(xf: torch.Tensor, eps: float):
    """Raw LayerNorm + per-row quantize of fp32 [..., K] without the
    normalized row: absmax(xn) = rstd * max(max - mean, mean - min), then
    (x - mean) * (rstd / scale) (quant.py:88-113)."""
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    mx = xf.amax(-1, keepdim=True)
    mn = xf.amin(-1, keepdim=True)
    absmax = torch.maximum(mx - mean, mean - mn) * rstd
    scale = torch.clamp(absmax, min=1e-12) / INT8_MAX
    return _to_int8((xf - mean) * (rstd / scale)), scale


ACTIVATIONS = {None: lambda x: x, "quick_gelu": quick_gelu_f32,
               "gelu_exact": gelu_exact_f32}
# the activations of the int8 MLP half and their codes (csrc/ln_gemm.cuh
# ACT_*): those whose negative lobe bounds the row scale from the row max
Q8_MLP_ACT = {"quick_gelu": 1, "gelu_exact": 2}
# |global minimum| of each activation's negative lobe, padded ~1% so the
# bound never under-covers it: quick_gelu bottoms at -0.1637, exact GELU
# at -0.1700 (quant.py:116-121)
ACT_NEG_LOBE = {"quick_gelu": 0.1654, "gelu_exact": 0.1718}


def act_quantize_rows(pre: torch.Tensor, activation, rowmax=None):
    """Quantize act(pre) per row with the scale max(act(rowmax(pre)),
    lobe) / 127: the bounded-lobe GELUs are monotone above their minimum,
    so that bound covers the row without a reduction over act(pre)
    (quant.py:124-148).  Other activations quantize act(pre) as is.
    ``rowmax`` [..., 1], where given, is the row's max of ``pre``, found
    beforehand (the card's c_fc finds it in a pass of its own)."""
    act = ACTIVATIONS[activation]
    if activation not in ACT_NEG_LOBE:
        return quantize_rows(act(pre))
    if rowmax is None:
        rowmax = pre.amax(-1, keepdim=True)
    amax = torch.clamp(act(rowmax), min=ACT_NEG_LOBE[activation])
    scale = amax / INT8_MAX
    return _to_int8(act(pre) / scale), scale


def q8_dot(xq, row_scale, wq, col_scale):
    """int8 [..., K] x int8 [K, N] -> fp32 [..., N]: the integer product
    exact (float64), then ((float)acc * row_scale) * col_scale."""
    acc = xq.double() @ wq.double()
    return acc.float() * row_scale * col_scale


def qkv_attention_q8_plain(x, wq, wsc, b_eff, *, heads: int,
                           causal: bool = False, eps: float = 1e-5):
    """Plain PyTorch version of the int8 fused kernel's function: the fp32
    attention [B, S, H*D] of the int8 QKV product's bf16 qkv + b_eff (the
    output the int8 out-projection quantizes)."""
    b, s, _ = x.shape
    xq, xs = ln_quantize_rows(x.float(), eps)
    qkv = (q8_dot(xq, xs, wq, wsc) + b_eff.float()).to(torch.bfloat16)
    attn = attention_plain(*_qkv_heads(qkv, heads), causal=causal,
                           dtype=torch.float32)
    return attn.transpose(1, 2).reshape(b, s, -1)


def attn_block_q8_plain(x, wq, wsc, b_eff, wo_ops, bo, *, heads: int,
                        causal: bool = False, q8_out: bool = True,
                        eps: float = 1e-5):
    """Plain PyTorch version of the int8 attention half-block:
    x + MHA(LNquant(x) . int8 wq -> bf16 qkv + b_eff) . wo + bo, with
    ``wo_ops`` = (woq int8, wosc fp32) when ``q8_out``, else (wo bf16,)."""
    attn = qkv_attention_q8_plain(x, wq, wsc, b_eff, heads=heads,
                                  causal=causal, eps=eps)
    if q8_out:
        woq, wosc = wo_ops
        aq, asc = quantize_rows(attn)
        delta = q8_dot(aq, asc, woq, wosc)
    else:
        (wo,) = wo_ops
        delta = attn.to(torch.bfloat16).float() @ wo.float()
    return (x.float() + delta + bo.float()).to(x.dtype)


def mlp_block_q8_plain(x, w1q, w1sc, b1, w2q, w2sc, b2, *, eps: float = 1e-5,
                       activation="quick_gelu"):
    """Plain PyTorch version of the int8 MLP half-block:
    x + actquant(LNquant(x) . int8 w1 + b1) . int8 w2 + b2."""
    xf = x.float()
    xq, xs = ln_quantize_rows(xf, eps)
    pre = q8_dot(xq, xs, w1q, w1sc)
    yq, ys = act_quantize_rows(pre + b1.float(), activation)
    out = q8_dot(yq, ys, w2q, w2sc)
    return (xf + out + b2.float()).to(x.dtype)


def check_inference(name: str, *tensors) -> None:
    """The int8 ops have no gradient (uml_tpu: inference-only by design,
    training keeps the bf16 half-blocks): raise rather than return one
    through floor()."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the int8 serving path is inference-only; run it under "
            "torch.no_grad() or with frozen parameters (training uses the "
            "bf16 half-blocks)")


def _launch_attn_block_q8(x, wq, wsc, b_eff, wo_ops, bo, heads, causal,
                          q8_out, eps):
    """The int8 weights K-major: wq [3*H*64, K], woq [K, H*64] (a bf16 wo
    stays [H*64, K]) -> (out, q8, qscale): the output and the scratch the
    launches wrote; q8[:B*S*H*64] then holds the attention output's
    integers (q8_out: of its fp32 values) and qscale their row scales."""
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    check_head_dim(wq.shape[0], heads, "int8 attention half-block kernel")
    _build.check_dims(K=k)
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("wq", wq, torch.int8, (3 * hd, k), dev)
    _build.check_tensor("wsc", wsc, f32, (3 * hd,), dev)
    _build.check_tensor("b_eff", b_eff, f32, (3 * hd,), dev)
    _build.check_tensor("bo", bo, f32, (k,), dev)
    if q8_out:
        woq, wosc = wo_ops
        _build.check_tensor("woq", woq, torch.int8, (k, hd), dev)
        _build.check_tensor("wosc", wosc, f32, (k,), dev)
        wo_ptr, wosc_ptr = woq.data_ptr(), wosc.data_ptr()
    else:
        (wo,) = wo_ops
        _build.check_tensor("wo", wo, bf16, (hd, k), dev)
        wo_ptr, wosc_ptr = wo.data_ptr(), None
    rows = b * s
    with torch.cuda.device(dev):
        q8 = torch.empty(rows * max(k, hd), dtype=torch.int8, device=dev)
        qscale = torch.empty(rows, dtype=f32, device=dev)
        qkv = qkv_scratch(b, s, hd, dev)
        attn = torch.empty((rows, hd), dtype=f32 if q8_out else bf16, device=dev)
        out = torch.empty_like(x)
        _build.launch("uml_attn_block_q8", x.data_ptr(), wq.data_ptr(),
                      wsc.data_ptr(), b_eff.data_ptr(), wo_ptr, wosc_ptr,
                      bo.data_ptr(), q8.data_ptr(), qscale.data_ptr(),
                      _build.ptr(qkv), attn.data_ptr(), out.data_ptr(), b, s,
                      k, heads, int(causal), int(q8_out), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    count_attention(s, fused_counter=qkv_attention_q8)
    return out, q8, qscale


def attn_block_q8(x, wq, wsc, b_eff, wo_ops, bo, *, heads: int,
                  causal: bool = False, q8_out: bool = True,
                  eps: float = 1e-5):
    """x [B,S,K] bf16; wq int8 [K,3*H*64], wsc / b_eff fp32 [3*H*64];
    ``wo_ops`` (woq int8 [H*64,K], wosc fp32 [K]) or (wo bf16 [H*64,K],);
    bo fp32 [K] -> [B,S,K].  The card reads the int8 weights K-major (the
    module docstring)."""
    check_inference("attn_block_q8", x, b_eff, bo, *wo_ops)
    if x.device.type == "cpu":
        return attn_block_q8_plain(x, wq, wsc, b_eff, wo_ops, bo, heads=heads,
                                   causal=causal, q8_out=q8_out, eps=eps)
    if q8_out:
        wo_ops = (wo_ops[0].t().contiguous(), wo_ops[1])
    out, _, _ = _launch_attn_block_q8(x, wq.t().contiguous(), wsc, b_eff,
                                      wo_ops, bo, heads, causal, q8_out, eps)
    attn_block_q8.launches += 1
    return out


attn_block_q8.launches = 0


def qkv_attention_q8(x, wq, wsc, b_eff, *, heads: int, causal: bool = False,
                     eps: float = 1e-5):
    """The int8 fused QKV + attention kernel on its own (ln_quantize_rows,
    then csrc/qkv_attention.cu over int8), as ``qkv_attention_q8_plain``:
    x [B,S,K] bf16; wq int8 [K,3*H*64] (read K-major, as attn_block_q8
    does); wsc, b_eff fp32 [3*H*64] -> attn [B,S,H*64] fp32.  The int8
    attention half launches the same kernel inside its own C call
    (S <= 256) and counts it here too; for the card tests and
    ``chip_smoke.py``."""
    check_inference("qkv_attention_q8", x, b_eff)
    if x.device.type == "cpu":
        return qkv_attention_q8_plain(x, wq, wsc, b_eff, heads=heads,
                                      causal=causal, eps=eps)
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    check_head_dim(wq.shape[-1], heads, "qkv_attention_q8 kernel")
    if not qkv_attention_fused(s):
        raise ValueError(f"qkv_attention_q8 kernel: S={s}; it takes S <= "
                         f"{QKV_ATTN_MAX_S}")
    wq = wq.t().contiguous()
    _build.check_dims(K=k)
    f32, dev = torch.float32, x.device
    _build.check_tensor("x", x, torch.bfloat16, (b, s, k), dev)
    _build.check_tensor("wq", wq, torch.int8, (3 * hd, k), dev)
    _build.check_tensor("wsc", wsc, f32, (3 * hd,), dev)
    _build.check_tensor("b_eff", b_eff, f32, (3 * hd,), dev)
    with torch.cuda.device(dev):
        q8 = torch.empty(b * s * k, dtype=torch.int8, device=dev)
        qscale = torch.empty(b * s, dtype=f32, device=dev)
        attn = torch.empty((b, s, hd), dtype=f32, device=dev)
        _build.launch("uml_qkv_attention_q8", x.data_ptr(), wq.data_ptr(),
                      wsc.data_ptr(), b_eff.data_ptr(), q8.data_ptr(),
                      qscale.data_ptr(), attn.data_ptr(), b, s, k, heads,
                      int(causal), eps, torch.cuda.current_stream(dev).cuda_stream)
    qkv_attention_q8.launches += 1
    return attn


qkv_attention_q8.launches = 0


def mlp_q8_scratch(rows: int, k: int, m: int, dev):
    """The int8 MLP half's scratch (csrc/blocks.cuh::run_mlp_block_q8): q8
    int8 [rows * (M + K)] and qscale fp32 [2 * rows] (the int8 hidden and
    its row scales first, then the LN'd rows and theirs), rowmax int32
    [rows] (c_fc's row maxima).  No fp32 [rows, M] pre-activation."""
    return (torch.empty(rows * (m + k), dtype=torch.int8, device=dev),
            torch.empty(2 * rows, dtype=torch.float32, device=dev),
            torch.empty(rows, dtype=torch.int32, device=dev))


def _launch_mlp_block_q8(x, w1q, w1sc, b1, w2q, w2sc, b2, eps,
                         activation="quick_gelu"):
    """The int8 weights K-major: w1q [M, K], w2q [K, M] -> (out, q8,
    qscale): q8[:rows*M] then holds the integers of act(pre) and
    qscale[:rows] their row scales, q8[rows*M:] and qscale[rows:] the
    LN-quantized rows and theirs (the scratch the launches wrote)."""
    k = x.shape[-1]
    m = w1sc.shape[-1]
    _build.check_dims(K=k, M=m)
    f32, dev = torch.float32, x.device
    _build.check_tensor("x", x, torch.bfloat16, x.shape, dev)
    _build.check_tensor("w1q", w1q, torch.int8, (m, k), dev)
    _build.check_tensor("w1sc", w1sc, f32, (m,), dev)
    _build.check_tensor("b1", b1, f32, (m,), dev)
    _build.check_tensor("w2q", w2q, torch.int8, (k, m), dev)
    _build.check_tensor("w2sc", w2sc, f32, (k,), dev)
    _build.check_tensor("b2", b2, f32, (k,), dev)
    rows = x.numel() // k
    with torch.cuda.device(dev):
        q8, qscale, rowmax = mlp_q8_scratch(rows, k, m, dev)
        out = torch.empty_like(x)
        _build.launch("uml_mlp_block_q8", x.data_ptr(), w1q.data_ptr(),
                      w1sc.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
                      w2sc.data_ptr(), b2.data_ptr(), q8.data_ptr(),
                      qscale.data_ptr(), rowmax.data_ptr(), out.data_ptr(), rows,
                      k, m, Q8_MLP_ACT[activation], eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out, q8, qscale


def mlp_block_q8(x, w1q, w1sc, b1, w2q, w2sc, b2, *, eps: float = 1e-5,
                 activation="quick_gelu"):
    """x [..., K] bf16; w1q int8 [K,M], w1sc / b1 fp32 [M]; w2q int8 [M,K],
    w2sc / b2 fp32 [K] -> [..., K]; ``activation`` 'quick_gelu' (CLIP) or
    'gelu_exact' (DINO).  The kernel reads the int8 weights K-major (the
    module docstring)."""
    check_inference("mlp_block_q8", x, b1, b2)
    if activation not in Q8_MLP_ACT:
        raise ValueError(
            f"mlp_block_q8: activation={activation!r} is not ported (it takes "
            f"{list(Q8_MLP_ACT)}): without a GELU's lobe bound the int8 hidden "
            "needs each row's abs-max, which the card's row-max pass does not "
            "find (ROADMAP.md, queue 1: the int8 MLP half without an "
            "activation)")
    if x.device.type == "cpu":
        return mlp_block_q8_plain(x, w1q, w1sc, b1, w2q, w2sc, b2, eps=eps,
                                  activation=activation)
    out, _, _ = _launch_mlp_block_q8(x, w1q.t().contiguous(), w1sc, b1,
                                     w2q.t().contiguous(), w2sc, b2, eps,
                                     activation)
    mlp_block_q8.launches += 1
    return out


mlp_block_q8.launches = 0


def ln_attn_block_q8(x, scale, bias, kernel, kbias, wo, bo, *, heads: int,
                     causal: bool = False, eps: float = 1e-5,
                     q8_out: bool = True):
    """x + (MHA(LN(x)) @ wo + bo) with int8 projections — uml_tpu's
    ln_attn_block_q8: the LN folds into ``kernel`` in its own dtype (fp32
    on the model's path), then both weights quantize per column;
    ``q8_out=False`` keeps the out-projection bf16."""
    w_eff, b_eff = fold_ln_into_matmul(scale, bias, kernel, kbias)
    wq, wsc = quantize_weight(w_eff)
    wo_ops = (tuple(t.contiguous() for t in quantize_weight(wo)) if q8_out
              else (wo.to(torch.bfloat16).contiguous(),))
    return attn_block_q8(x, wq.contiguous(), wsc, b_eff, wo_ops, bo.float(),
                         heads=heads, causal=causal, q8_out=q8_out, eps=eps)


def ln_mlp_block_q8(x, scale, bias, w1, b1, w2, b2, *, eps: float = 1e-5,
                    activation=None):
    """x + act(LN(x) @ w1 + b1) @ w2 + b2 with int8 matmuls — uml_tpu's
    ln_mlp_block_q8 (the LN folds into ``w1`` in its own dtype)."""
    w1_eff, b1_eff = fold_ln_into_matmul(scale, bias, w1, b1)
    w1q, w1sc = quantize_weight(w1_eff)
    w2q, w2sc = quantize_weight(w2)
    return mlp_block_q8(x, w1q.contiguous(), w1sc, b1_eff, w2q.contiguous(),
                        w2sc, b2.float(), eps=eps, activation=activation)
