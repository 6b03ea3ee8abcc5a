"""Attention half-block: x + MHA(rawLN(x) @ w_eff + b_eff) @ wo + bo.

The port of uml_tpu/ops/fused_attention.py::_block_kernel (every query
row, causal or not) and ::_block_cls_kernel (the last image layer, whose
only consumer is the CLS row), and of their training twins:
``_block_kernel_stash`` (the forward that keeps qkv and the attention
output), ``_block_bwd_stash_kernel`` (the backward from that stash),
``_block_bwd_kernel`` (the backward that recomputes them) and
``_block_bwd_cls_kernel`` (the backward of the CLS layer).

Every op takes the post-fold weights (fold_ln_into_matmul): on a CPU
tensor it runs the plain PyTorch version below, written from the jnp twin
``_raw_block_reference``; on a CUDA tensor it launches its C entry point
in ``csrc/`` or raises, and counts the launch.

* ``attn_block`` / ``attn_block_cls``: ``csrc/attn_block.cu`` (the LN
  row pre-pass; for S <= 256 the QKV product and the attention in one
  kernel, ``csrc/qkv_attention.cu``, with q, k and v in shared memory and
  no qkv scratch, above that the QKV product on the wgmma engine and
  ``csrc/flash_attention.cu``; the out-projection with the residual on
  the engine).  ``qkv_attention_fused`` is the route, as ``blocks.cuh``
  takes it; each launch of the fused kernel counts on
  ``qkv_attention.launches`` too, and each launch of the chain's
  flash_attention.cu on ``attention.flash_attention.launches``
  (``count_attention``).  The CLS variant returns [B, 1, K]: the
  TPU kernel's [B, 8, K] (CLS_ROWS = 8) is a sublane tile, and only its
  row 0 is used.
* ``attn_block_stash``: the same launches, returning (out, qkv, attn).
  The port's qkv stash includes b_eff; the TPU's is bias-free and its
  backward re-adds the q-bias (fused_attention.py:407-410, :1055).  Both
  give the same gradients: the k-bias moves every score of a row by one
  constant, which the softmax cancels, and the v-bias moves dP by one
  constant per row, which dS = p * (dP - rowsum(p * dP)) cancels.  So
  the stash layout is the port's own, and the tests compare gradients,
  not stash bytes.
* ``attn_block_bwd`` / ``attn_block_cls_bwd``: ``csrc/attn_block_bwd.cu``
  -> (dx, dqkv, xn), as ``_block_bwd_stash_call`` / ``_block_bwd_cls_call``
  return them; the CLS backward reads the qkv that the CLS forward
  computes for every row (with its stash, the CLS forward projects all S
  rows; ``attn_block_cls`` without one projects q for the first 64), so
  K and V are not recomputed.  With one live query row its dxn is a
  rank-2H product per image (``csrc/cls_bwd.cuh``: dS and p per key and
  head against per-head K-vectors u = scale q0 Wk^T and w = dO Wv^T, row
  0 adding dq0 Wq^T), no fp32 dxn in device memory;
  ``attn_block_cls_bwd_factored_plain`` is that form's math, which the
  tests hold against the dense ``attn_block_cls_bwd_plain``.
* ``attn_block_bwd_recompute``: ``csrc/attn_block_bwd.cu`` -> (dx, dqkv,
  xn, attn), as ``_block_bwd_call`` returns them: it recomputes qkv and
  attn from x with the forward's own launches (so they equal the
  forward's bit for bit), then runs the stash backward on them.
* ``qkv_attention``: the fused kernel on its own (the LN pre-pass, then
  ``uml_qkv_attention``), -> attn, or (qkv, attn) with ``stash``; for the
  card tests and ``chip_smoke.py``, beside ``qkv_attention_plain``.
* ``attn_bwd``: the attention backward's dq pass or dkv pass
  (``csrc/attention_bwd.cuh``, wgmma with TMA-fed operands) on its own,
  which the backwards above launch inside their C calls; for the card
  tests and ``chip_smoke.py`` only.
* ``AttnBlockFn`` / ``AttnBlockClsFn``: the autograd Functions of the two
  halves; they assemble dW_eff, db_eff, dwo and dbo from the backward's
  outputs as ``_bwd_via_kernel`` does (fused_attention.py:1586-1594), as
  plain large products outside the kernels.  ``AttnBlockFn`` stashes as
  uml_tpu's ``_fused_block_fwd`` does (:1558-1566): only a non-causal
  half under ``stash_enabled()`` (UML_BWD_STASH, default "1"); otherwise
  its forward is ``attn_block`` and its backward
  ``attn_block_bwd_recompute``.  The CLS half always keeps the qkv its
  forward computed.

* ``ln_qkv_attention``: LN (affine) -> packed QKV -> MHA with no
  out-projection, [B, S, K] -> [B, S, H*64]: the port of ``_kernel``
  (fused_attention.py:143) as ``csrc/ln_qkv_attention.cu`` (the affine
  LN pre-pass into an xn scratch and the QKV product on the wgmma engine,
  the route ``ln_matmul`` takes, then the attention of
  flash_attention.cu).
  ``impl`` as in uml_tpu: "auto" runs ``ln_qkv_attention_plain`` for a CPU
  tensor and the kernel for a CUDA tensor, "pallas" is the kernel; both
  raise on a CUDA tensor ``supports_fused_attention`` does not take (it
  takes bf16, head dim 64, K a multiple of 64, any S); anything else is
  the plain version.  No model calls it (nor in
  uml_tpu); its backward differentiates the plain version
  (fused_attention.py:697-707).

Numerics, as in the twin: fp32 LN statistics, bf16 operands with fp32
accumulation, the full b_eff added to qkv before its bf16 rounding, an
fp32 softmax with the row max, bf16 probabilities.  (The TPU kernel
instead drops the k-bias, which the softmax cancels exactly, and adds the
v-bias after normalization; in bf16 the two orders round differently.)
The backward recomputes the softmax statistics from the stash as the
forward computes them; p and dS round to the weight dtype before their
products, dattn = g @ wo^T rounds to it once, dxn stays fp32.
"""

from __future__ import annotations

import os

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp
from uml_tpu_torch.ops.ln_matmul import (ln_matmul_plain, raw_layer_norm,
                                         raw_layer_norm_bwd,
                                         raw_layer_norm_rstd)

HEAD_DIM = 64  # the kernels' head dim (every CLIP and DINO tower)
# the longest S of the fused QKV + attention kernel (csrc/qkv_attention.cuh:
# q, k and v of one head, 256 rows each, in a block's shared memory)
QKV_ATTN_MAX_S = 256
# the most heads the CLS backward takes (csrc/cls_bwd.cuh: CLS_MAX_HEADS)
CLS_BWD_MAX_HEADS = 32


def check_head_dim(qkv_cols: int, heads: int, what: str) -> None:
    """The CUDA kernels take head dim HEAD_DIM only: raise for a packed
    QKV width ``qkv_cols`` (3 * heads * D) with another D.  The plain
    versions take the head dim from the weights, as uml_tpu's do."""
    if qkv_cols != 3 * heads * HEAD_DIM:
        raise ValueError(f"{what}: head dim {qkv_cols / (3 * heads):g} "
                         f"({heads} heads, QKV width {qkv_cols}); the CUDA "
                         f"kernels take head dim {HEAD_DIM}")


def qkv_attention_fused(s: int) -> bool:
    """The route of the attention halves on the card, as csrc/blocks.cuh
    takes it: S <= 256 runs csrc/qkv_attention.cu (the QKV product and the
    attention in one kernel, no qkv scratch unless a stash is kept), longer
    S the chain of the QKV product on the wgmma engine into a qkv scratch
    and csrc/flash_attention.cu."""
    return s <= QKV_ATTN_MAX_S


def count_attention(s: int, n: int = 1, fused_counter=None) -> None:
    """Count the attention kernel that ``n`` attention halves launched
    inside their C calls: on the fused route (S <= 256) the fused kernel,
    on ``fused_counter`` (``qkv_attention``, or the int8 wrapper's), on the
    chain csrc/flash_attention.cu, row 13's kernel, on
    ``attention.flash_attention``."""
    if qkv_attention_fused(s):
        (fused_counter or qkv_attention).launches += n
    else:
        from uml_tpu_torch.ops.attention import flash_attention  # (a cycle)

        flash_attention.launches += n


def qkv_scratch(b: int, s: int, hd: int, device, stash: bool = False):
    """The qkv buffer [B*S, 3*hd] bf16 that a half-block's C call takes:
    the stash where a caller keeps one, the chain's scratch above
    QKV_ATTN_MAX_S, else None: the fused kernel keeps q, k and v on chip,
    and the inference halves allocate nothing for them."""
    if stash or not qkv_attention_fused(s):
        return torch.empty((b * s, 3 * hd), dtype=torch.bfloat16, device=device)
    return None


def fold_ln_into_matmul(scale, bias, kernel, kbias):
    """Fold LN affine params into the following matmul's weights:
    (xn*scale + bias) @ W + b  ==  xn @ (scale*W) + (b + bias@W).

    Fold math runs in fp32; ``w_eff`` is cast back to the weight dtype and
    ``b_eff`` stays fp32 (fused_attention.py:1706-1717)."""
    kf = kernel.float()
    w_eff = (scale.float()[:, None] * kf).to(kernel.dtype)
    b_eff = kbias.float() + bias.float() @ kf
    return w_eff, b_eff


def attention_plain(q, k, v, *, causal: bool = False, dtype=None):
    """q [B,H,Sq,D], k/v [B,H,S,D] -> [B,H,Sq,D]: fp32 scores and softmax
    (row max), probabilities rounded to the input dtype unnormalized, the
    1/rowsum applied to the fp32 P.V — the CUDA kernel's order — and the
    result rounded to ``dtype`` (q's by default; fp32: no rounding)."""
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1, keepdim=True)
    return ((e.to(q.dtype).float() @ v.float()) * inv).to(dtype or q.dtype)


def _qkv_heads(qkv, heads):
    """[B, S, 3*H*D] -> q, k, v as [B, H, S, D]."""
    b, s, m3 = qkv.shape
    d = m3 // (3 * heads)
    return qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)


def _qkv_attention_plain(x, w_eff, b_eff, *, heads, causal, eps, q_rows=None):
    """-> (qkv [B, S, 3*H*D] with b_eff, attn [B, sq, H*D]): the first
    two steps of the half-block, which the recompute backward repeats."""
    b, s, _ = x.shape
    sq = s if q_rows is None else q_rows
    dt = w_eff.dtype
    xn = raw_layer_norm(x.float(), eps).to(dt)
    qkv = (xn.float() @ w_eff.float() + b_eff.float()).to(dt)
    q, k, v = _qkv_heads(qkv, heads)
    attn = attention_plain(q[:, :, :sq], k, v, causal=causal)
    return qkv, attn.transpose(1, 2).reshape(b, sq, -1)


def qkv_attention_plain(x, w_eff, b_eff, *, heads: int, causal: bool = False,
                        eps: float = 1e-5, q_rows=None, stash: bool = False):
    """Plain PyTorch version of the fused kernel's function: attn
    [B, sq, H*D] of the half-block's first two steps, or (qkv, attn) with
    ``stash``."""
    qkv, attn = _qkv_attention_plain(x, w_eff, b_eff, heads=heads,
                                     causal=causal, eps=eps, q_rows=q_rows)
    return (qkv, attn) if stash else attn


def attn_block_stash_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                           causal: bool = False, eps: float = 1e-5,
                           q_rows=None):
    """Plain PyTorch version of the attention half-block (post-fold) that
    also returns its stash: (out [B, sq, K], qkv [B, S, 3*H*D] with
    b_eff, attn [B, sq, H*D]).  ``q_rows`` keeps only the first query
    rows (1 for the CLS block)."""
    qkv, attn = _qkv_attention_plain(x, w_eff, b_eff, heads=heads,
                                     causal=causal, eps=eps, q_rows=q_rows)
    delta = attn.float() @ wo.float()
    out = (x.float()[:, :attn.shape[1]] + delta + bo.float()).to(x.dtype)
    return out, qkv, attn


def attn_block_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                     causal: bool = False, eps: float = 1e-5, q_rows=None):
    """Plain PyTorch version of the attention half-block (post-fold)."""
    return attn_block_stash_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                  causal=causal, eps=eps, q_rows=q_rows)[0]


def attn_block_cls_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                         eps: float = 1e-5):
    return attn_block_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                            causal=False, eps=eps, q_rows=1)


def attn_block_bwd_plain(x, g, qkv, w_eff, wo, *, heads: int,
                         causal: bool = False, eps: float = 1e-5):
    """Plain PyTorch version of the attention half-block's backward from
    the stash: x [B, S, K], g [B, sq, K] (sq = S, or 1 for the CLS
    block: only the first sq query rows have a cotangent), qkv the
    forward's stash -> (dx [B, S, K], dqkv [B, S, 3*H*D], xn [B, S, K]).

    The softmax statistics are recomputed as the forward computes them
    (fp32 scores, row max, 1/rowsum); with p = e / rowsum:
    dV = p^T dO, dP = dO V^T, dS = p * (dP - rowsum(p * dP)),
    dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), then dxn = dqkv W_eff^T
    and the LN backward, plus the residual g."""
    b, s, _ = x.shape
    sq = g.shape[1]
    dt = w_eff.dtype
    xn32, rstd = raw_layer_norm_rstd(x.float(), eps)

    dattn = (g.float() @ wo.float().t()).to(dt)              # [B, sq, H*D]
    q, k, v = _qkv_heads(qkv, heads)
    d = q.shape[-1]
    scale = d ** -0.5
    do = dattn.view(b, sq, heads, d).transpose(1, 2).float()  # [B, H, sq, D]
    sc = (q[:, :, :sq].float() @ k.float().transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(sq, s, dtype=torch.bool, device=x.device).tril(s - sq)
        sc = sc.masked_fill(~keep, float("-inf"))
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = do @ v.float().transpose(-1, -2)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).to(dt).float()
    dq = (ds @ k.float()) * scale
    dk = (ds.transpose(-1, -2) @ q[:, :, :sq].float()) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ do
    if sq < s:
        dq = torch.cat([dq, dq.new_zeros(b, heads, s - sq, d)], dim=2)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        b, s, 3 * heads * d).to(dt)

    dxf = raw_layer_norm_bwd(dqkv.float() @ w_eff.float().t(), xn32, rstd)
    dxf[:, :sq] += g.float()
    return dxf.to(x.dtype), dqkv, xn32.to(x.dtype)


def attn_block_cls_bwd_plain(x, g, qkv, w_eff, wo, *, heads: int,
                             eps: float = 1e-5):
    """attn_block_bwd_plain for the CLS block: g [B, 1, K]."""
    return attn_block_bwd_plain(x, g, qkv, w_eff, wo, heads=heads,
                                causal=False, eps=eps)


def attn_block_cls_bwd_factored_plain(x, g, qkv, w_eff, wo, *, heads: int,
                                      eps: float = 1e-5):
    """The CLS backward in the rank-2H form of csrc/cls_bwd.cuh, the plain
    version of its math: -> (dx, dqkv, xn) as attn_block_cls_bwd_plain.

    With one live query row, dk_j = ds_j q0 scale and dv_j = p_j dO, so
    the k and v parts of dxn row j are sum_h ds_{j,h} u_h + p_{j,h} w_h
    with u_h = scale q0_h Wk_h^T and w_h = dO_h Wv_h^T; row 0 adds
    z = dq0 Wq^T.  ds and p are rounded to the weight dtype (the operands
    of the dense form's products), u, w and z are not, and neither is
    dxn.  Float64 inputs are computed in float64 throughout (nothing is
    rounded then), which pins the algebra against the dense form."""
    b, s, k = x.shape
    dt = w_eff.dtype
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    d = w_eff.shape[1] // (3 * heads)
    hd = heads * d
    scale = d ** -0.5
    xn32, rstd = raw_layer_norm_rstd(x.to(acc), eps)
    dattn = (g.to(acc) @ wo.to(acc).t()).to(dt)                 # [B, 1, H*D]
    q, kk, v = (t.to(acc) for t in _qkv_heads(qkv, heads))       # [B, H, S, D]
    q0 = q[:, :, 0]                                              # [B, H, D]
    do = dattn.view(b, heads, d).to(acc)                         # [B, H, D]
    sc = torch.einsum("bhd,bhsd->bhs", q0, kk) * scale
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dp = torch.einsum("bhd,bhsd->bhs", do, v)
    ds = (p * (dp - (p * dp).sum(-1, keepdim=True))).to(dt).to(acc)
    pb = p.to(dt).to(acc)
    dq0 = (torch.einsum("bhs,bhsd->bhd", ds, kk) * scale).to(dt).to(acc)
    dk = ds[..., None] * q0[:, :, None] * scale                  # [B, H, S, D]
    dv = pb[..., None] * do[:, :, None]
    dq = torch.cat([dq0[:, :, None], dq0.new_zeros(b, heads, s - 1, d)], 2)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        b, s, 3 * hd).to(dt)

    wq, wk, wv = (w_eff.to(acc)[:, i * hd:(i + 1) * hd].view(k, heads, d)
                  for i in range(3))
    u = torch.einsum("bhd,khd->bhk", q0 * scale, wk)
    w = torch.einsum("bhd,khd->bhk", do, wv)
    z = torch.einsum("bhd,khd->bk", dq0, wq)
    dxn = torch.einsum("bhs,bhk->bsk", ds, u) + torch.einsum("bhs,bhk->bsk", pb, w)
    dxn[:, 0] += z
    dxf = raw_layer_norm_bwd(dxn, xn32, rstd)
    dxf[:, 0] += g[:, 0].to(acc)
    return dxf.to(x.dtype), dqkv, xn32.to(x.dtype)


def attn_block_bwd_recompute_plain(x, g, w_eff, b_eff, wo, *, heads: int,
                                   causal: bool = False, eps: float = 1e-5):
    """Plain PyTorch version of the backward with no stash: recompute qkv
    and attn as attn_block_stash_plain computes them, then
    attn_block_bwd_plain -> (dx, dqkv, xn, attn [B, S, H*D])."""
    qkv, attn = _qkv_attention_plain(x, w_eff, b_eff, heads=heads,
                                     causal=causal, eps=eps)
    dx, dqkv, xn = attn_block_bwd_plain(x, g, qkv, w_eff, wo, heads=heads,
                                        causal=causal, eps=eps)
    return dx, dqkv, xn, attn


def _check_fwd(x, w_eff, b_eff, wo, bo, heads):
    """What the forward kernels take (any S) -> (B, S, K, H*64)."""
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    check_head_dim(w_eff.shape[-1], heads, "attention half-block kernel")
    _build.check_dims(K=k)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("w_eff", w_eff, bf16, (k, 3 * hd), dev)
    _build.check_tensor("b_eff", b_eff, torch.float32, (3 * hd,), dev)
    _build.check_tensor("wo", wo, bf16, (hd, k), dev)
    _build.check_tensor("bo", bo, torch.float32, (k,), dev)
    return b, s, k, hd


def _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal, eps, q_rows,
                       entry="uml_attn_block", stash=False):
    """-> (out, qkv, attn): the output and the scratch the launches wrote;
    qkv is None where the fused route keeps it on chip (no ``stash``)."""
    b, s, k, hd = _check_fwd(x, w_eff, b_eff, wo, bo, heads)
    bf16, dev = torch.bfloat16, x.device
    with torch.cuda.device(dev):
        xn = torch.empty_like(x)
        qkv = qkv_scratch(b, s, hd, dev, stash)
        attn = torch.empty((b * q_rows, hd), dtype=bf16, device=dev)
        out = torch.empty((b, q_rows, k), dtype=bf16, device=dev)
        ptrs = (*map(_build.ptr, (x, w_eff, b_eff, wo, bo, xn, qkv, attn, out)),
                b, s, k, heads, int(causal))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if entry == "uml_attn_block":
            _build.launch(entry, *ptrs, q_rows, eps, stream)
        else:
            _build.launch(entry, *ptrs, eps, stream)
    count_attention(s)
    return (out, None if qkv is None else qkv.view(b, s, 3 * hd),
            attn.view(b, q_rows, hd))


def attn_block(x, w_eff, b_eff, wo, bo, *, heads: int, causal: bool = False,
               eps: float = 1e-5):
    """x [B,S,K]; w_eff [K,3*H*64] (ln_1-folded); b_eff [3*H*64] fp32;
    wo [H*64,K]; bo [K] fp32 -> [B,S,K]."""
    if x.device.type == "cpu":
        return attn_block_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                causal=causal, eps=eps)
    out, _, _ = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal,
                                   eps, q_rows=x.shape[1])
    attn_block.launches += 1
    return out


attn_block.launches = 0


def attn_block_cls(x, w_eff, b_eff, wo, bo, *, heads: int, eps: float = 1e-5):
    """Non-causal attention half-block for the CLS row only: K/V cover all
    S rows, queries and output only row 0 -> [B,1,K]."""
    if x.device.type == "cpu":
        return attn_block_cls_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                    eps=eps)
    out, _, _ = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, False,
                                   eps, q_rows=1)
    attn_block_cls.launches += 1
    return out


attn_block_cls.launches = 0


def _attn_block_cls_stash(x, w_eff, b_eff, wo, bo, *, heads: int, eps):
    """attn_block_cls that keeps its scratch for the backward:
    (out [B,1,K], qkv [B,S,3*H*64] of every row, attn [B,1,H*64]).  The
    same kernel launches as attn_block_cls, counted there."""
    if x.device.type == "cpu":
        return attn_block_stash_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                      eps=eps, q_rows=1)
    stash = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, False, eps,
                               q_rows=1, stash=True)
    attn_block_cls.launches += 1
    return stash


def attn_block_stash(x, w_eff, b_eff, wo, bo, *, heads: int,
                     causal: bool = False, eps: float = 1e-5):
    """The training forward of the attention half-block -> (out [B,S,K],
    qkv [B,S,3*H*64] with b_eff, attn [B,S,H*64])."""
    if x.device.type == "cpu":
        return attn_block_stash_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                      causal=causal, eps=eps)
    stash = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal, eps,
                               q_rows=x.shape[1], entry="uml_attn_block_stash",
                               stash=True)
    attn_block_stash.launches += 1
    return stash


attn_block_stash.launches = 0


def _check_bwd(x, g, qkv, w_eff, wo, heads, q_rows):
    """What the backward kernels take (any S); ``qkv`` None for the
    recompute backward, which takes no stash."""
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    check_head_dim(w_eff.shape[-1], heads, "attention backward kernel")
    _build.check_dims(K=k)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("g", g, bf16, (b, q_rows, k), dev)
    if qkv is not None:
        _build.check_tensor("qkv", qkv, bf16, (b, s, 3 * hd), dev)
    _build.check_tensor("w_eff", w_eff, bf16, (k, 3 * hd), dev)
    _build.check_tensor("wo", wo, bf16, (hd, k), dev)
    return b, s, k, hd, bf16, dev


def attn_block_bwd(x, g, qkv, w_eff, wo, *, heads: int, causal: bool = False,
                   eps: float = 1e-5):
    """Backward of attn_block_stash from its stash: x [B,S,K], g [B,S,K],
    qkv [B,S,3*H*64] -> (dx [B,S,K], dqkv [B,S,3*H*64], xn [B,S,K])."""
    if x.device.type == "cpu":
        return attn_block_bwd_plain(x, g, qkv, w_eff, wo, heads=heads,
                                    causal=causal, eps=eps)
    b, s, k, hd, bf16, dev = _check_bwd(x, g, qkv, w_eff, wo, heads, x.shape[1])
    with torch.cuda.device(dev):
        dattn = torch.empty((b * s, hd), dtype=bf16, device=dev)
        stats = torch.empty((b * heads * s, 4), dtype=torch.float32, device=dev)
        dxn = torch.empty((b * s, k), dtype=torch.float32, device=dev)
        dqkv = torch.empty((b, s, 3 * hd), dtype=bf16, device=dev)
        dx = torch.empty_like(x)
        xn = torch.empty_like(x)
        _build.launch("uml_attn_block_bwd", x.data_ptr(), g.data_ptr(),
                      qkv.data_ptr(), w_eff.data_ptr(), wo.data_ptr(),
                      dattn.data_ptr(), stats.data_ptr(), dxn.data_ptr(),
                      dqkv.data_ptr(), dx.data_ptr(), xn.data_ptr(),
                      b, s, k, heads, int(causal), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    attn_block_bwd.launches += 1
    return dx, dqkv, xn


attn_block_bwd.launches = 0


def attn_block_cls_bwd(x, g, qkv, w_eff, wo, *, heads: int, eps: float = 1e-5):
    """Backward of the CLS block from the qkv its forward computed:
    x [B,S,K], g [B,1,K] -> (dx [B,S,K], dqkv [B,S,3*H*64], xn [B,S,K]).
    On the card: dattn = g wo^T on the engine, then csrc/cls_bwd.cuh's
    rank-2H passes (attn_block_cls_bwd_factored_plain is their math)."""
    if x.device.type == "cpu":
        return attn_block_cls_bwd_plain(x, g, qkv, w_eff, wo, heads=heads,
                                        eps=eps)
    b, s, k, hd, bf16, dev = _check_bwd(x, g, qkv, w_eff, wo, heads, 1)
    if heads > CLS_BWD_MAX_HEADS:
        raise ValueError(f"attn_block_cls_bwd: {heads} heads, the kernel takes "
                         f"at most {CLS_BWD_MAX_HEADS}")
    f32 = torch.float32
    with torch.cuda.device(dev):
        dattn = torch.empty((b, hd), dtype=bf16, device=dev)
        coef = torch.empty((b, s, 2 * heads), dtype=f32, device=dev)
        proj = torch.empty((b, 3, heads, k), dtype=f32, device=dev)
        dqkv = torch.empty((b, s, 3 * hd), dtype=bf16, device=dev)
        dx = torch.empty_like(x)
        xn = torch.empty_like(x)
        _build.launch("uml_attn_block_cls_bwd", *map(_build.ptr, (
            x, g, qkv, w_eff, wo, dattn, coef, proj, dqkv, dx, xn)),
            b, s, k, heads, eps, torch.cuda.current_stream(dev).cuda_stream)
    attn_block_cls_bwd.launches += 1
    return dx, dqkv, xn


attn_block_cls_bwd.launches = 0


def attn_block_bwd_recompute(x, g, w_eff, b_eff, wo, *, heads: int,
                             causal: bool = False, eps: float = 1e-5):
    """Backward of attn_block with no stash: x [B,S,K], g [B,S,K] ->
    (dx [B,S,K], dqkv [B,S,3*H*64], xn [B,S,K], attn [B,S,H*64])."""
    if x.device.type == "cpu":
        return attn_block_bwd_recompute_plain(x, g, w_eff, b_eff, wo,
                                              heads=heads, causal=causal,
                                              eps=eps)
    b, s, k, hd, bf16, dev = _check_bwd(x, g, None, w_eff, wo, heads, x.shape[1])
    _build.check_tensor("b_eff", b_eff, torch.float32, (3 * hd,), dev)
    with torch.cuda.device(dev):
        qkv = torch.empty((b * s, 3 * hd), dtype=bf16, device=dev)
        attn = torch.empty((b, s, hd), dtype=bf16, device=dev)
        dattn = torch.empty((b * s, hd), dtype=bf16, device=dev)
        stats = torch.empty((b * heads * s, 4), dtype=torch.float32, device=dev)
        dxn = torch.empty((b * s, k), dtype=torch.float32, device=dev)
        dqkv = torch.empty((b, s, 3 * hd), dtype=bf16, device=dev)
        dx = torch.empty_like(x)
        xn = torch.empty_like(x)
        _build.launch("uml_attn_block_bwd_recompute", x.data_ptr(), g.data_ptr(),
                      w_eff.data_ptr(), b_eff.data_ptr(), wo.data_ptr(),
                      qkv.data_ptr(), attn.data_ptr(), dattn.data_ptr(),
                      stats.data_ptr(), dxn.data_ptr(), dqkv.data_ptr(),
                      dx.data_ptr(), xn.data_ptr(), b, s, k, heads, int(causal),
                      eps, torch.cuda.current_stream(dev).cuda_stream)
    attn_block_bwd_recompute.launches += 1
    count_attention(s)
    return dx, dqkv, xn, attn


attn_block_bwd_recompute.launches = 0


def qkv_attention(x, w_eff, b_eff, *, heads: int, causal: bool = False,
                  eps: float = 1e-5, q_rows=None, stash: bool = False):
    """The fused QKV + attention kernel on its own (csrc/qkv_attention.cu,
    after the LN row pre-pass), as ``qkv_attention_plain``: x [B,S,K],
    w_eff [K,3*H*64], b_eff [3*H*64] fp32 -> attn [B,sq,H*64] (sq = S, or
    ``q_rows`` = 1 for the CLS row), or (qkv [B,S,3*H*64], attn) with
    ``stash``.  The half-blocks launch the same kernel inside their own C
    calls (S <= 256) and count it here too; for the card tests and
    ``chip_smoke.py``."""
    if x.device.type == "cpu":
        return qkv_attention_plain(x, w_eff, b_eff, heads=heads, causal=causal,
                                   eps=eps, q_rows=q_rows, stash=stash)
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    check_head_dim(w_eff.shape[-1], heads, "qkv_attention kernel")
    sq = s if q_rows is None else q_rows
    if not qkv_attention_fused(s) or sq not in (s, 1) or (causal and sq != s):
        raise ValueError(f"qkv_attention kernel: S={s} q_rows={sq} causal={causal}; "
                         f"it takes S <= {QKV_ATTN_MAX_S}, q_rows S or 1 (S when causal)")
    _build.check_dims(K=k)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("w_eff", w_eff, bf16, (k, 3 * hd), dev)
    _build.check_tensor("b_eff", b_eff, torch.float32, (3 * hd,), dev)
    with torch.cuda.device(dev):
        xn = torch.empty_like(x)
        qkv = qkv_scratch(b, s, hd, dev, stash)
        attn = torch.empty((b, sq, hd), dtype=bf16, device=dev)
        _build.launch("uml_qkv_attention",
                      *map(_build.ptr, (x, w_eff, b_eff, xn, qkv, attn)),
                      b, s, k, heads, int(causal), sq, eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    qkv_attention.launches += 1
    return (qkv.view(b, s, 3 * hd), attn) if stash else attn


qkv_attention.launches = 0


def attn_bwd_plain(qkv, dattn, *, heads: int, causal: bool = False,
                   stats=None):
    """Plain version of the attention backward's two passes on their own
    (``csrc/attention_bwd.cuh``; inside ``attn_block_bwd_plain`` they are
    one step): qkv [B, S, 3*H*64] the stash, dattn [B, S, H*64] = dO.

    ``stats`` None: the dq pass -> (dq [B, S, H*64], stats [B, H, S, 4] =
    (m, 1/l, D, 0) per query row: the scaled scores' max, the reciprocal
    of rowsum(exp(s - m)), D = rowsum(p * dP)).  Given those statistics:
    the dkv pass -> (dk, dv) [B, S, H*64], p = exp(s - m) / l taken from
    them.  p and dS are rounded to bf16 before their products, as in
    ``attn_block_bwd_plain``."""
    b, s, _ = qkv.shape
    dt = qkv.dtype
    q, k, v = (t.float() for t in _qkv_heads(qkv, heads))
    d = q.shape[-1]
    scale = d ** -0.5
    do = dattn.view(b, s, heads, d).transpose(1, 2).float()
    sc = (q @ k.transpose(-1, -2)) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=qkv.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    dp = do @ v.transpose(-1, -2)

    def heads_out(t):
        return t.transpose(1, 2).reshape(b, s, -1).to(dt)

    if stats is None:
        m = sc.amax(-1, keepdim=True)
        e = torch.exp(sc - m)
        linv = 1.0 / e.sum(-1, keepdim=True)
        dsum = (e * dp).sum(-1, keepdim=True) * linv
        ds = (e * linv * (dp - dsum)).to(dt).float()
        stats = torch.cat([m, linv, dsum, torch.zeros_like(m)], dim=-1)
        return heads_out((ds @ k) * scale), stats
    m, linv, dsum = (stats[..., i:i + 1] for i in range(3))
    p = torch.exp(sc - m) * linv
    ds = (p * (dp - dsum)).to(dt).float()
    dk = (ds.transpose(-1, -2) @ q) * scale
    dv = p.to(dt).float().transpose(-1, -2) @ do
    return heads_out(dk), heads_out(dv)


def attn_bwd(qkv, dattn, *, heads: int, causal: bool = False, stats=None):
    """The attention backward's dq pass (``stats`` None) or dkv pass (from
    the dq pass's statistics) on its own, as ``attn_bwd_plain``; on a CUDA
    tensor through ``uml_attn_bwd`` (the kernels ``attn_block_bwd`` and
    ``attn_block_bwd_recompute`` launch inside their own C calls).  No
    model calls it: the card tests and ``chip_smoke.py`` hold and time each
    pass with it."""
    if qkv.device.type == "cpu":
        return attn_bwd_plain(qkv, dattn, heads=heads, causal=causal,
                              stats=stats)
    b, s, _ = qkv.shape
    hd = heads * HEAD_DIM
    check_head_dim(qkv.shape[-1], heads, "attention backward kernel")
    dev = qkv.device
    _build.check_tensor("qkv", qkv, torch.bfloat16, (b, s, 3 * hd), dev)
    _build.check_tensor("dattn", dattn, torch.bfloat16, (b, s, hd), dev)
    if stats is not None:
        _build.check_tensor("stats", stats, torch.float32, (b, heads, s, 4), dev)
    with torch.cuda.device(dev):
        dqkv = torch.empty_like(qkv)
        st = torch.empty((b, heads, s, 4), dtype=torch.float32, device=dev) \
            if stats is None else stats
        _build.launch("uml_attn_bwd", qkv.data_ptr(), dattn.data_ptr(),
                      st.data_ptr(), dqkv.data_ptr(), b, s, heads, int(causal),
                      1 if stats is None else 2,
                      torch.cuda.current_stream(dev).cuda_stream)
    attn_bwd.launches += 1
    if stats is None:
        return dqkv[..., :hd], st
    return dqkv[..., hd:2 * hd], dqkv[..., 2 * hd:]


attn_bwd.launches = 0


def stash_enabled() -> bool:
    """Stash qkv and the attention output of a non-causal attention half
    for its backward (UML_BWD_STASH, default "1"; anything else
    recomputes them from x), the switch of uml_tpu's _stash_enabled
    (fused_attention.py:373-391).  A causal half never stashes."""
    return os.environ.get("UML_BWD_STASH", "1") == "1"


def _param_grads(xn, dqkv, attn, g, w_eff, b_eff, wo, bo):
    """dW_eff = xn^T dqkv, db_eff, dwo = attn^T g, dbo: contractions over
    (batch, seq) with fp32 accumulation, each cast to its parameter's
    dtype, as _bwd_via_kernel assembles them (fused_attention.py:1586-1594)."""
    xn2, dqkv2 = xn.reshape(-1, xn.shape[-1]), dqkv.reshape(-1, dqkv.shape[-1])
    attn2, g2 = attn.reshape(-1, attn.shape[-1]), g.reshape(-1, g.shape[-1])
    return (torch.matmul(xn2.t(), dqkv2).to(w_eff.dtype),
            dqkv2.sum(0, dtype=torch.float32).to(b_eff.dtype),
            torch.matmul(attn2.t(), g2).to(wo.dtype),
            g2.sum(0, dtype=torch.float32).to(bo.dtype))


class AttnBlockFn(torch.autograd.Function):
    """attn_block with a gradient: the stash forward and the stash
    backward for a non-causal half under stash_enabled(), else the
    inference forward and the recompute backward."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, wo, bo, heads, causal, eps):
        ctx.cfg = (heads, causal, eps)
        if stash_enabled() and not causal:
            out, qkv, attn = attn_block_stash(x, w_eff, b_eff, wo, bo,
                                              heads=heads, causal=causal, eps=eps)
            ctx.save_for_backward(x, w_eff, b_eff, wo, bo, qkv, attn)
        else:
            out = attn_block(x, w_eff, b_eff, wo, bo, heads=heads,
                             causal=causal, eps=eps)
            ctx.save_for_backward(x, w_eff, b_eff, wo, bo)
        return out

    @staticmethod
    def backward(ctx, g):
        heads, causal, eps = ctx.cfg
        g = g.contiguous()
        if len(ctx.saved_tensors) == 7:
            x, w_eff, b_eff, wo, bo, qkv, attn = ctx.saved_tensors
            dx, dqkv, xn = attn_block_bwd(x, g, qkv, w_eff, wo, heads=heads,
                                          causal=causal, eps=eps)
        else:
            x, w_eff, b_eff, wo, bo = ctx.saved_tensors
            dx, dqkv, xn, attn = attn_block_bwd_recompute(
                x, g, w_eff, b_eff, wo, heads=heads, causal=causal, eps=eps)
        return (dx, *_param_grads(xn, dqkv, attn, g, w_eff, b_eff, wo, bo),
                None, None, None)


class AttnBlockClsFn(torch.autograd.Function):
    """attn_block_cls with a gradient: the CLS forward keeps its qkv, the
    CLS backward reads it."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, wo, bo, heads, eps):
        out, qkv, attn = _attn_block_cls_stash(x, w_eff, b_eff, wo, bo,
                                               heads=heads, eps=eps)
        ctx.save_for_backward(x, w_eff, b_eff, wo, bo, qkv, attn)
        ctx.cfg = (heads, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_eff, b_eff, wo, bo, qkv, attn = ctx.saved_tensors
        heads, eps = ctx.cfg
        g = g.contiguous()
        dx, dqkv, xn = attn_block_cls_bwd(x, g, qkv, w_eff, wo, heads=heads,
                                          eps=eps)
        return (dx, *_param_grads(xn, dqkv, attn, g, w_eff, b_eff, wo, bo),
                None, None)


def ln_attn_block(x, scale, bias, kernel, kbias, wo, bo, *, heads: int,
                  causal: bool = False, eps: float = 1e-5):
    """x + (MHA(LN(x)) @ wo + bo) — the signature of uml_tpu's
    ln_attn_block; folds the LN params, then runs attn_block."""
    w_eff, b_eff = fold_ln_into_matmul(scale, bias, kernel, kbias)
    return attn_block(x, w_eff, b_eff, wo, bo.float(), heads=heads,
                      causal=causal, eps=eps)


def ln_attn_block_cls(x, scale, bias, kernel, kbias, wo, bo, *, heads: int,
                      eps: float = 1e-5):
    """Row 0 of ln_attn_block (non-causal) as [B,1,K]."""
    w_eff, b_eff = fold_ln_into_matmul(scale, bias, kernel, kbias)
    return attn_block_cls(x, w_eff, b_eff, wo, bo.float(), heads=heads,
                          eps=eps)


def ln_qkv_attention_plain(x, scale, bias, kernel, kbias, *, heads: int,
                           causal: bool = False, eps: float = 1e-5):
    """Plain PyTorch version of ln_qkv_attention: the affine LN, the packed
    QKV product with its bias rounded to x's dtype, then the attention of
    attention_plain per head -> [B, S, H*D]."""
    b, s, _ = x.shape
    qkv = ln_matmul_plain(x, scale, bias, kernel, kbias, eps=eps)
    attn = attention_plain(*_qkv_heads(qkv, heads), causal=causal)
    return attn.transpose(1, 2).reshape(b, s, -1)


def supports_fused_attention(k: int, heads: int, head_dim: int, seq_len: int,
                             dtype=torch.bfloat16) -> bool:
    """What ln_qkv_attention's kernels take: bf16, head dim 64, K a
    multiple of the 64-wide GEMM tiles (H*64 always is); any ``seq_len``
    (the attention streams K/V), kept for uml_tpu's signature."""
    return dtype == torch.bfloat16 and head_dim == HEAD_DIM and k % 64 == 0


def _ln_qkv_attention_fwd(x, scale, bias, kernel, kbias, heads, causal, eps):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor
    (x [B, S, K] bf16, kernel [K, 3*H*64] bf16; scale, bias, kbias go in
    as fp32)."""
    if x.device.type == "cpu":
        return ln_qkv_attention_plain(x, scale, bias, kernel, kbias,
                                      heads=heads, causal=causal, eps=eps)
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    if not supports_fused_attention(k, heads, kernel.shape[1] // (3 * heads),
                                    s, x.dtype):
        raise ValueError(
            f"ln_qkv_attention kernel: K={k} S={s} head dim "
            f"{kernel.shape[1] // (3 * heads)} {x.dtype}; it takes bf16, head "
            f"dim {HEAD_DIM} and K a multiple of 64")
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    scale, bias, kbias = scale.float(), bias.float(), kbias.float()
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("scale", scale, f32, (k,), dev)
    _build.check_tensor("bias", bias, f32, (k,), dev)
    _build.check_tensor("kernel", kernel, bf16, (k, 3 * hd), dev)
    _build.check_tensor("kbias", kbias, f32, (3 * hd,), dev)
    with torch.cuda.device(dev):
        xn = torch.empty((b * s, k), dtype=bf16, device=dev)
        qkv = torch.empty((b * s, 3 * hd), dtype=bf16, device=dev)
        out = torch.empty((b, s, hd), dtype=bf16, device=dev)
        _build.launch("uml_ln_qkv_attention", x.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), kernel.data_ptr(), kbias.data_ptr(),
                      xn.data_ptr(), qkv.data_ptr(), out.data_ptr(), b, s, k, heads,
                      int(causal), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    ln_qkv_attention.launches += 1
    return out


class LnQkvAttentionFn(torch.autograd.Function):
    """ln_qkv_attention with a gradient: the kernel forward, the backward
    through ln_qkv_attention_plain."""

    @staticmethod
    def forward(ctx, x, scale, bias, kernel, kbias, heads, causal, eps):
        ctx.cfg = (heads, causal, eps)
        ctx.save_for_backward(x, scale, bias, kernel, kbias)
        return _ln_qkv_attention_fwd(x, scale, bias, kernel, kbias, heads,
                                     causal, eps)

    @staticmethod
    def backward(ctx, g):
        heads, causal, eps = ctx.cfg
        return (*plain_vjp(
            lambda *a: ln_qkv_attention_plain(*a, heads=heads, causal=causal,
                                              eps=eps),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[:5]),
            None, None, None)


def ln_qkv_attention(x, scale, bias, kernel, kbias, *, heads: int,
                     causal: bool = False, eps: float = 1e-5,
                     impl: str = "auto"):
    """LN(x) -> packed QKV -> MHA; x [B, S, K], kernel [K, 3*H*D], output
    [B, S, H*D] on every path."""
    if _build.wants_kernel(impl, x):
        return LnQkvAttentionFn.apply(x, scale, bias, kernel, kbias, heads,
                                      causal, eps)
    return ln_qkv_attention_plain(x, scale, bias, kernel, kbias, heads=heads,
                                  causal=causal, eps=eps)


ln_qkv_attention.launches = 0
