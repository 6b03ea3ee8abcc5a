"""Attention half-block: x + MHA(rawLN(x) @ w_eff + b_eff) @ wo + bo.

The port of uml_tpu/ops/fused_attention.py::_block_kernel (every query
row, causal or not) and ::_block_cls_kernel (the last image layer, whose
only consumer is the CLS row), and of their training twins:
``_block_kernel_stash`` (the forward that keeps qkv and the attention
output), ``_block_bwd_stash_kernel`` (the backward from that stash) and
``_block_bwd_cls_kernel`` (the backward of the CLS layer).

Every op takes the post-fold weights (fold_ln_into_matmul): on a CPU
tensor it runs the plain PyTorch version below, written from the jnp twin
``_raw_block_reference``; on a CUDA tensor it launches its C entry point
in ``csrc/`` or raises, and counts the launch.

* ``attn_block`` / ``attn_block_cls``: ``csrc/attn_block.cu`` (LN-prologue
  QKV ln_gemm, the attention kernel, the out-projection ln_gemm with the
  residual).  The CLS variant returns [B, 1, K]: the TPU kernel's
  [B, 8, K] (CLS_ROWS = 8) is a sublane tile, and only its row 0 is used.
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
  computes for every row (``attn_block_cls`` projects all S rows), so K
  and V are not recomputed.
* ``AttnBlockFn`` / ``AttnBlockClsFn``: the autograd Functions of the two
  halves; they assemble dW_eff, db_eff, dwo and dbo from the backward's
  outputs as ``_bwd_via_kernel`` does (fused_attention.py:1586-1594), as
  plain large products outside the kernels.

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

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.ln_matmul import (raw_layer_norm, raw_layer_norm_bwd,
                                         raw_layer_norm_rstd)

HEAD_DIM = 64  # the kernels' head dim (every CLIP tower)
MAX_SEQ = 400  # the attention kernel keeps K/V of one head in shared memory
BWD_MAX_SEQ = 256  # the backward's dq kernel also keeps the fp32 scores and dP


def fold_ln_into_matmul(scale, bias, kernel, kbias):
    """Fold LN affine params into the following matmul's weights:
    (xn*scale + bias) @ W + b  ==  xn @ (scale*W) + (b + bias@W).

    Fold math runs in fp32; ``w_eff`` is cast back to the weight dtype and
    ``b_eff`` stays fp32 (fused_attention.py:1706-1717)."""
    kf = kernel.float()
    w_eff = (scale.float()[:, None] * kf).to(kernel.dtype)
    b_eff = kbias.float() + bias.float() @ kf
    return w_eff, b_eff


def attention_plain(q, k, v, *, causal: bool):
    """q [B,H,Sq,D], k/v [B,H,S,D] -> [B,H,Sq,D]: fp32 scores and softmax
    (row max), probabilities rounded to the input dtype unnormalized, the
    1/rowsum applied to the fp32 P.V — the CUDA kernel's order."""
    d = q.shape[-1]
    s = (q.float() @ k.float().transpose(-1, -2)) * d ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril(sk - sq)
        s = s.masked_fill(~keep, float("-inf"))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    inv = 1.0 / e.sum(-1, keepdim=True)
    return ((e.to(q.dtype).float() @ v.float()) * inv).to(q.dtype)


def _qkv_heads(qkv, heads):
    """[B, S, 3*H*D] -> q, k, v as [B, H, S, D]."""
    b, s, m3 = qkv.shape
    d = m3 // (3 * heads)
    return qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)


def attn_block_stash_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                           causal: bool = False, eps: float = 1e-5,
                           q_rows=None):
    """Plain PyTorch version of the attention half-block (post-fold) that
    also returns its stash: (out [B, sq, K], qkv [B, S, 3*H*D] with
    b_eff, attn [B, sq, H*D]).  ``q_rows`` keeps only the first query
    rows (1 for the CLS block)."""
    b, s, _ = x.shape
    sq = s if q_rows is None else q_rows
    dt = w_eff.dtype
    xf = x.float()
    xn = raw_layer_norm(xf, eps).to(dt)
    qkv = (xn.float() @ w_eff.float() + b_eff.float()).to(dt)
    q, k, v = _qkv_heads(qkv, heads)
    attn = attention_plain(q[:, :, :sq], k, v, causal=causal)
    attn = attn.transpose(1, 2).reshape(b, sq, -1)
    delta = attn.float() @ wo.float()
    out = (xf[:, :sq] + delta + bo.float()).to(x.dtype)
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


def _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal, eps, q_rows,
                       entry="uml_attn_block"):
    """-> (out, qkv, attn): the output and the scratch the launches wrote."""
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    _build.check_dims(K=k)
    if s > MAX_SEQ:
        raise ValueError(f"S={s}: the attention kernel takes S <= {MAX_SEQ}")
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("w_eff", w_eff, bf16, (k, 3 * hd), dev)
    _build.check_tensor("b_eff", b_eff, torch.float32, (3 * hd,), dev)
    _build.check_tensor("wo", wo, bf16, (hd, k), dev)
    _build.check_tensor("bo", bo, torch.float32, (k,), dev)
    with torch.cuda.device(dev):
        qkv = torch.empty((b * s, 3 * hd), dtype=bf16, device=dev)
        attn = torch.empty((b * q_rows, hd), dtype=bf16, device=dev)
        out = torch.empty((b, q_rows, k), dtype=bf16, device=dev)
        ptrs = (x.data_ptr(), w_eff.data_ptr(), b_eff.data_ptr(),
                wo.data_ptr(), bo.data_ptr(), qkv.data_ptr(), attn.data_ptr(),
                out.data_ptr(), b, s, k, heads, int(causal))
        stream = torch.cuda.current_stream(dev).cuda_stream
        if entry == "uml_attn_block":
            _build.launch(entry, *ptrs, q_rows, eps, stream)
        else:
            _build.launch(entry, *ptrs, eps, stream)
    return out, qkv.view(b, s, 3 * hd), attn.view(b, q_rows, hd)


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
                               q_rows=1)
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
                               q_rows=x.shape[1], entry="uml_attn_block_stash")
    attn_block_stash.launches += 1
    return stash


attn_block_stash.launches = 0


def _check_bwd(x, g, qkv, w_eff, wo, heads, q_rows):
    b, s, k = x.shape
    hd = heads * HEAD_DIM
    _build.check_dims(K=k)
    if s > BWD_MAX_SEQ:
        raise ValueError(f"S={s}: the attention backward takes S <= {BWD_MAX_SEQ}")
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, (b, s, k), dev)
    _build.check_tensor("g", g, bf16, (b, q_rows, k), dev)
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
    x [B,S,K], g [B,1,K] -> (dx [B,S,K], dqkv [B,S,3*H*64], xn [B,S,K])."""
    if x.device.type == "cpu":
        return attn_block_cls_bwd_plain(x, g, qkv, w_eff, wo, heads=heads,
                                        eps=eps)
    b, s, k, hd, bf16, dev = _check_bwd(x, g, qkv, w_eff, wo, heads, 1)
    with torch.cuda.device(dev):
        dattn = torch.empty((b, hd), dtype=bf16, device=dev)
        dxn = torch.empty((b * s, k), dtype=torch.float32, device=dev)
        dqkv = torch.empty((b, s, 3 * hd), dtype=bf16, device=dev)
        dx = torch.empty_like(x)
        xn = torch.empty_like(x)
        _build.launch("uml_attn_block_cls_bwd", x.data_ptr(), g.data_ptr(),
                      qkv.data_ptr(), w_eff.data_ptr(), wo.data_ptr(),
                      dattn.data_ptr(), dxn.data_ptr(), dqkv.data_ptr(),
                      dx.data_ptr(), xn.data_ptr(), b, s, k, heads, eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    attn_block_cls_bwd.launches += 1
    return dx, dqkv, xn


attn_block_cls_bwd.launches = 0


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
    """attn_block with a gradient: the stash forward, the stash backward."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, wo, bo, heads, causal, eps):
        out, qkv, attn = attn_block_stash(x, w_eff, b_eff, wo, bo, heads=heads,
                                          causal=causal, eps=eps)
        ctx.save_for_backward(x, w_eff, b_eff, wo, bo, qkv, attn)
        ctx.cfg = (heads, causal, eps)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w_eff, b_eff, wo, bo, qkv, attn = ctx.saved_tensors
        heads, causal, eps = ctx.cfg
        g = g.contiguous()
        dx, dqkv, xn = attn_block_bwd(x, g, qkv, w_eff, wo, heads=heads,
                                      causal=causal, eps=eps)
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
