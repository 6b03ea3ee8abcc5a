"""Attention half-block: x + MHA(rawLN(x) @ w_eff + b_eff) @ wo + bo.

The port of uml_tpu/ops/fused_attention.py::_block_kernel (every query
row, causal or not) and ::_block_cls_kernel (the last image layer, whose
only consumer is the CLS row).  ``attn_block`` / ``attn_block_cls`` take
the post-fold weights (fold_ln_into_matmul): on a CPU tensor they run the
plain PyTorch version below, written from the jnp twin
``_raw_block_reference``; on a CUDA tensor they launch
``csrc/attn_block.cu`` (LN-prologue QKV ln_gemm, the attention kernel, the
out-projection ln_gemm with the residual) or raise.

The CLS variant returns [B, 1, K]: the TPU kernel's [B, 8, K]
(CLS_ROWS = 8) is a sublane tile, and only its row 0 is used.

Numerics, as in the twin: fp32 LN statistics, bf16 operands with fp32
accumulation, the full b_eff added to qkv before its bf16 rounding, an
fp32 softmax with the row max, bf16 probabilities.  (The TPU kernel
instead drops the k-bias, which the softmax cancels exactly, and adds the
v-bias after normalization; in bf16 the two orders round differently.)
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops.ln_matmul import raw_layer_norm

HEAD_DIM = 64  # the kernels' head dim (every CLIP tower)
MAX_SEQ = 400  # the attention kernel keeps K/V of one head in shared memory


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


def attn_block_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                     causal: bool = False, eps: float = 1e-5, q_rows=None):
    """Plain PyTorch version of the attention half-block (post-fold);
    ``q_rows`` keeps only the first query rows (1 for the CLS block)."""
    b, s, _ = x.shape
    sq = s if q_rows is None else q_rows
    dt = w_eff.dtype
    d = w_eff.shape[1] // (3 * heads)
    xf = x.float()
    xn = raw_layer_norm(xf, eps).to(dt)
    qkv = (xn.float() @ w_eff.float() + b_eff.float()).to(dt)
    q, k, v = qkv.view(b, s, 3, heads, d).permute(2, 0, 3, 1, 4)
    attn = attention_plain(q[:, :, :sq], k, v, causal=causal)
    attn = attn.transpose(1, 2).reshape(b, sq, heads * d)
    delta = attn.float() @ wo.float()
    return (xf[:, :sq] + delta + bo.float()).to(x.dtype)


def attn_block_cls_plain(x, w_eff, b_eff, wo, bo, *, heads: int,
                         eps: float = 1e-5):
    return attn_block_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                            causal=False, eps=eps, q_rows=1)


def _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal, eps, q_rows):
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
        _build.launch("uml_attn_block", x.data_ptr(), w_eff.data_ptr(),
                      b_eff.data_ptr(), wo.data_ptr(), bo.data_ptr(),
                      qkv.data_ptr(), attn.data_ptr(), out.data_ptr(),
                      b, s, k, heads, int(causal), q_rows, eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    return out


def attn_block(x, w_eff, b_eff, wo, bo, *, heads: int, causal: bool = False,
               eps: float = 1e-5):
    """x [B,S,K]; w_eff [K,3*H*64] (ln_1-folded); b_eff [3*H*64] fp32;
    wo [H*64,K]; bo [K] fp32 -> [B,S,K]."""
    if x.device.type == "cpu":
        return attn_block_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                causal=causal, eps=eps)
    out = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, causal, eps,
                             q_rows=x.shape[1])
    attn_block.launches += 1
    return out


attn_block.launches = 0


def attn_block_cls(x, w_eff, b_eff, wo, bo, *, heads: int, eps: float = 1e-5):
    """Non-causal attention half-block for the CLS row only: K/V cover all
    S rows, queries and output only row 0 -> [B,1,K]."""
    if x.device.type == "cpu":
        return attn_block_cls_plain(x, w_eff, b_eff, wo, bo, heads=heads,
                                    eps=eps)
    out = _launch_attn_block(x, w_eff, b_eff, wo, bo, heads, False, eps,
                             q_rows=1)
    attn_block_cls.launches += 1
    return out


attn_block_cls.launches = 0


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
