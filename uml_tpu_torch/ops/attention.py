"""Multi-head attention: the streaming (flash) kernel and the dense twins.

The port of uml_tpu/ops/attention.py.  Layout [B, H, S, D]
(``dense_attention_bshd``: [B, S, H, D]); softmax statistics in fp32
whatever the input dtype.

* ``mha_plain``: the twin of ``mha_reference`` (attention.py:32-58): the
  [S, S] scores kept in the INPUT dtype, the max-subtraction in that dtype,
  exp and normalization in fp32, the weights rounded to the input dtype
  before P.V; an additive [S, S] ``mask`` is added in fp32.
* ``dense_attention_bshd``: the same scheme with the (b, h) axes left where
  the packed-QKV reshape puts them.
* ``flash_attention``: the port of ``_flash_kernel``
  (``csrc/flash_attention.cu``, wgmma + TMA): K/V streamed in tiles with
  an online softmax, any S, D 64 or 128, causal or not.  For a CPU tensor
  it runs the half-blocks' ``attention_plain``, which has the kernel's
  numerics: the online softmax equals the one-pass softmax with the row
  max, and what remains is fp32 scores, P rounded to the input dtype
  unnormalized, 1 / rowsum applied to the fp32 P.V.
  ``_flash_attention_strided`` is the same kernel on strided views (a
  packed qkv read in place, the output written into a [B, S, H, D]
  buffer); both count their launches on ``flash_attention.launches``.
* ``multi_head_attention``: impl "auto" | "pallas" | anything else (the
  plain ``mha_plain``).  "auto" keeps the dense ``mha_plain`` below
  S = 1024 (uml_tpu's ``_FLASH_MIN_SEQ``, its own routing) and on the CPU,
  and takes the kernel for a CUDA tensor from there up; "pallas" is the
  hand-written kernel; both raise on a CUDA tensor
  ``supports_flash_attention`` does not take.  The backward differentiates
  ``mha_plain``, recomputed (attention.py:219-225).
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp
from uml_tpu_torch.ops.fused_attention import attention_plain

_NEG_INF = -1e30
FLASH_MIN_SEQ = 1024  # below it "auto" keeps the dense plain attention


def _masked_softmax_weights(scores, causal: bool, mask=None):
    """The softmax of mha_reference on scores [..., Sq, Sk] kept in the
    input dtype -> fp32 weights."""
    if causal:
        s = scores.shape[-1]
        neg = float("-inf") if scores.dtype == torch.bfloat16 else _NEG_INF
        keep = torch.ones(s, s, dtype=torch.bool, device=scores.device).tril()
        scores = scores.masked_fill(~keep, neg)
    if mask is not None:
        scores = (scores.float() + mask.float()).to(scores.dtype)
    m = scores.amax(-1, keepdim=True)
    e = torch.exp((scores - m).float())
    return e / e.sum(-1, keepdim=True)


def mha_plain(q, k, v, *, causal: bool = False, mask=None, scale=None):
    """Dense attention. q, k, v: [B, H, S, D] (v's D may differ); mask:
    additive [S, S] or None; ``scale`` the scores' factor, q's D^-1/2 by
    default."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q, k.transpose(-1, -2)) * scale
    weights = _masked_softmax_weights(scores, causal, mask)
    return torch.matmul(weights.to(q.dtype), v)


def dense_attention_bshd(q, k, v, *, causal: bool = False):
    """Layout-preserving dense attention: q, k, v AND output [B, S, H, D]."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = _masked_softmax_weights(scores, causal)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(q.dtype), v)


def supports_flash_attention(d: int, dtype=torch.bfloat16) -> bool:
    """The kernel takes bf16 and head dims 64 and 128 (any S)."""
    return dtype == torch.bfloat16 and d in (64, 128)


def flash_attention(q, k, v, *, causal: bool = False):
    """Streaming attention. q, k, v: [B, H, S, D] bf16 -> [B, H, S, D]."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal=causal)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    return _flash_attention_strided(q, k, v, causal=causal)


def _strided_ok(t) -> bool:
    """What the kernel's tensor maps take of a view: the last axis
    contiguous, the other strides and the address 16-byte multiples."""
    return (t.stride(3) == 1 and all(st % 8 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _flash_attention_strided(q, k, v, *, causal: bool = False, out=None):
    """flash_attention on [B, H, S, D] VIEWS with any batch, head and row
    strides, e.g. q, k, v of a packed qkv [B, S, 3, H, D] permuted, written
    into ``out`` (a [B, H, S, D] view, e.g. of attention [B, S, H, D]; a
    new contiguous tensor when None), with no copy on the card.  -> out."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return out.copy_(attention_plain(q, k, v, causal=causal))
    b, h, s, d = q.shape
    if not supports_flash_attention(d, q.dtype):
        raise ValueError(f"flash_attention kernel: D={d} {q.dtype}; it takes "
                         "bf16 and head dims 64 and 128")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"flash_attention: {name} {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}, q {q.dtype} {tuple(q.shape)} on "
                             f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not _strided_ok(t):
            raise ValueError(f"flash_attention: {name} strides {t.stride()}: the "
                             "kernel takes a contiguous last axis and strides "
                             "and addresses of 16 bytes")
    if q.numel() == 0:
        return out
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        _build.launch("uml_flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, h, s, d, int(causal),
                      *strides, torch.cuda.current_stream(q.device).cuda_stream)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


class MhaFn(torch.autograd.Function):
    """flash_attention with a gradient: the backward through mha_plain."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, g):
        causal = ctx.causal
        return (*plain_vjp(lambda *a: mha_plain(*a, causal=causal),
                           ctx.saved_tensors, (g,), ctx.needs_input_grad[:3]),
                None)


def multi_head_attention(q, k, v, *, causal: bool = False, impl: str = "auto"):
    """Attention entry point. impl: 'auto' | 'pallas' | 'reference'."""
    if impl == "auto" and q.shape[2] < FLASH_MIN_SEQ:
        impl = "reference"
    if _build.wants_kernel(impl, q):
        return MhaFn.apply(q.contiguous(), k.contiguous(), v.contiguous(), causal)
    return mha_plain(q, k, v, causal=causal)
