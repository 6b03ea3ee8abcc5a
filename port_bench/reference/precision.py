"""The products of the reference: float32 with TF32 off, or the control.

``matmul`` is what the reference models call for every product.  The
control (``fp8_matmul``) is the reference one precision step below the
configurations' bfloat16, in the hybrid float8 recipe of FP8 training:
each operand of every product is rounded under a per-tensor scale that
maps its largest magnitude to the format's largest finite value, to e4m3
(448) in the forward and for the forward operands the backward reuses,
and to e5m2 (57344) for the incoming gradient, whose range is wider; the
products accumulate in float32.  The text encoder states float32, and its
control (``tf32_matmul``) is the same product in TF32, the step below it.
"""

from __future__ import annotations

import contextlib

import torch

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def strict_fp32():
    """No TF32 in float32 products or convolutions inside the block; the
    flags are restored after it, so the program runs as it would."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def matmul(a, b):
    return torch.matmul(a, b)


def to_fp8(t, fmt: str = "e4m3"):
    """``t`` rounded to float8 ``fmt`` under a per-tensor scale, as float32."""
    dtype, top = FORMATS[fmt]
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_fp8(a), to_fp8(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        gq = to_fp8(g, "e5m2")
        ga = torch.matmul(gq, to_fp8(b).transpose(-2, -1))
        gb = torch.matmul(to_fp8(a).transpose(-2, -1), gq)
        # undo broadcasting over leading dimensions
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a, b):
    return _Fp8Matmul.apply(a, b)


def tf32_matmul(a, b):
    """The product with TF32 on, whatever the flags around it say."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


MATMULS = {"fp32": matmul, "fp8": fp8_matmul, "tf32": tf32_matmul}
