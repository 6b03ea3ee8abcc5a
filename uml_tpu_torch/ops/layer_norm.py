"""LayerNorm over the last axis with fp32 statistics, the input's dtype kept.

The port of uml_tpu/ops/layer_norm.py::_ln_kernel (``csrc/layer_norm.cu``).
Its variance is the two-pass ``mean((x - mean)^2)``, not the fast variance
E[x^2] - E[x]^2 of the LN prologues in ``ln_matmul`` / ``fused_attention``;
eps defaults to 1e-5 (torch LayerNorm parity).

``impl`` as in uml_tpu: "auto" is the plain version for a CPU tensor and
the kernel for a CUDA tensor, "pallas" the hand-written kernel (both raise
on a CUDA tensor the gate ``supports_layer_norm`` does not take), anything
else ("reference") the plain version.  The backward
differentiates the plain version, recomputed (layer_norm.py:85-92).
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp


def layer_norm_plain(x, scale, bias, eps: float = 1e-5):
    """Plain PyTorch twin of layer_norm_reference."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def supports_layer_norm(k: int, dtype) -> bool:
    """The kernel reads rows in 8-element chunks, bf16 or fp32."""
    return dtype in (torch.bfloat16, torch.float32) and k % 8 == 0


def _layer_norm_fwd(x, scale, bias, eps):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor
    (x [..., K] bf16 or fp32, contiguous; scale, bias go in as fp32)."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    k = x.shape[-1]
    if not supports_layer_norm(k, x.dtype):
        raise ValueError(f"layer_norm kernel: K={k} {x.dtype}; it takes bf16 "
                         "or fp32 rows of a multiple of 8 elements")
    dev = x.device
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    _build.check_tensor("x", x, x.dtype, x.shape, dev)
    _build.check_tensor("scale", scale, torch.float32, (k,), dev)
    _build.check_tensor("bias", bias, torch.float32, (k,), dev)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _build.launch("uml_layer_norm", x.data_ptr(), scale.data_ptr(),
                      bias.data_ptr(), out.data_ptr(), x.numel() // k, k,
                      int(x.dtype == torch.float32), eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    layer_norm.launches += 1
    return out


class LayerNormFn(torch.autograd.Function):
    """layer_norm with a gradient: the kernel forward, the backward
    through layer_norm_plain."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale, bias)
        return _layer_norm_fwd(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        eps = ctx.eps
        return (*plain_vjp(lambda *a: layer_norm_plain(*a, eps),
                           ctx.saved_tensors, (g,), ctx.needs_input_grad[:3]),
                None)


def layer_norm(x, scale, bias, eps: float = 1e-5, impl: str = "auto"):
    """LayerNorm over the last axis of x [..., K] with fp32 statistics."""
    if _build.wants_kernel(impl, x):
        return LayerNormFn.apply(x, scale, bias, eps)
    return layer_norm_plain(x, scale, bias, eps)


layer_norm.launches = 0
