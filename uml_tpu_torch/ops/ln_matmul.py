"""MLP half-block: x + quick_gelu(rawLN(x) @ w1 + b1) @ w2 + b2.

The port of uml_tpu/ops/ln_matmul.py::_mlp_block_kernel (its jnp twin is
``_raw_mlp_block_reference``).  ``mlp_block`` takes the post-fold weights
(the LN scale/bias folded into w1/b1 by fold_ln_into_matmul): on a CPU
tensor it runs the plain PyTorch version below, on a CUDA tensor it
launches ``csrc/mlp_block.cu`` (two ln_gemm launches) or raises.

The activation is CLIP's quick_gelu, x * sigmoid(1.702 x)
(ln_matmul.py:678-679); DINO's exact GELU comes with the DINO encoders.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build


def raw_layer_norm(xf: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm without affine over the last axis, on fp32 input, with
    the statistics that define the reference's outputs:
    var = max(E[x^2] - E[x]^2, 0) (flax use_fast_variance)."""
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    return (xf - mean) * torch.rsqrt(var + eps)


def quick_gelu_f32(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-1.702 * x)))


def mlp_block_plain(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Plain PyTorch version: bf16 (or fp32) operands, fp32 products and
    statistics, one rounding to the weight dtype before each matmul."""
    xf = x.float()
    xn = raw_layer_norm(xf, eps).to(w1.dtype)
    y = quick_gelu_f32(xn.float() @ w1.float() + b1.float()).to(w2.dtype)
    out = y.float() @ w2.float()
    return (xf + out + b2.float()).to(x.dtype)


def mlp_block(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x [..., K] bf16; w1 [K, M] bf16 (ln_2-folded); b1 [M] fp32;
    w2 [M, K] bf16; b2 [K] fp32 -> [..., K]."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, eps=eps)
    k = x.shape[-1]
    m = w1.shape[-1]
    _build.check_dims(K=k, M=m)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, x.shape, dev)
    _build.check_tensor("w1", w1, bf16, (k, m), dev)
    _build.check_tensor("b1", b1, torch.float32, (m,), dev)
    _build.check_tensor("w2", w2, bf16, (m, k), dev)
    _build.check_tensor("b2", b2, torch.float32, (k,), dev)
    rows = x.numel() // k
    with torch.cuda.device(dev):
        hidden = torch.empty((rows, m), dtype=bf16, device=dev)
        out = torch.empty_like(x)
        _build.launch("uml_mlp_block", x.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      hidden.data_ptr(), out.data_ptr(), rows, k, m, eps,
                      torch.cuda.current_stream(dev).cuda_stream)
    mlp_block.launches += 1
    return out


mlp_block.launches = 0


def ln_mlp_block(x, scale, bias, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x + quick_gelu(LN(x) @ w1 + b1) @ w2 + b2 with the LN affine params
    folded into w1/b1 first — the signature of uml_tpu's ln_mlp_block."""
    from uml_tpu_torch.ops.fused_attention import fold_ln_into_matmul

    w1_eff, b1_eff = fold_ln_into_matmul(scale, bias, w1, b1)
    return mlp_block(x, w1_eff, b1_eff, w2, b2.float(), eps=eps)
