"""MLP half-block: x + quick_gelu(rawLN(x) @ w1 + b1) @ w2 + b2.

The port of uml_tpu/ops/ln_matmul.py::_mlp_block_kernel (its jnp twin is
``_raw_mlp_block_reference``) and of its training twin
``_mlp_block_kernel_stash``.  The ops take the post-fold weights (the LN
scale/bias folded into w1/b1 by fold_ln_into_matmul): on a CPU tensor
they run the plain PyTorch versions below, on a CUDA tensor they launch
``csrc/mlp_block.cu`` (two ln_gemm launches) or raise, and count the
launch.

* ``mlp_block``: the inference forward.
* ``mlp_block_stash``: the training forward -> (out, pre), pre =
  rawLN(x) @ w1 + b1 rounded to bf16; the activation is taken of the
  unrounded pre, the order of ln_matmul.py:199-204.
* ``mlp_bwd_via_stash``: the backward from the stash, plain PyTorch as
  the TPU package leaves it to XLA (``_mlp_bwd_via_stash``,
  ln_matmul.py:256-293): act and act' are evaluated at the bf16-rounded
  pre, as the reference does.
* ``MlpBlockFn``: the autograd Function.  Under the memory gate
  ``mlp_stash_enabled`` (the reference's ``_mlp_stash_enabled`` and
  MLP_STASH_MAX_BYTES) it stashes pre; otherwise it runs ``mlp_block``
  and its backward is the autograd of the plain twin, recomputed.

The activation is CLIP's quick_gelu, x * sigmoid(1.702 x)
(ln_matmul.py:678-679); DINO's exact GELU comes with the DINO encoders.
"""

from __future__ import annotations

import os

import torch

from uml_tpu_torch.ops import _build


def raw_layer_norm_rstd(xf: torch.Tensor, eps: float):
    """(xn, rstd): LayerNorm without affine over the last axis, on fp32
    input, with the statistics that define the reference's outputs:
    var = max(E[x^2] - E[x]^2, 0) (flax use_fast_variance)."""
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def raw_layer_norm(xf: torch.Tensor, eps: float) -> torch.Tensor:
    return raw_layer_norm_rstd(xf, eps)[0]


def raw_layer_norm_bwd(dxn, xn, rstd):
    """The backward of raw_layer_norm in fp32:
    rstd * (dxn - mean(dxn) - xn * mean(dxn * xn))."""
    m1 = dxn.mean(-1, keepdim=True)
    m2 = (dxn * xn).mean(-1, keepdim=True)
    return rstd * (dxn - m1 - xn * m2)


def quick_gelu_f32(x: torch.Tensor) -> torch.Tensor:
    return x * (1.0 / (1.0 + torch.exp(-1.702 * x)))


def mlp_block_plain(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Plain PyTorch version: bf16 (or fp32) operands, fp32 products and
    statistics, one rounding to the weight dtype before each matmul."""
    return mlp_block_stash_plain(x, w1, b1, w2, b2, eps=eps)[0]


def _check_mlp(x, w1, b1, w2, b2):
    """What the MLP kernels take -> (rows, K, M, dtype, device)."""
    k = x.shape[-1]
    m = w1.shape[-1]
    _build.check_dims(K=k, M=m)
    bf16, dev = torch.bfloat16, x.device
    _build.check_tensor("x", x, bf16, x.shape, dev)
    _build.check_tensor("w1", w1, bf16, (k, m), dev)
    _build.check_tensor("b1", b1, torch.float32, (m,), dev)
    _build.check_tensor("w2", w2, bf16, (m, k), dev)
    _build.check_tensor("b2", b2, torch.float32, (k,), dev)
    return x.numel() // k, k, m, bf16, dev


def mlp_block(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """x [..., K] bf16; w1 [K, M] bf16 (ln_2-folded); b1 [M] fp32;
    w2 [M, K] bf16; b2 [K] fp32 -> [..., K]."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, w1, b1, w2, b2, eps=eps)
    rows, k, m, bf16, dev = _check_mlp(x, w1, b1, w2, b2)
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


MLP_STASH_MAX_BYTES = 256 * 2**20  # per-layer pre-stash cap (see the gate)


def mlp_stash_enabled(bsz: int, s: int, m: int, itemsize: int) -> bool:
    """Stash the MLP pre-activation for the backward (UML_MLP_STASH=auto):
    ON while one layer's stash [B, S, M] stays under MLP_STASH_MAX_BYTES
    (bs128 ViT-B/16: 155 MB per layer); UML_MLP_STASH=1/0 forces it.
    The same gate as uml_tpu's _mlp_stash_enabled (ln_matmul.py:168-183)."""
    env = os.environ.get("UML_MLP_STASH", "auto")
    if env in ("0", "1"):
        return env == "1"
    return bsz * s * m * itemsize <= MLP_STASH_MAX_BYTES


def mlp_block_stash_plain(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """Plain PyTorch version of the stash forward -> (out, pre)."""
    xf = x.float()
    xn = raw_layer_norm(xf, eps).to(w1.dtype)
    pre = xn.float() @ w1.float() + b1.float()
    y = quick_gelu_f32(pre).to(w2.dtype)
    out = (xf + y.float() @ w2.float() + b2.float()).to(x.dtype)
    return out, pre.to(x.dtype)


def mlp_block_stash(x, w1, b1, w2, b2, *, eps: float = 1e-5):
    """The training forward of the MLP half-block: x [B, S, K] ->
    (out [B, S, K], pre [B, S, M])."""
    if x.device.type == "cpu":
        return mlp_block_stash_plain(x, w1, b1, w2, b2, eps=eps)
    rows, k, m, bf16, dev = _check_mlp(x, w1, b1, w2, b2)
    with torch.cuda.device(dev):
        pre = torch.empty((*x.shape[:-1], m), dtype=bf16, device=dev)
        hidden = torch.empty((rows, m), dtype=bf16, device=dev)
        out = torch.empty_like(x)
        _build.launch("uml_mlp_block_stash", x.data_ptr(), w1.data_ptr(),
                      b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                      pre.data_ptr(), hidden.data_ptr(), out.data_ptr(), rows,
                      k, m, eps, torch.cuda.current_stream(dev).cuda_stream)
    mlp_block_stash.launches += 1
    return out, pre


mlp_block_stash.launches = 0


def act_and_grad(pre32: torch.Tensor):
    """(quick_gelu(pre), d quick_gelu(pre) / d pre) in fp32 from one
    sigmoid (ln_matmul.py:296-302 computes the same two values)."""
    s = torch.sigmoid(1.702 * pre32)
    grad = pre32 * (1.0 - s)
    grad.mul_(1.702).add_(1.0).mul_(s)
    return pre32 * s, grad


def mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, *, eps: float = 1e-5):
    """All five grads of the MLP half-block from the stashed pre ->
    (dx, dw1, db1, dw2, db2); the products take operands in the weight
    dtype and accumulate in fp32 (ln_matmul.py:256-293)."""
    xn32, rstd = raw_layer_norm_rstd(x.float(), eps)
    xnb = xn32.to(w1.dtype)

    act, dact = act_and_grad(pre.float())
    yact = act.to(w2.dtype)
    dpre = torch.matmul(g.to(w2.dtype), w2.t()).float().mul_(dact)   # [..., M]
    dpreb = dpre.to(w1.dtype)
    dxn = torch.matmul(dpreb, w1.t()).float()                       # [..., K]
    dx = (raw_layer_norm_bwd(dxn, xn32, rstd) + g.float()).to(x.dtype)

    k, m = w1.shape
    dw1 = torch.matmul(xnb.reshape(-1, k).t(), dpreb.reshape(-1, m))
    db1 = dpre.reshape(-1, m).sum(0)
    dw2 = torch.matmul(yact.reshape(-1, m).t(), g.reshape(-1, k).to(w2.dtype))
    db2 = g.reshape(-1, k).sum(0, dtype=torch.float32)
    return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
            db2.to(b2.dtype))


class MlpBlockFn(torch.autograd.Function):
    """mlp_block with a gradient: the stash forward and backward under the
    memory gate, else the inference forward and the plain twin's VJP."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, eps):
        ctx.eps = eps
        if mlp_stash_enabled(x.shape[0], x.shape[1], w1.shape[1],
                             x.element_size()):
            out, pre = mlp_block_stash(x, w1, b1, w2, b2, eps=eps)
            ctx.save_for_backward(x, w1, b1, w2, b2, pre)
        else:
            out = mlp_block(x, w1, b1, w2, b2, eps=eps)
            ctx.save_for_backward(x, w1, b1, w2, b2)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if len(ctx.saved_tensors) == 6:
            x, w1, b1, w2, b2, pre = ctx.saved_tensors
            return (*mlp_bwd_via_stash(x, g, pre, w1, b1, w2, b2, eps=ctx.eps),
                    None)
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = mlp_block_plain(*inputs, eps=ctx.eps)
        return (*torch.autograd.grad(out, inputs, g), None)
