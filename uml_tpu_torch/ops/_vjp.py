"""The backward of an op whose TPU kernel has no backward kernel: autograd
through the op's plain PyTorch version, recomputed from the saved inputs,
as each such ``custom_vjp`` of uml_tpu differentiates its jnp twin.

On the card, with bf16 activations, the products of that recompute and of
its backward run on the tensor cores in TF32 with fp32 accumulation, not
as fp32 SIMT SGEMMs: the plain versions multiply fp32 copies of bf16
values, and TF32 keeps 10 mantissa bits where bf16 has 7, so those
products equal the bf16 x bf16 -> fp32 products of the jnp twins
(``preferred_element_type=f32``).  The products that take an fp32
cotangent round it to TF32 (~2^-11 relative).  The switch is scoped: the
global ``torch.backends.cuda.matmul.allow_tf32`` is restored after.  fp32
activations (an fp32 model) and the CPU keep full fp32 products.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def tf32_products(on: bool = True):
    """TF32 tensor-core matmuls inside the block when ``on``; the global
    flag as it was after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = old or on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def plain_vjp(plain_fn, inputs, cotangents, needs):
    """Gradients of ``plain_fn(*inputs)`` (a tensor or a tuple of tensors)
    against ``cotangents``, for the inputs flagged in ``needs``; None for
    the others.  TF32 products when the first input (the activation) is a
    bf16 tensor on the card."""
    detached = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    x = inputs[0]
    with tf32_products(x.is_cuda and x.dtype == torch.bfloat16), torch.enable_grad():
        out = plain_fn(*detached)
        outs = out if isinstance(out, tuple) else (out,)
        wanted = [t for t, n in zip(detached, needs) if n]
        grads = iter(torch.autograd.grad(outs, wanted, cotangents,
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
