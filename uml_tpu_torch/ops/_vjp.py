"""The backward of an op whose TPU kernel has no backward kernel: autograd
through the op's plain PyTorch version, recomputed from the saved inputs,
as each such ``custom_vjp`` of uml_tpu differentiates its jnp twin."""

from __future__ import annotations

import torch


def plain_vjp(plain_fn, inputs, cotangents, needs):
    """Gradients of ``plain_fn(*inputs)`` (a tensor or a tuple of tensors)
    against ``cotangents``, for the inputs flagged in ``needs``; None for
    the others."""
    detached = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
    with torch.enable_grad():
        out = plain_fn(*detached)
    outs = out if isinstance(out, tuple) else (out,)
    wanted = [t for t, n in zip(detached, needs) if n]
    grads = iter(torch.autograd.grad(outs, wanted, cotangents,
                                     allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
