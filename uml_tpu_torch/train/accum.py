"""Microbatch gradient accumulation for full-model train steps.

The port of uml_tpu/train/accum.py.  A big-batch full-model step hits a
memory wall before a compute one: the forward stashes of the backward
(ops.fused_attention UML_BWD_STASH, ops.ln_matmul UML_MLP_STASH) hold
[S, 3HD] + [S, 4K] per image per layer, and past the MLP stash gate
(MLP_STASH_MAX_BYTES per layer, ViT-B/16 from batch 212 upward) the MLP
half falls back to recomputing its pre-activation.  The step then runs as
equal microbatches of the size at which the stashes stay on, with the
gradients accumulated in fp32 and the optimizer applied once by the
caller.  The semantics are the mean-of-means identity: equal microbatches
of a mean-reduced loss give the full batch's loss and gradients.

uml_tpu scans the microbatches inside one jitted program; here they are a
Python loop of forward and backward passes.
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops.ln_matmul import MLP_STASH_MAX_BYTES

__all__ = ["microbatched_step", "pick_microbatch"]


def pick_microbatch(batch: int, seq_len: int, hidden3: int, mlp_width: int,
                    itemsize: int = 2) -> int:
    """Largest divisor of ``batch`` whose per-layer forward-stash
    footprint (the wider of the attention qkv [S, 3HD] and the MLP pre
    [S, 4K], per image) stays under the MLP stash gate: the size at which
    the stashed backward still runs.  ``batch`` itself when it already
    fits (no accumulation)."""
    per_img = seq_len * max(hidden3, mlp_width) * itemsize
    if batch * per_img <= MLP_STASH_MAX_BYTES:
        return batch
    return next((d for d in range(batch // 2, 0, -1)
                 if batch % d == 0 and d * per_img <= MLP_STASH_MAX_BYTES),
                1)


def _grads(loss, params):
    """d loss / d params, a zero tensor for a parameter the loss does not
    reach (as jax.grad gives one for every leaf)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def microbatched_step(loss_fn, params, *batch_args, microbatch: int):
    """``(loss, grads)`` of ``loss_fn(*batch_args)`` with respect to
    ``params`` (a sequence of tensors), over microbatch slices.

    ``loss_fn`` must MEAN-reduce over the batch axis (axis 0 of every
    ``batch_args`` entry), the convention of every loss in the repo.  The
    batch axis is cut into ``n = B // microbatch`` equal slices (``B %
    microbatch == 0``, else ValueError); each slice runs forward and
    backward, its gradients are added up in fp32, and the loss and the
    gradients are the mean over the slices (the loss in fp32, each
    gradient in its parameter's dtype) — uml_tpu's
    ``microbatched_value_and_grad`` contract.  When ``microbatch`` >= the
    batch it is one plain step.  The gradients are returned, not written
    to ``.grad``."""
    params = list(params)
    b = batch_args[0].shape[0]
    if microbatch >= b:
        loss = loss_fn(*batch_args)
        return loss, _grads(loss, params)
    if b % microbatch != 0:
        raise ValueError(f"batch {b} is not a multiple of microbatch {microbatch}")
    n = b // microbatch
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    grad_sum = [torch.zeros_like(p, dtype=torch.float32) for p in params]
    for i in range(n):
        chunk = tuple(a[i * microbatch:(i + 1) * microbatch] for a in batch_args)
        loss = loss_fn(*chunk)
        for acc, g in zip(grad_sum, _grads(loss, params)):
            acc.add_(g.float())
        loss_sum += loss.detach().float()
    inv = 1.0 / n
    return loss_sum * inv, [(g * inv).to(p.dtype) for p, g in zip(params, grad_sum)]
