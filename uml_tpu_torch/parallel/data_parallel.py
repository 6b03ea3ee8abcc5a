"""Data parallelism over the mesh's ``data`` axis.

uml_tpu jits a step with the batch sharded over 'data' and the state
replicated, and XLA computes the *global-batch* math: every reduction
over the batch (a loss's mean, a BatchNorm's statistics, InfoNCE's
in-batch negatives) spans every device.  Here each rank runs the step on
its own rows, and the reductions over the batch go through this module:

  * ``global_batch(shard_for(mesh, n))`` marks the forward of an
    ``n``-row global batch: this rank's rows (``BatchShard.rows``) where
    ``n`` divides by the data axis, else the whole batch on every rank
    (uml_tpu's rule).
  * inside it, ``global_sum`` / ``global_mean`` / ``global_gather`` reduce
    over every rank's rows.  They are differentiable: the sum's backward
    sums the gradient over the ranks, the gather's backward sums it and
    keeps this rank's rows.  Outside it, or for a batch kept whole, they
    are the local operations, so a step without a mesh runs exactly the
    ops it ran before.
  * a loss built that way has the global batch's value on every rank;
    ``sync_gradients`` then sums the gradients over the ranks and divides
    by their number (DistributedDataParallel's average), which gives the
    global loss's gradient both for a split batch and for a whole one.

``make_dp_train_step`` wraps a loss function into such a step with uml_tpu's
contract: the same call as the step without a mesh, on the global batch.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from uml_tpu_torch.core.meshes import (
    data_group,
    data_rank,
    data_size,
    maybe_shard_batch,
    row_slice,
)
from uml_tpu_torch.parallel.tensor_parallel import local


def dp_shardings(mesh):
    """(replicated, batch-split) placements of the data axis, as DTensor
    names them.  (Kept for uml_tpu's API; the port's loops place rows
    with ``BatchShard`` instead.)"""
    from torch.distributed.tensor import Replicate, Shard

    return Replicate(), Shard(0)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllGather(torch.autograd.Function):
    """Rows of every rank, in rank order; the backward sums the gradient
    over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        start = ctx.rank * ctx.rows
        return grad[start:start + ctx.rows], None


@dataclass(frozen=True)
class BatchShard:
    """How one global batch lies over the data axis: ``split`` rows per
    rank, or whole on every rank."""

    mesh: object
    split: bool

    def rows(self, tree):
        return maybe_shard_batch(self.mesh, tree) if self.split else tree

    def sum(self, t):
        return _AllReduceSum.apply(t, data_group(self.mesh)) if self.split else t

    def gather(self, t):
        return _AllGather.apply(t, data_group(self.mesh)) if self.split else t

    @property
    def offset(self) -> int:
        """Global index of this rank's first row, per local row count."""
        return data_rank(self.mesh) if self.split else 0


def shard_for(mesh, n: int) -> BatchShard | None:
    """The BatchShard of an ``n``-row global batch (None without a mesh)."""
    if mesh is None:
        return None
    return BatchShard(mesh, row_slice(mesh, n) is not None)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("uml_batch_shard",
                                                         default=None)


@contextlib.contextmanager
def global_batch(shard: BatchShard | None):
    """Route the batch reductions of the enclosed forward over ``shard``."""
    token = _ACTIVE.set(shard)
    try:
        yield shard
    finally:
        _ACTIVE.reset(token)


def active_shard() -> BatchShard | None:
    """The split BatchShard of the enclosing forward, else None."""
    shard = _ACTIVE.get()
    return shard if shard is not None and shard.split else None


def global_sum(t):
    shard = active_shard()
    return t if shard is None else shard.sum(t)


def global_gather(t):
    shard = active_shard()
    return t if shard is None else shard.gather(t)


def global_mean(t):
    """Mean of every element of ``t`` over the global batch."""
    shard = active_shard()
    if shard is None:
        return torch.mean(t)
    count = torch.tensor(float(t.numel()), device=t.device)
    return shard.sum(torch.sum(t)) / shard.sum(count)


def global_rows(n_local: int) -> int:
    """Rows of the enclosing forward's global batch, per local row count."""
    shard = active_shard()
    return n_local if shard is None else n_local * data_size(shard.mesh)


def row_offset(n_local: int) -> int:
    """Global index of this rank's first row of the enclosing forward."""
    shard = active_shard()
    return 0 if shard is None else shard.offset * n_local


def all_sum(tensors, mesh):
    """Sum a list of tensors over the data axis in one collective (no
    autograd); identity without a mesh."""
    if mesh is None or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=data_group(mesh))
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def owns(mesh, i: int) -> bool:
    """Whether this rank takes work item ``i`` (round robin over the data
    axis; every item on a run without a mesh)."""
    return mesh is None or i % data_size(mesh) == data_rank(mesh)


def gather_in_order(mesh, local: list, to_all: bool = False):
    """The results of this rank's items (``owns``), in order -> every
    item's result in item order, on rank 0 (on every rank with
    ``to_all``; None on the others).  Picklable results (numpy arrays,
    lists, strings) cross the group once."""
    if mesh is None:
        return local
    group = data_group(mesh)
    n = data_size(mesh)
    parts = [None] * n
    if to_all:
        dist.all_gather_object(parts, local, group=group)
    else:
        dist.gather_object(local, parts if data_rank(mesh) == 0 else None,
                           dst=dist.get_global_rank(group, 0), group=group)
        if data_rank(mesh) != 0:
            return None
    out = []
    for j in range(max(len(p) for p in parts)):
        out.extend(p[j] for p in parts if j < len(p))
    return out


_BUCKET_BYTES = 64 << 20


def sync_gradients(params, mesh) -> None:
    """Average the gradients over the data axis (sum, then divide by the
    rank count): flattened into buckets of about 64 MB of one dtype, one
    all-reduce a bucket, copied back with one multi-tensor copy; no-op
    without a mesh.  A tensor-parallel gradient averages its local shard."""
    if mesh is None:
        return
    n = data_size(mesh)
    group = data_group(mesh)
    buckets, size = {}, {}
    # a tensor-parallel gradient: this rank's shard, averaged over the
    # data ranks that hold the same shard
    for g in (local(p.grad) for p in params if p.grad is not None):
        key = (g.dtype, g.device)
        buckets.setdefault(key, [[]])
        if size.get(key, 0) >= _BUCKET_BYTES:
            buckets[key].append([])
            size[key] = 0
        buckets[key][-1].append(g)
        size[key] = size.get(key, 0) + g.numel() * g.element_size()
    for bucket in (b for bs in buckets.values() for b in bs):
        flat = _flatten_dense_tensors(bucket)
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat /= n
        torch._foreach_copy_(bucket, _unflatten_dense_tensors(flat, bucket))


def make_dp_train_step(loss_fn: Callable, mesh, params, optimizer) -> Callable:
    """-> step(*batch) -> (loss, aux) on the GLOBAL batch, with uml_tpu's
    contract: the same call with or without a mesh.

    ``loss_fn(*rows) -> (loss, aux)`` runs the forward on this rank's
    rows (inside ``global_batch``, so its reductions are the global
    batch's); the step zeroes the gradients, runs the backward, averages
    the gradients over the data axis and steps ``optimizer`` (a torch
    optimizer over ``params``)."""
    params = list(params)

    def step(*batch):
        # the leaves with a batch dim split alike, or all stay whole
        sizes = {len(b) for b in batch if np.ndim(b) >= 1}
        shard = None if mesh is None else BatchShard(
            mesh, len(sizes) == 1 and row_slice(mesh, sizes.pop()) is not None)
        rows = shard.rows(batch) if shard is not None else batch
        optimizer.zero_grad(set_to_none=False)
        with global_batch(shard):
            loss, aux = loss_fn(*rows)
        loss.backward()
        sync_gradients(params, mesh)
        optimizer.step()
        return loss.detach(), aux

    return step
