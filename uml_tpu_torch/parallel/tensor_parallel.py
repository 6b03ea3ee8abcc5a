"""Tensor-parallel sharding rules for the port's transformer modules.

The port of uml_tpu/parallel/tensor_parallel.py.  uml_tpu annotates a
parameter tree with Megatron shardings over the mesh's ``model`` axis
(column-parallel for the products that expand the hidden width: QKV,
c_fc / fc1 / linear1; row-parallel for those that contract it: the
out-projection, c_proj / fc2 / linear2) and lets pjit insert the
collectives.  Here the mesh is ``core.meshes.create_mesh``'s
``DeviceMesh`` over (data, model): each rule's weight becomes a
``DTensor`` sharded over ``model`` and replicated over ``data``, and
every other parameter and buffer stays a plain tensor, which every rank
holds whole (as the data-parallel loops keep them).

The layouts differ from uml_tpu's: a float weight here is ``nn.Linear``'s
[out, in], so uml_tpu's column spec P(None, model) on its [in, out]
kernel is ``Shard(0)`` and the row spec P(model, None) is ``Shard(1)``;
``Q8Dense.kernel_q8`` keeps uml_tpu's int8 [in, out] layout, so there the
column rule is ``Shard(1)`` and the row rule ``Shard(0)``.  A column
rule's bias or per-channel scale is split with its output channels, a
row rule's is replicated (uml_tpu's ``_spec_for``).  Patterns are
searched in the parameter's full dotted name, so the port's names
(CLIP's packed ``attn.in_proj_weight``, DINO's ``qkv`` / ``attn_out`` /
``fc1`` / ``fc2``, the seq autoencoder's ``qkv`` / ``out_proj`` /
``linear1`` / ``linear2``, LLaMA's HF names) land where uml_tpu places
their counterparts.

The forward keeps the global semantics, as XLA does for a custom call:
``apply_tp_sharding`` registers a parametrization that gathers each
sharded tensor whole (``DTensor.full_tensor``, an all-gather over
``model``; its backward keeps this rank's slice of the gradient), so
every access to the weight (``module.weight``) reads the whole tensor,
and no kernel, plain version or cache ever sees a shard.  Every model
here takes that route, LLaMA too (its heads are never split over ranks:
a packed qkv split contiguously would give rank 0 q and half of k).  The
optimizer state of a sharded weight stays sharded; ``storage_key`` keys
the models' caches on the local shard (a DTensor's own ``data_ptr`` is
0).  A parametrized module's state_dict names the sharded tensors
``parametrizations.<name>.original``.
"""

from __future__ import annotations

import re
import sys

import torch
from torch import nn

from uml_tpu_torch.core.meshes import DATA_AXIS, MODEL_AXIS

# name regex -> "col" | "row": Megatron's layout; the full dotted name of
# each parameter or buffer is searched, the first rule that matches wins
_DEFAULT_RULES = [
    (r"\bqkv\b|\bin_proj_(?:weight|bias)\b", "col"),
    (r"\bc_fc\b|\bfc1\b|\blinear1\b", "col"),
    (r"\bout_proj\b|\battn_out\b", "row"),
    (r"\bc_proj\b|\bfc2\b|\blinear2\b", "row"),
]


def transformer_tp_rules():
    return list(_DEFAULT_RULES)


def _placement_for(name: str, ndim: int, rules):
    """The ``model`` axis placement of one tensor (uml_tpu's _spec_for)."""
    from torch.distributed.tensor import Replicate, Shard

    leaf = name.rpartition(".")[2]
    for pattern, kind in rules:
        if not re.search(pattern, name):
            continue
        if ndim == 2 and leaf == "kernel_q8":      # int8 [in, out]
            return Shard(1) if kind == "col" else Shard(0)
        if ndim == 2 and leaf in ("weight", "in_proj_weight"):   # [out, in]
            return Shard(0) if kind == "col" else Shard(1)
        if ndim == 1 and kind == "col":
            # biases and per-output-channel scales follow the output dim
            return Shard(0)
        return Replicate()
    return Replicate()


def declared_name(name: str) -> str:
    """A parameter's or buffer's name as its module declares it: a sharded
    tensor's ``<owner>.parametrizations.<leaf>.original`` -> ``<owner>.<leaf>``."""
    return name.replace("parametrizations.", "").replace(".original", "")


def _tensors(module: nn.Module):
    """(name, tensor) of every parameter and buffer, sharded ones by the
    names their modules declare them under."""
    seen = set()
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        name = declared_name(name)
        if name not in seen:
            seen.add(name)
            yield name, t


def infer_sharding_tree(module: nn.Module, rules=None) -> dict:
    """{name: placement over ``model``} (``Shard(d)`` or ``Replicate()``)
    for every parameter and buffer of ``module``."""
    rules = rules if rules is not None else _DEFAULT_RULES
    return {name: _placement_for(name, t.ndim, rules)
            for name, t in _tensors(module)}


class _Gather(nn.Module):
    """The parametrization of a sharded tensor: the whole tensor,
    contiguous (a product may sum in another order for another layout, so
    the models keep their weights contiguous)."""

    def forward(self, x):
        return whole(x)


def apply_tp_sharding(module: nn.Module, mesh, rules=None) -> nn.Module:
    """Shard ``module``'s rule tensors over ``mesh``'s ``model`` axis, in
    place (returns it): each becomes a DTensor (replicated over ``data``)
    behind a parametrization that gathers it whole where it is read.  The
    tensors must lie on the mesh's device type, every rank holding the
    same values (as after ``core.meshes.replicate``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.nn.utils import parametrize

    dims = mesh.mesh_dim_names
    if tuple(dims) != (DATA_AXIS, MODEL_AXIS):
        raise ValueError(f"apply_tp_sharding: a ({DATA_AXIS}, {MODEL_AXIS}) mesh, "
                         f"got {dims}")
    for name, placement in infer_sharding_tree(module, rules).items():
        if not isinstance(placement, Shard):
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if parametrize.is_parametrized(owner, leaf):
            continue
        t = getattr(owner, leaf)
        with torch.no_grad():
            dt = distribute_tensor(t.detach(), mesh, [Replicate(), placement])
        if isinstance(t, nn.Parameter):
            setattr(owner, leaf, nn.Parameter(dt, requires_grad=t.requires_grad))
        else:
            setattr(owner, leaf, dt)
        parametrize.register_parametrization(owner, leaf, _Gather(), unsafe=True)
    return module


def _is_dtensor(t) -> bool:
    # no DTensor exists before torch.distributed.tensor is imported (a
    # 1.2 s import, which a process that never shards does not pay)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def whole(t):
    """A DTensor gathered whole (differentiably); any other tensor as it
    is."""
    return t.full_tensor() if _is_dtensor(t) else t


def local(t):
    """This rank's shard of a DTensor (its storage); any other tensor as
    it is."""
    return t.to_local() if _is_dtensor(t) else t


def split_sharded(params) -> list[dict]:
    """Optimizer parameter groups: the plain tensors, then the DTensors
    (each group only where it has members)."""
    params = list(params)
    groups = [[p for p in params if not _is_dtensor(p)],
              [p for p in params if _is_dtensor(p)]]
    return [{"params": g} for g in groups if g]


def storage_key(t):
    """What identifies a tensor's current values for a cache: its storage
    and version counter, a DTensor's by its local shard (every rank
    updates its shard together, so the shard's key moves with the
    whole)."""
    lt = local(t)
    return (lt.data_ptr(), t._version, lt._version)
