"""CLIP text tower: L causal pre-LN layers over stacked, LN-folded weights.

The port of uml_tpu/ops/text_tower.py::_tower_kernel.  On a CPU tensor
``text_tower`` runs the plain version (the per-layer plain half-blocks,
as the jnp twin ``text_tower_reference`` composes the per-layer twins); on
a CUDA tensor it launches ``csrc/text_tower.cu`` or raises.  Two
hand-written paths, routed by ``text_tower_fused`` as the C entry routes
them:

* S <= 128, K <= 512 and H*64 <= 512 (the ViT-B text tower, S = 77): one
  persistent launch per call that walks the work items ``tower_plan``
  lays out (seven stages a layer: ln1, qkv, attn, out, ln2, mlp_in,
  mlp_out; a device copy of the table is cached per shape), with a
  counter per (group, layer, stage) in device memory in place of kernel
  boundaries (``_counters``: zero before the launch, and the kernel leaves
  them zero);
* any other shape (the ViT-L/14 text tower, K = 768; S > 128): the chain,
  one C call that loops over the layers and launches the causal attention
  half and the MLP half of each; each layer's fused QKV + attention kernel
  (S <= 256) counts on ``qkv_attention.launches`` too (``count_attention``).

The residual is rounded to the activation dtype between halves and
between layers, as in the TPU kernel.

``TextTowerFn`` gives the tower a gradient as uml_tpu's custom_vjp does
(text_tower.py:246-264): the kernel forward, the backward by autograd
through ``text_tower_plain``, recomputed from the saved inputs.
``supports_text_tower`` is the shape gate of the model's UML_TEXT_TOWER
switch.

    w_eff [L,K,3*H*64], b_eff [L,3*H*64]  ln_1-folded QKV
    wo [L,H*64,K], bo [L,K]                attention out-projection
    w1 [L,K,M], b1 [L,M]                   ln_2-folded c_fc (M = 4K)
    w2 [L,M,K], b2 [L,K]                   c_proj
"""

from __future__ import annotations

import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops._vjp import plain_vjp
from uml_tpu_torch.ops.fused_attention import (HEAD_DIM, attn_block_plain,
                                               check_head_dim,
                                               count_attention, qkv_scratch)
from uml_tpu_torch.ops.ln_matmul import mlp_block_plain


def text_tower_plain(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, *, heads: int,
                     eps: float = 1e-5):
    for l in range(w_eff.shape[0]):
        x = attn_block_plain(x, w_eff[l], b_eff[l], wo[l], bo[l], heads=heads,
                             causal=True, eps=eps)
        x = mlp_block_plain(x, w1[l], b1[l], w2[l], b2[l], eps=eps)
    return x


# the one-launch tower's limits (csrc/text_tower.cu: TT_MAX_S, TT_MAX_K)
TOWER_MAX_S = 128
TOWER_MAX_K = 512
TOWER_ROWS = 128        # rows of a product item's tile
TOWER_LN_ROWS = 32      # rows of an LN item
TOWER_MAX_GROUP = 8     # sequences a group, at most
# the stages of a layer, in order; an item of stage s waits for stage s - 1
# of its group and layer complete (ln1 for the last stage of the layer
# before)
TOWER_OPS = ("ln1", "qkv", "attn", "out", "ln2", "mlp_in", "mlp_out")
# the fields of a table row (csrc/text_tower.cu: TT_OP .. TT_SIGNAL)
TOWER_FIELDS = ("op", "layer", "row0", "rows", "col0", "bn", "wait",
                "target", "signal", "kn", "parts", "part", "poff", "tile")
# the most contraction parts a product's tile is split into, each part at
# least two 64-row steps of the contraction: the deep MLP out and the
# out-projection, which have the fewest tiles
TOWER_MAX_PARTS = {"mlp_out": 4, "qkv": 1, "out": 2, "mlp_in": 1}


def text_tower_fused(s: int, k: int, heads: int) -> bool:
    """The route of text_tower on the card, as csrc/text_tower.cu takes it:
    the one-launch tower for S <= 128 (one 128-key chunk of attention), K
    <= 512 and H*64 <= 512 (an LN item keeps its rows in registers), the
    chain of launches otherwise."""
    return s <= TOWER_MAX_S and k <= TOWER_MAX_K and heads * HEAD_DIM <= TOWER_MAX_K


def tower_group(b: int, s: int) -> int:
    """Sequences per group: the most of the group's rows real in its
    128-row tiles (G = 8 at S = 77: 616 rows in 640), fewer sequences on a
    tie (more groups to pipeline), at most TOWER_MAX_GROUP and B."""
    def fill(g):
        rows = g * s
        return rows / (-(-rows // TOWER_ROWS) * TOWER_ROWS)
    return max(range(1, min(b, TOWER_MAX_GROUP) + 1), key=lambda g: (fill(g), -g))


def tower_plan(b: int, s: int, sm_count: int, *, k: int = 512, heads: int = 8,
               m: int = 2048, layers: int = 12):
    """The work items of one tower call in walk order.  An item is one stage
    of one layer for one group of whole sequences, a tuple of
    TOWER_FIELDS:

    * ln1, ln2: xn = rawLN(residual) of rows row0 .. row0 + rows - 1 of the
      group (TOWER_LN_ROWS at most);
    * qkv, out, mlp_in, mlp_out: rows row0 .. row0 + 127 of the group's
      flat rows (``rows`` of them real) by bn columns from col0 (bn: 64
      or 128 for the whole call, 128 once every product stage has an item
      for every SM) of the stage's product, over ``kn`` rows of its
      contraction from part * kn; where a stage has fewer items than half
      the SMs (B = 1: the out-projection and the MLP out) its tiles split
      the contraction into ``parts`` items each (a power of two, at most
      TOWER_MAX_PARTS): each part writes its
      fp32 sums to a scratch block (``poff``: the tile's first, part p at
      poff + p * 128 * bn floats) and adds one to the tile's counter
      (``tile``, an index into the counters); the last part to arrive adds
      the parts in order and runs the epilogue, so the sums do not depend
      on the arrival order;
    * attn: one sequence (rows row0 .. row0 + S - 1) and head col0.

    Every item waits for counter ``wait`` to reach ``target`` (-1: none)
    and adds one to ``signal`` when done; counter (g, l, stage) is
    (g * layers + l) * 7 + stage, the tiles' counters follow.  Items go
    layer by layer, stage by stage, group by group, so each one's
    dependency comes earlier in the walk.  -> (items, n_counters, grid,
    n_partial floats); the kernel's grid is min(items, sm_count): block i
    takes items i, i + grid, ..."""
    hd = heads * HEAD_DIM
    g = tower_group(b, s)
    groups = [(first, min(g, b - first)) for first in range(0, b, g)]
    tiles = [-(-n * s // TOWER_ROWS) for _, n in groups]
    width = {"qkv": 3 * hd, "out": k, "mlp_in": m, "mlp_out": k}
    depth = {"qkv": k, "out": hd, "mlp_in": k, "mlp_out": m}
    # one tile width for the whole call (the kernel is built for each):
    # 128 columns once every product stage has an item for every SM, else
    # 64 (B = 1: each product's columns spread over more SMs)
    wide = all(sum(tiles) * (n // 128) >= sm_count for n in width.values())
    bn = dict.fromkeys(width, 128 if wide else 64)
    parts = {}
    for op, n in width.items():
        items_, p = sum(tiles) * (n // bn[op]), 1
        while (2 * p <= TOWER_MAX_PARTS[op] and 2 * items_ * p <= sm_count
               and 2 * items_ < sm_count and depth[op] % (2 * p * 128) == 0):
            p *= 2
        parts[op] = p
    n_ops = len(TOWER_OPS)
    n_stage = len(groups) * layers * n_ops
    # each split stage's tiles: a counter each and their parts' fp32 blocks
    tile0, poff0, n_tiles, n_partial = {}, {}, 0, 0
    for op, n in width.items():
        if parts[op] > 1:
            tile0[op], poff0[op] = n_tiles, n_partial
            n_tiles += sum(tiles) * (n // bn[op])
            n_partial += sum(tiles) * (n // bn[op]) * parts[op] * TOWER_ROWS * bn[op]

    def count(gi, op):
        if op == "attn":
            return groups[gi][1] * heads
        if op in ("ln1", "ln2"):
            return -(-groups[gi][1] * s // TOWER_LN_ROWS)
        return tiles[gi] * (width[op] // bn[op]) * parts[op]

    def counter(gi, l, st):
        return (gi * layers + l) * n_ops + st

    items = []
    for l in range(layers):
        for st, op in enumerate(TOWER_OPS):
            code = st
            for gi, (first, n) in enumerate(groups):
                if st > 0:
                    wait, target = counter(gi, l, st - 1), count(gi, TOWER_OPS[st - 1])
                elif l > 0:
                    wait, target = counter(gi, l - 1, n_ops - 1), count(gi, "mlp_out")
                else:
                    wait, target = -1, 0
                sig = counter(gi, l, st)
                end = (first + n) * s
                if op == "attn":
                    items += [(code, l, (first + q) * s, s, h, 0, wait, target, sig,
                               0, 1, 0, 0, 0) for q in range(n) for h in range(heads)]
                elif op in ("ln1", "ln2"):
                    items += [(code, l, r0, min(TOWER_LN_ROWS, end - r0), 0, 0, wait,
                               target, sig, 0, 1, 0, 0, 0)
                              for r0 in range(first * s, end, TOWER_LN_ROWS)]
                else:
                    cols = width[op] // bn[op]
                    kn = depth[op] // parts[op]
                    for t in range(tiles[gi]):
                        r0 = first * s + t * TOWER_ROWS
                        for ci in range(cols):
                            tile = sum(tiles[:gi]) * cols + t * cols + ci
                            split = parts[op] > 1
                            cnt = n_stage + tile0[op] + tile if split else 0
                            poff = (poff0[op] + tile * parts[op] * TOWER_ROWS * bn[op]
                                    if split else 0)
                            items += [(code, l, r0, min(TOWER_ROWS, end - r0), ci * bn[op],
                                       bn[op], wait, target, sig, kn, parts[op], p, poff, cnt)
                                      for p in range(parts[op])]
    return items, n_stage + n_tiles, min(len(items), sm_count), n_partial


_PLANS = {}
_COUNTERS = {}


def _device_plan(b, s, k, heads, m, layers, dev):
    """tower_plan's table on the card, cached per shape and device ->
    (table [n_items, 14] int32, n_items, n_counters, grid, n_partial, bn)."""
    key = (b, s, k, heads, m, layers, dev)
    if key not in _PLANS:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        items, n_counters, grid, n_partial = tower_plan(b, s, sms, k=k, heads=heads, m=m,
                                                        layers=layers)
        table = torch.tensor(items, dtype=torch.int32, device=dev)
        bn = items[-1][TOWER_FIELDS.index("bn")]     # the last item is an MLP out
        _PLANS[key] = (table, len(items), n_counters, grid, n_partial, bn)
    return _PLANS[key]


def _counters(n, dev):
    """At least n + 1 zero int32 counters on ``dev``, kept across calls:
    every launch leaves them zero (its last block resets them), and calls
    on one stream run in turn."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n + 1:
        buf = _COUNTERS[dev] = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    return buf


def text_tower(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, *, heads: int,
               eps: float = 1e-5):
    """x [B,S,K] bf16 through the L stacked layers -> [B,S,K]."""
    if x.device.type == "cpu":
        return text_tower_plain(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2,
                                heads=heads, eps=eps)
    b, s, k = x.shape
    layers, m = w1.shape[0], w1.shape[2]
    hd = heads * HEAD_DIM
    check_head_dim(w_eff.shape[-1], heads, "text_tower kernel")
    _build.check_dims(K=k, M=m)
    if layers < 1:
        raise ValueError("text_tower needs at least one layer")
    bf16, f32, dev = torch.bfloat16, torch.float32, x.device
    for name, t, dtype, shape in (
            ("x", x, bf16, (b, s, k)),
            ("w_eff", w_eff, bf16, (layers, k, 3 * hd)),
            ("b_eff", b_eff, f32, (layers, 3 * hd)),
            ("wo", wo, bf16, (layers, hd, k)),
            ("bo", bo, f32, (layers, k)),
            ("w1", w1, bf16, (layers, k, m)),
            ("b1", b1, f32, (layers, m)),
            ("w2", w2, bf16, (layers, m, k)),
            ("b2", b2, f32, (layers, k))):
        _build.check_tensor(name, t, dtype, shape, dev)
    fused = text_tower_fused(s, k, heads)
    with torch.cuda.device(dev):
        attn = torch.empty((b * s, hd), dtype=bf16, device=dev)
        hidden = torch.empty((b * s, m), dtype=bf16, device=dev)
        out = torch.empty_like(x)
        xn = torch.empty_like(x)
        if fused:
            table, n_items, n_counters, grid, n_partial, bn = _device_plan(
                b, s, k, heads, m, layers, dev)
            counters = _counters(n_counters, dev)
            partial = torch.empty(max(n_partial, 1), dtype=f32, device=dev)
            mid = None
            qkv = torch.empty((b * s, 3 * hd), dtype=bf16, device=dev)
        else:
            table = counters = partial = None
            n_items = n_counters = grid = bn = 0
            mid = torch.empty_like(x)
            qkv = qkv_scratch(b, s, hd, dev)
        _build.launch("uml_text_tower", *map(_build.ptr, (
            x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, xn, qkv, attn, hidden,
            mid, out, table, counters, partial)), b, s, k, heads, m, layers, n_items,
            n_counters, grid, bn, eps, torch.cuda.current_stream(dev).cuda_stream)
    text_tower.launches += 1
    if not fused:
        count_attention(s, layers)
    return out


text_tower.launches = 0


def supports_text_tower(k: int, heads: int, head_dim: int, s: int,
                        m: int) -> bool:
    """What the tower's kernels take: head dim 64, K and M multiples of the
    64-wide GEMM tiles; any S (the attention streams K/V)."""
    return head_dim == HEAD_DIM and k % 64 == 0 and m % 64 == 0


class TextTowerFn(torch.autograd.Function):
    """text_tower with a gradient to x and every stacked weight."""

    @staticmethod
    def forward(ctx, x, w_eff, b_eff, wo, bo, w1, b1, w2, b2, heads, eps):
        ctx.cfg = (heads, eps)
        ctx.save_for_backward(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2)
        return text_tower(x, w_eff, b_eff, wo, bo, w1, b1, w2, b2,
                          heads=heads, eps=eps)

    @staticmethod
    def backward(ctx, g):
        heads, eps = ctx.cfg
        return (*plain_vjp(
            lambda *a: text_tower_plain(*a, heads=heads, eps=eps),
            ctx.saved_tensors, (g,), ctx.needs_input_grad[:9]), None, None)
