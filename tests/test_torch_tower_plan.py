"""The work items of the one-launch text tower (row 4), on the CPU.

``ops/text_tower.py::tower_plan`` lays out the table that
``csrc/text_tower.cu``'s persistent kernel walks: each item one stage
(ln1, qkv, attn, out, ln2, mlp_in, mlp_out) of one layer for one group of whole
sequences, with the counter it waits for and the one it signals.  These
tests hold the table to what the kernel's correctness and its freedom
from deadlock rest on, at B in {1, 2, 7, 64, 200} and S in {77, 128}:

* every (sequence, layer, stage, column slice) is covered exactly once
  (every row of every LN and product, every (sequence, head) of the
  attention);
* a product's rows never leave their group, and a group holds whole
  sequences;
* every item's dependency is complete before it in the walk: each counter
  it waits for is signalled by exactly ``target`` items, all earlier;
* a simulated walk of the kernel's grid (block i takes items i, i + grid,
  ... in order, an item runs once its counter reached its target) ends;
* the route, the limits and the table's fields match the C source; and
  the wrapper hands the C entry one argument per SIGNATURES entry with
  the plan's item count and grid (a recorder in place of the C call).
"""

import contextlib
import os
import re
import types
from collections import Counter

import pytest
import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops import text_tower as tt

SMS = 132
SHAPES = [(b, s) for b in (1, 2, 7, 64, 200) for s in (77, 128)]


def _plan(b, s, layers=12, k=512, heads=8, m=2048):
    items, n_counters, grid, _ = tt.tower_plan(b, s, SMS, k=k, heads=heads, m=m,
                                               layers=layers)
    return [dict(zip(tt.TOWER_FIELDS, it)) for it in items], n_counters, grid


@pytest.mark.parametrize("b,s", SHAPES)
def test_every_row_column_and_head_is_covered_once(b, s):
    k, heads, m, layers = 512, 8, 2048, 12
    items, _, _ = _plan(b, s, layers, k, heads, m)
    op = {name: code for code, name in enumerate(tt.TOWER_OPS)}
    width = {op["qkv"]: 3 * heads * 64, op["out"]: k, op["mlp_in"]: m, op["mlp_out"]: k}
    depth = {op["qkv"]: k, op["out"]: heads * 64, op["mlp_in"]: k, op["mlp_out"]: m}
    heads_seen = Counter()
    spans = {}      # (layer, op, 64-column block, part) -> row intervals
    for it in items:
        if it["op"] == op["attn"]:
            assert it["row0"] % s == 0 and it["rows"] == s
            heads_seen[(it["row0"] // s, it["layer"], it["col0"])] += 1
            continue
        if it["op"] in (op["ln1"], op["ln2"]):
            assert 0 < it["rows"] <= tt.TOWER_LN_ROWS
            spans.setdefault((it["layer"], it["op"], 0, 0), []).append(
                (it["row0"], it["row0"] + it["rows"]))
            continue
        assert it["bn"] in (64, 128) and it["col0"] % it["bn"] == 0
        assert 0 < it["rows"] <= tt.TOWER_ROWS
        assert it["col0"] + it["bn"] <= width[it["op"]]
        # the contraction of a tile split in parts: every part once
        assert it["kn"] * it["parts"] == depth[it["op"]] and 0 <= it["part"] < it["parts"]
        assert it["kn"] % 128 == 0 or it["parts"] == 1
        assert it["parts"] == 1 or it["bn"] == 64    # the 128-wide kernel takes no split
        for c in range(it["col0"], it["col0"] + it["bn"], 64):
            spans.setdefault((it["layer"], it["op"], c, it["part"]), []).append(
                (it["row0"], it["row0"] + it["rows"]))
    assert heads_seen == Counter({(seq, l, h): 1 for seq in range(b)
                                  for l in range(layers) for h in range(heads)})
    parts = {it["op"]: it["parts"] for it in items if it["op"] in width}
    assert set(spans) == {(l, o, c, p) for l in range(layers) for o, n in width.items()
                          for c in range(0, n, 64) for p in range(parts[o])} | {
        (l, op[name], 0, 0) for l in range(layers) for name in ("ln1", "ln2")}
    for key, rows in spans.items():
        rows.sort()
        end = 0
        for r0, r1 in rows:      # back to back, no gap, no overlap
            assert r0 == end, key
            end = r1
        assert end == b * s, key


@pytest.mark.parametrize("b,s", SHAPES)
def test_product_tiles_stay_inside_whole_sequence_groups(b, s):
    g = tt.tower_group(b, s)
    assert 1 <= g <= min(b, tt.TOWER_MAX_GROUP)
    items, _, _ = _plan(b, s)
    for it in items:
        if tt.TOWER_OPS[it["op"]] == "attn":
            continue
        first_seq = it["row0"] // s
        group = first_seq // g
        end = min(b, (group + 1) * g) * s
        assert it["row0"] + it["rows"] <= end
        step = tt.TOWER_LN_ROWS if tt.TOWER_OPS[it["op"]] in ("ln1", "ln2") else tt.TOWER_ROWS
        assert (it["row0"] - group * g * s) % step == 0


@pytest.mark.parametrize("b,s", SHAPES)
def test_every_dependency_comes_earlier_in_the_walk(b, s):
    items, n_counters, grid = _plan(b, s)
    assert grid == min(len(items), SMS)
    signals = Counter(it["signal"] for it in items)
    n_stage = -(-b // tt.tower_group(b, s)) * 12 * len(tt.TOWER_OPS)
    assert set(signals) == set(range(n_stage))      # the split tiles' counters follow
    assert n_stage <= n_counters
    done = Counter()
    for it in items:
        if it["wait"] >= 0:
            assert done[it["wait"]] == signals[it["wait"]] == it["target"]
        else:
            assert it["layer"] == 0 and it["op"] == 0
        done[it["signal"]] += 1
    # each stage waits for the one before it, of its own group and layer
    # (ln1: the mlp_out of the layer before)
    n_ops = len(tt.TOWER_OPS)
    for it in items:
        if it["wait"] < 0:
            continue
        g, rest = divmod(it["wait"], 12 * n_ops)
        l, st = divmod(rest, n_ops)
        g2, rest2 = divmod(it["signal"], 12 * n_ops)
        l2, st2 = divmod(rest2, n_ops)
        assert g == g2 and (l, st) == ((l2, st2 - 1) if st2 > 0 else (l2 - 1, n_ops - 1))


@pytest.mark.parametrize("b,s", [(1, 77), (2, 128), (7, 77), (64, 77)])
def test_the_grid_walk_ends(b, s):
    """The kernel's walk, simulated: each block takes its items in order;
    one whose counter has not reached its target waits."""
    items, _, grid = _plan(b, s, layers=3)
    queues = [list(range(i, len(items), grid)) for i in range(grid)]
    heads = [0] * grid
    count = Counter()
    left = len(items)
    while left:
        moved = False
        for blk in range(grid):
            if heads[blk] == len(queues[blk]):
                continue
            it = items[queues[blk][heads[blk]]]
            if it["wait"] >= 0 and count[it["wait"]] < it["target"]:
                continue
            count[it["signal"]] += 1
            heads[blk] += 1
            left -= 1
            moved = True
        assert moved, "deadlock"


def test_groups_fill_the_row_tiles():
    assert tt.tower_group(64, 77) == 8      # 616 rows in 640
    assert tt.tower_group(1, 77) == 1
    assert tt.tower_group(7, 77) == 3       # 231 rows in 256
    assert tt.tower_group(64, 128) == 1     # every tile full
    products = {tt.TOWER_OPS.index(op) for op in ("qkv", "out", "mlp_in", "mlp_out")}
    for b, bn in ((1, 64), (64, 128)):
        items, _, _ = _plan(b, 77)
        assert {it["bn"] for it in items if it["op"] in products} == {bn}
        assert items[-1]["bn"] == bn       # the wrapper reads the call's bn there


def _c_source():
    with open(os.path.join(_build.CSRC, "text_tower.cu")) as f:
        return f.read()


def test_route_limits_and_fields_match_the_c_source():
    src = _c_source()
    assert int(re.search(r"TT_MAX_S = (\d+)", src).group(1)) == tt.TOWER_MAX_S
    assert int(re.search(r"TT_MAX_K = (\d+)", src).group(1)) == tt.TOWER_MAX_K
    assert int(re.search(r"TT_BM = (\d+)", src).group(1)) == tt.TOWER_ROWS
    assert int(re.search(r"TT_FIELDS = (\d+)", src).group(1)) == len(tt.TOWER_FIELDS)
    fields = re.search(r"enum \{ TT_OP = 0, ([^}]*)\}", src).group(1)
    names = ["op"] + [f.strip().lower()[3:] for f in fields.split(",")]
    assert names == list(tt.TOWER_FIELDS)
    ops = re.search(r"enum \{ (OP_LN1 = 0, [^}]*)\}", src).group(1)
    assert [o.split("=")[0].strip().lower()[3:] for o in ops.split(",")] == list(tt.TOWER_OPS)
    assert int(re.search(r"TT_LN_ROWS = (\d+)", src).group(1)) == tt.TOWER_LN_ROWS
    assert tt.text_tower_fused(77, 512, 8)          # ViT-B text: one launch
    assert not tt.text_tower_fused(77, 768, 12)     # ViT-L/14 text: the chain
    assert not tt.text_tower_fused(129, 512, 8)
    assert tt.text_tower_fused(128, 128, 2)


@pytest.fixture
def recorder(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
    monkeypatch.setattr(tt, "_PLANS", {})
    monkeypatch.setattr(tt, "_COUNTERS", {})
    return calls


@pytest.mark.parametrize("b,s,k,heads", [(1, 77, 512, 8), (3, 77, 128, 2),
                                         (2, 129, 128, 2), (2, 77, 768, 12)])
def test_the_wrapper_passes_the_plan_on_its_route(recorder, b, s, k, heads):
    layers, m = 2, 4 * k
    hd = heads * 64

    def meta(*shape, dtype=torch.bfloat16):
        return torch.empty(*shape, dtype=dtype, device="meta")

    f32 = torch.float32
    tt.text_tower(meta(b, s, k), meta(layers, k, 3 * hd), meta(layers, 3 * hd, dtype=f32),
                  meta(layers, hd, k), meta(layers, k, dtype=f32), meta(layers, k, m),
                  meta(layers, m, dtype=f32), meta(layers, m, k), meta(layers, k, dtype=f32),
                  heads=heads)
    (name, args), = recorder
    assert name == "uml_text_tower" and len(args) == len(_build.SIGNATURES[name])
    n_items, n_counters, grid, bn = args[24:28]
    assert args[18:24] == (b, s, k, heads, m, layers)
    if tt.text_tower_fused(s, k, heads):
        items, want_counters, want_grid, _ = tt.tower_plan(b, s, SMS, k=k, heads=heads,
                                                           m=m, layers=layers)
        assert (n_items, n_counters, grid) == (len(items), want_counters, want_grid)
        assert bn == items[-1][tt.TOWER_FIELDS.index("bn")]
        assert args[13] is None      # no mid
    else:
        assert (n_items, n_counters, grid, bn) == (0, 0, 0, 0)
        assert args[15] is None and args[16] is None and args[17] is None  # no plan


@pytest.mark.parametrize("b,s", [(1, 77), (2, 77), (7, 77), (64, 77)])
def test_split_tiles_have_their_own_counters_and_blocks(b, s):
    """A stage with fewer items than half the SMs splits its tiles'
    contraction (B = 1: every product stage); each split tile has one
    counter after the stage counters and one fp32 block per part, apart
    from every other tile's."""
    items_, n_counters, _, n_partial = tt.tower_plan(b, s, SMS)
    items = [dict(zip(tt.TOWER_FIELDS, it)) for it in items_]
    n_stage = -(-b // tt.tower_group(b, s)) * 12 * len(tt.TOWER_OPS)
    split = [it for it in items if it["parts"] > 1]
    if b == 1:
        assert {tt.TOWER_OPS[it["op"]] for it in split} == {"out", "mlp_out"}
    if b == 64:
        assert not split and n_partial == 0 and n_counters == n_stage
    blocks = {}
    for it in split:
        assert n_stage <= it["tile"] < n_counters
        size = tt.TOWER_ROWS * it["bn"]
        blocks.setdefault((it["op"], it["tile"]), set()).add(
            (it["poff"], it["part"], it["parts"], size, it["layer"] * 0 + it["col0"]))
    spans = []
    for (op_, tile), v in blocks.items():
        (poff, _, parts, size, _), = {(p, 0, n, sz, c) for p, _, n, sz, c in v}
        assert {part for _, part, _, _, _ in v} == set(range(parts))
        spans.append((poff, poff + parts * size))
    spans.sort()
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0                      # no two tiles share floats
    assert not spans or spans[-1][1] <= n_partial
    assert len({tile for _, tile in blocks}) == len(blocks)
