"""The numbers that decide ``correct``, and their limits.

Train cells compare three numbers of the program's first steps with the
plain reference's (reference/uml.py), unit by unit: a unit is a leaf of
the reference's state dict, and the query, key and value rows of a
packed projection are units of their own (families/<family>.py maps the
program's leaves onto them):

* ``loss_gap``: the widest relative gap of a step's loss, and
  ``loss1_gap`` that of the first step alone;
* ``grad_gap``: the widest gap between the program's first gradient
  norm, read from its AdamW state after one step (exp_avg / (1 - beta1)),
  and the reference's, over max(the reference's norm of that unit, the
  median unit's norm); ``grad_gap_median``: the median unit's gap;
* ``change_gap`` and ``change_gap_median``: the same for the norm of each
  unit's change after the steps.

A cell's file names the numbers it compares, each with its limit;
PERF.md gives the readings each limit was set from.

Units whose reference gradient is under a thousandth of the median
unit's are left out of both (the key projection's bias, on which
softmax's shift leaves no gradient): under AdamW round-off alone moves
them.  Units the reference's loss does not reach (the CLIP text tower
and ``logit_scale``, which the full-model finetune hands to adamw as the
program does) have no reference gradient and fall under that rule.

The extraction cells' numbers, over a sample of the fetched batches (or
calls): ``feature_nmse``, the mean over the sample's rows (images or
texts) of the normalised squared error ||f - r||^2 / ||r||^2, and
``feature_gap``, the widest relative L2 gap ||f - r|| / ||r|| of one row.
"""

from __future__ import annotations

import statistics

import numpy as np

EXCLUDE_BELOW = 1e-3


def _unit_gaps(prog: dict, ref: dict, units) -> dict:
    scale = statistics.median(ref[k] for k in units)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], scale) for k in units}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``, ``ref``: {"losses", "grad_norms", "change_norms"}, the
    norms by unit."""
    ref_grad, ref_change = ref["grad_norms"], ref["change_norms"]
    median = statistics.median(ref_grad.values())
    kept = [k for k, g in ref_grad.items() if g >= EXCLUDE_BELOW * median]
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grad = _unit_gaps(prog["grad_norms"], ref_grad, kept)
    change = _unit_gaps(prog["change_norms"], ref_change, kept)
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad_gap": max(grad.values()), "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values()),
            "change_gap_median": statistics.median(change.values()),
            "units_compared": len(kept),
            "units_left_out": len(prog["grad_norms"]) - len(kept),
            "worst_grad_unit": max(grad, key=grad.get),
            "worst_change_unit": max(change, key=change.get)}


def feature_numbers(prog, ref) -> dict:
    """``prog``, ``ref``: float32 [N, E] features of the same images."""
    gap = (prog - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30)
    return {"feature_gap": float(gap.max()), "feature_nmse": float((gap * gap).mean()),
            "feature_gap_mean": float(gap.mean())}


def sample(seed: int, n: int, k: int) -> list:
    """The window's answers to compare, of ``n``: ``k`` drawn from the
    seed, the last always among them."""
    rng = np.random.default_rng(seed)
    pick = set(rng.choice(n, size=min(k, n), replace=False).tolist())
    pick.add(n - 1)
    return sorted(pick)


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """-> (every compared number within its limit, [(name, value,
    limit)]).  A limit not set yet fails the run."""
    rows = [(name, float(numbers[name]), limits.get(name)) for name in limits]
    ok = all(limit is not None and value == value and value <= limit
             for _, value, limit in rows)
    return ok, rows
