"""The UML train step and feature extraction, worked out plainly.

``train_steps`` follows the program's first steps from the same state
dict, head weights, batches and optimizer settings: the zero-shot head
from the text rows' class means, the image and text logits through the
shared head, the weighted cross-entropies mixed by ``img_alpha`` and
``alpha``, autograd's gradient, and AdamW (decoupled decay, bias
corrections) at the learning rate of the warmup-then-cosine schedule.
The image rows run in blocks of ``row_block`` rows, their gradients
summed, so the reference's memory stays that of one block.

It returns, per unit (a leaf, or rows of a packed leaf; ``units``), the
first step's gradient norm and the norm of the change after all the
steps; and each step's loss.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F



def zero_shot_head(text_feats, text_labels, classes: int):
    """Columns = L2-normalised class means of the text rows -> [D, C]."""
    feats = torch.as_tensor(np.asarray(text_feats, np.float32))
    labels = torch.as_tensor(np.asarray(text_labels, np.int64))
    sums = torch.zeros(classes, feats.shape[1]).index_add_(0, labels, feats)
    counts = torch.bincount(labels, minlength=classes).clamp(min=1).float()
    means = sums / counts[:, None]
    means = means / (means.norm(dim=1, keepdim=True) + 1e-12)
    return means.t().contiguous()


def learning_rate(step: int, opt: dict) -> float:
    """Linear warmup from ``warmup_min_lr`` at step 0, then cosine."""
    lr, warmup = opt["lr"], opt["warmup_iter"]
    if step < warmup:
        return opt["warmup_min_lr"] if step == 0 else lr * step / warmup
    return lr * 0.5 * (1 + math.cos(math.pi * (step - warmup) / opt["max_iter"]))


def _logits(tower, cfg, leaves, head, images, mm):
    feats = tower(leaves, images, cfg, mm)
    if "img_proj_w" in head:
        feats = mm(feats, leaves["img_proj_w"])
    return mm(feats, leaves["head_w"]) * head["scale"]


def features(tower, cfg, sd, images, mm, row_block: int = 64):
    """Image features [B, E] of ``tower`` (a family's plain forward,
    ``reference/<family>.py``) in blocks of rows."""
    with torch.no_grad():
        return torch.cat([tower(sd, images[i:i + row_block], cfg, mm)
                          for i in range(0, images.shape[0], row_block)])


def unit_norms(tensors: dict, units: dict) -> dict:
    """{unit: norm}: ``units`` gives a leaf's units as [(unit, part,
    parts)], the part-th of ``parts`` equal blocks of its rows; a leaf
    it does not name is one unit of its own name."""
    out = {}
    for leaf, t in tensors.items():
        for unit, part, parts in units.get(leaf, [(leaf, 0, 1)]):
            n = t.shape[0] // parts if t.dim() else 0
            out[unit] = float((t if parts == 1 else t[part * n:(part + 1) * n]).norm())
    return out


def train_steps(tower, cfg, sd, head, batches, opt, alpha, img_alpha, mm,
                units: dict, row_block: int = 64, rows=None):
    """-> {"losses": [...], "grad_norms": {unit: norm}, "change_norms":
    {unit: norm}} after len(batches) steps.  ``tower``: the family's
    plain forward; ``head``: {"head_w",
    optional "img_proj_w", "scale"}; ``batches``: (images u8, image
    labels, text rows, text labels) on the device.  ``rows`` (a fault to
    read, never the reference itself): the count of leading image rows
    whose mean is taken as the batch's."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in sd.items()}
    for k in ("head_w", "img_proj_w"):
        if k in head:
            leaves[k] = head[k].detach().clone().requires_grad_(True)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, opt["weight_decay"]
    losses, grads = [], {}
    for t, (images, img_labels, txt, txt_labels) in enumerate(batches):
        for p in leaves.values():
            p.grad = None
        n = images.shape[0] if rows is None else rows
        total = 0.0
        for i in range(0, n, row_block):
            j = min(i + row_block, n)
            logits = _logits(tower, cfg, leaves, head, images[i:j], mm)
            loss = img_alpha * F.cross_entropy(logits, img_labels[i:j],
                                               reduction="sum") / n
            loss.backward()
            total += float(loss.detach())
        txt_logits = mm(txt.float(), leaves["head_w"]) * head["scale"]
        loss = alpha * F.cross_entropy(txt_logits, txt_labels)
        loss.backward()
        losses.append(total + float(loss.detach()))
        lr = learning_rate(t, opt)
        with torch.no_grad():
            for k, p in leaves.items():
                if p.grad is None:
                    continue
                g = p.grad
                if t == 0:
                    grads[k] = g.clone()
                p.mul_(1 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** (t + 1))).add_(eps)
                p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** (t + 1)))
    changes = {k: leaves[k].detach() - start[k] for k in grads}
    return {"losses": losses, "grad_norms": unit_norms(grads, units),
            "change_norms": unit_norms(changes, units)}
