"""Supervised UML training: alternating image/text batches into a shared head.

The port of uml_tpu/train/supervised.py (behavioural parity with the
reference's finetune.py:120-315):

  * per iteration one image batch AND one text-feature batch (independent
    cyclic shuffled streams), forward through the shared head, loss =
    img_alpha * CE_img + alpha * CE_txt, one optimizer step;
  * per-iteration diagnostics: the head-weight gradient of each modality
    in closed form (softmax(logits) - onehot contracted with the
    features, with the PRE-step scales), their cosine / sign agreement /
    norms, the feature-direction similarity with weighted means, and the
    CKA / mutual-kNN of a fixed capture set (with the post-step head);
  * every ``eval_freq`` iterations: validation, a best-state snapshot,
    early stopping with ``patience``;
  * returns {'iter', 'val_acc', 'val_loss', 'model', ...} like uml_tpu.

Batches keep uml_tpu's fixed shapes: a ragged final batch is padded with
zero sample weights, and every loss and metric is weighted.  Snapshots
are detached CPU clones (``UMLHead.state_tree``): the optimizer updates
the parameters in place.  A trainable RN tower runs BatchNorm in its
train form, and its running statistics are written after each optimizer
step (``bn_updates`` and ``UMLHead.merge_bn_updates``).

Mid-run checkpoints (``checkpointer``, a core.checkpoint.TrainCheckpointer,
and ``ckpt_every``; uml_tpu/train/supervised.py:297-340, 386-395): after
the eval of every ``ckpt_every``-th iteration the loop saves the model's
parameters and buffers (BatchNorm's running statistics among them), the
optimizer's state, the next iteration (the learning-rate schedule is a
function of it), the best snapshot with its accuracy, loss and iteration,
and the early-stopping count.  A run that finds a checkpoint restores it
and fast-forwards both batch streams (``.skip()``, without touching the
skipped batches), so the resumed run takes the batches an uninterrupted
one would.

Data parallelism (``mesh``, core.meshes.create_mesh; uml_tpu/train/
supervised.py:130-148, 172-181, 311-313, 342-350): every rank draws the
same global batches from the same seeded streams and keeps its own rows
of each (the whole batch where it does not divide by the data axis).
The losses divide by the global batch's weight sum and sum their
numerators over the ranks, a trainable RN tower's BatchNorm takes the
global batch's statistics, and the gradients are averaged over the ranks
(parallel/data_parallel.py), so the step is the global batch's step.
The logged metrics sum their parts over the ranks in one collective;
``validate`` splits the eval batches the same way and sums the loss,
``correct`` and ``total``.  The model starts from rank 0's weights, and
every decision (the best snapshot, early stopping) is taken from values
every rank holds.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

from uml_tpu_torch.core.meshes import replicate
from uml_tpu_torch.core.prng import epoch_perm, host_rng
from uml_tpu_torch.metrics.alignment import cka as cka_fn
from uml_tpu_torch.metrics.alignment import mutual_knn as mknn_fn
from uml_tpu_torch.models.clip import ClipResNetModel
from uml_tpu_torch.parallel.data_parallel import (
    all_sum,
    global_batch,
    shard_for,
    sync_gradients,
)
from uml_tpu_torch.utils.profiling import span

EVAL_FREQ = 100  # parity: finetune.py:30


class CyclicBatcher:
    """Shuffled epoch batches over aligned arrays, cycling forever.

    DataLoader(shuffle=True, drop_last=False) semantics: each epoch is a
    fresh permutation from ``core.prng.host_rng(seed)`` (the same
    stream as uml_tpu's); the final partial batch is padded to
    batch_size with zero weights.  Yields (inputs, labels, weights).
    """

    def __init__(self, inputs: np.ndarray, labels: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.inputs = inputs
        self.labels = labels
        self.batch_size = batch_size
        self.rng = host_rng(seed)

    def __iter__(self) -> Iterator:
        return self._iterate(0)

    def skip(self, n_batches: int) -> Iterator:
        """An iterator aligned with batch ``n_batches`` without gathering
        the skipped batches (one permutation draw per skipped epoch)."""
        return self._iterate(n_batches)

    def _iterate(self, skip_batches: int) -> Iterator:
        n = len(self.inputs)
        bs = self.batch_size
        bpe = (n + bs - 1) // bs
        while skip_batches >= bpe:
            epoch_perm(self.rng, n)
            skip_batches -= bpe
        while True:
            perm = epoch_perm(self.rng, n)
            for i in range(skip_batches * bs, n, bs):
                idx = perm[i : i + bs]
                pad = bs - len(idx)
                weights = np.ones(bs, np.float32)
                if pad:
                    weights[len(idx):] = 0.0
                    idx = np.concatenate([idx, np.zeros(pad, idx.dtype)])
                yield self.inputs[idx], self.labels[idx], weights
            skip_batches = 0


def eval_batches(inputs, labels, batch_size):
    """Fixed-shape padded batches over a split: full batches are views,
    only the final partial batch is padded into a copy."""
    out = []
    n = len(inputs)
    for i in range(0, n, batch_size):
        stop = min(i + batch_size, n)
        weights = np.ones(batch_size, np.float32)
        if stop - i == batch_size:
            out.append((inputs[i:stop], labels[i:stop], weights))
            continue
        pad = batch_size - (stop - i)
        weights[stop - i:] = 0.0
        x = np.concatenate([inputs[i:stop], np.zeros(
            (pad, *np.shape(inputs)[1:]), np.asarray(inputs).dtype)])
        y = np.concatenate([labels[i:stop], np.zeros(pad, np.asarray(labels).dtype)])
        out.append((x, y, weights))
    return out


def weighted_ce(logits, labels, weights):
    """Sample-weighted mean cross-entropy (padded rows weigh 0)."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    return torch.sum(ce * weights) / torch.clamp(weights.sum(), min=1.0)


def _to_device(batch, device):
    """numpy (inputs, labels, weights) -> tensors on ``device``; labels
    int64, weights fp32, inputs keep their dtype (uint8 images, float
    features)."""
    inputs, labels, weights = batch
    return (torch.as_tensor(np.ascontiguousarray(inputs)).to(device),
            torch.as_tensor(np.asarray(labels, np.int64)).to(device),
            torch.as_tensor(np.asarray(weights, np.float32)).to(device))


def _rows(shard, batch):
    return batch if shard is None else shard.rows(batch)


def make_validate(model, mesh=None):
    """-> validate(params, batches) -> (mean batch loss, weighted accuracy)
    over fixed-shape ``eval_batches``.

    ``params`` is a state tree to load first (``None``: the model's
    current parameters).  Runs under ``torch.no_grad()``, so a backbone
    takes its inference kernels.  With a ``mesh`` each rank runs its rows
    of every batch, and the batches' loss sums, ``correct`` and ``total``
    are summed over the ranks in one collective."""

    def validate(params, batches):
        if params is not None:
            model.load_state_tree(params)
        device = model.head_w.device
        parts, split = [], []
        with torch.no_grad():
            for batch in batches:
                shard = shard_for(mesh, len(batch[2]))
                inputs, labels, weights = _to_device(_rows(shard, batch), device)
                logits, _ = model(inputs)
                ce = F.cross_entropy(logits, labels, reduction="none")
                parts.append(torch.stack([
                    torch.sum(ce * weights),
                    ((logits.argmax(-1) == labels) * weights).sum(),
                    weights.sum()]))
                split.append(shard is not None and shard.split)
        if not parts:
            return float(np.mean([])), 0.0
        # one collective for the split batches' parts, one read for all
        summed = iter(all_sum([p for p, s in zip(parts, split) if s], mesh))
        rows = torch.stack([next(summed) if s else p for p, s in zip(parts, split)])
        losses = (rows[:, 0] / torch.clamp(rows[:, 2], min=1.0)).tolist()
        correct = sum(rows[:, 1].tolist())
        total = sum(rows[:, 2].tolist())
        return float(np.mean(losses)), correct / max(total, 1.0)

    return validate


def _weighted_loss(logits, labels, weights, denom, shard):
    """``weighted_ce`` of the global batch: this rank's weighted CE sum,
    summed over the ranks where the batch is split, over the global
    batch's clamped weight sum ``denom``."""
    ce = F.cross_entropy(logits, labels, reduction="none")
    num = torch.sum(ce * weights)
    return (num if shard is None else shard.sum(num)) / denom


def _modality_sums(logits, labels, weights, feats):
    """This rank's parts of a modality's metrics: the weighted correct
    count, the closed-form head-weight gradient's sum (feats * w)^T
    (softmax - onehot) and the weighted feature sum."""
    p = torch.softmax(logits, -1)
    onehot = F.one_hot(labels, logits.shape[-1]).float()
    grad = (feats * weights[:, None]).T @ (p - onehot)
    correct = ((logits.argmax(-1) == labels) * weights).sum()
    return [correct, grad, (feats * weights[:, None]).sum(0)]


def _cos(a, b):
    return torch.dot(a, b) / (torch.linalg.norm(a) * torch.linalg.norm(b) + 1e-12)


def make_train_step(model, optimizer, *, has_image, has_text, alpha=1.0,
                    img_alpha=1.0, capture=None, mesh=None):
    """-> step(i, img_b, txt_b) -> (loss, metrics): one optimizer step of
    ``train`` on the host batches (inputs, labels, weights) of each
    modality (None for a missing one).  Binds ``optimizer`` (a
    train.optim.Optimizer spec) to the parameters that require a
    gradient.  With a ``mesh`` the step takes this rank's rows and is the
    global batch's step (module docstring)."""
    device = model.head_w.device
    trainable = [p for p in model.parameters() if p.requires_grad]
    optimizer.init(trainable)
    # a trainable RN tower runs BatchNorm in its train form
    train_bn = (has_image and not model.freeze_backbone
                and isinstance(model.backbone, ClipResNetModel))
    n_class = model.num_classes
    if capture is not None:
        cap_img = torch.as_tensor(np.asarray(capture["image_feats"])).to(device)
        cap_txt = torch.as_tensor(np.asarray(capture["text_feats"])).to(device)
        cap_lab = torch.as_tensor(np.asarray(capture["image_labels"],
                                             np.int64)).to(device)

    def place(batch):
        """-> (shard, this rank's rows on the device, the global batch's
        clamped weight sum)."""
        shard = shard_for(mesh, len(batch[2]))
        rows = _to_device(_rows(shard, batch), device)
        weights = (rows[2] if shard is None or not shard.split
                   else torch.as_tensor(np.asarray(batch[2], np.float32)).to(device))
        return shard, rows, torch.clamp(weights.sum(), min=1.0)

    def reduced(shard, parts):
        return all_sum(parts, mesh) if shard is not None and shard.split else parts

    def step(i, img_b, txt_b):
        with span("uml.step"):
            return _step(i, img_b, txt_b)

    def _step(i, img_b, txt_b):
        with span("uml.step.optimizer"):
            optimizer.zero_grad()
        img_scale, txt_scale = model.scales()
        zero = torch.zeros((), device=device)
        image_loss = text_loss = zero
        if has_image:
            with span("uml.step.place"):
                img_shard, (img_in, img_labels, img_w), img_den = place(img_b)
            with span("uml.step.forward"):
                bn_updates = [] if train_bn else None
                with global_batch(img_shard):
                    img_feats = model.image_features(img_in, bn_updates)
                img_logits = img_feats @ model.head_w * img_scale
                image_loss = _weighted_loss(img_logits, img_labels, img_w, img_den,
                                            img_shard)
        if has_text:
            with span("uml.step.place"):
                txt_shard, (txt_feats, txt_labels, txt_w), txt_den = place(txt_b)
            with span("uml.step.forward"):
                txt_feats = txt_feats.float()
                txt_logits = txt_feats @ model.head_w * txt_scale
                text_loss = _weighted_loss(txt_logits, txt_labels, txt_w, txt_den,
                                           txt_shard)
        loss = img_alpha * image_loss + alpha * text_loss
        with span("uml.step.backward"):
            loss.backward()
            sync_gradients(trainable, mesh)
        # the diagnostics use the PRE-step scales, like the reference's
        # autograd.grad before optimizer.step (finetune.py:190-195)
        img_scale, txt_scale = img_scale.detach().clone(), txt_scale.detach().clone()
        with span("uml.step.optimizer"):
            optimizer.step(i)
            if train_bn:
                # BatchNorm's running statistics follow momentum, not
                # gradients: written after the optimizer step
                model.merge_bn_updates(bn_updates)

        metrics = {"train/image_loss": image_loss.detach(),
                   "train/text_loss": text_loss.detach()}
        with span("uml.step.metrics"), torch.no_grad():
            if has_image:
                img_feats, img_logits = img_feats.detach(), img_logits.detach()
                correct, grad_img, img_sum = reduced(img_shard, _modality_sums(
                    img_logits, img_labels, img_w, img_feats))
                grad_img = grad_img * img_scale / img_den
                metrics["train/image_acc"] = correct / img_den
                metrics["train/img_grad_norm"] = torch.linalg.norm(grad_img)
            if has_text:
                txt_logits = txt_logits.detach()
                correct, grad_txt, txt_sum = reduced(txt_shard, _modality_sums(
                    txt_logits, txt_labels, txt_w, txt_feats))
                grad_txt = grad_txt * txt_scale / txt_den
                metrics["train/text_acc"] = correct / txt_den
                metrics["train/txt_grad_norm"] = torch.linalg.norm(grad_txt)
            if has_image and has_text:
                gi, gt = grad_img.ravel(), grad_txt.ravel()
                metrics["train/grad_direction_sim"] = _cos(gi, gt)
                metrics["train/grad_agreement_rate"] = (
                    torch.sign(gi) == torch.sign(gt)).float().mean()
                # weighted means: padded rows of a ragged final batch must
                # not enter the reference's batch mean (finetune.py:239)
                metrics["train/feature_direction_sim"] = _cos(
                    img_sum / img_den, txt_sum / txt_den)
            if capture is not None:
                # finetune.py:209-233: alignment of a fixed capture set
                # under the post-step head; cka takes class-mean image
                # features against text samples
                cap_feats = model.image_features(cap_img)
                n_common = min(cap_img.shape[0], cap_txt.shape[0])
                topk = min(10, n_common - 1)
                if topk >= 1:
                    metrics["train/mknn_score"] = mknn_fn(
                        cap_feats[:n_common], cap_txt[:n_common], topk)
                sums = torch.zeros(n_class, cap_feats.shape[1], device=device)
                sums.index_add_(0, cap_lab, cap_feats)
                counts = torch.zeros(n_class, device=device)
                counts.index_add_(0, cap_lab, torch.ones_like(cap_lab, dtype=torch.float32))
                class_means = sums / torch.clamp(counts[:, None], min=1.0)
                n_common = min(n_class, cap_txt.shape[0])
                metrics["train/cka_score"] = cka_fn(
                    class_means[:n_common], cap_txt[:n_common], "ip")
        return loss.detach(), metrics

    return step


def train(
    model,
    image_stream,            # iterable of (inputs, labels, weights) or None
    text_stream,             # iterable of (feats, labels, weights) or None
    val_batches,
    test_batches=None,
    *,
    optimizer,
    max_iters: int = 1000,
    alpha: float = 1.0,
    img_alpha: float = 1.0,
    eval_freq: int = EVAL_FREQ,
    patience: int = 5,
    capture: dict | None = None,   # {'image_feats', 'text_feats', 'image_labels'}
    logger=None,
    validate_fn=None,
    init_params: dict | None = None,
    checkpointer=None,             # core.checkpoint.TrainCheckpointer
    ckpt_every: int | None = None,
    mesh=None,                     # core.meshes.create_mesh(): data parallel
):
    """Train ``model`` (a UMLHead) in place; see the module docstring.
    ``optimizer`` is a train.optim.Optimizer spec, bound here to the
    parameters that require a gradient."""
    if image_stream is None and text_stream is None:
        raise ValueError("train needs an image stream, a text stream or both")
    if init_params is not None:
        model.load_state_tree(init_params)
    replicate(mesh, model)
    has_image = image_stream is not None
    has_text = text_stream is not None
    step = make_train_step(model, optimizer, has_image=has_image,
                           has_text=has_text, alpha=alpha, img_alpha=img_alpha,
                           capture=capture, mesh=mesh)
    validate = validate_fn or make_validate(model, mesh)
    image_iter = iter(image_stream) if has_image else None
    text_iter = iter(text_stream) if has_text else None

    out = {"iter": None, "val_acc": None, "model": None, "val_loss": None,
           "model_records": []}
    no_improve = 0
    stopped_at = max_iters

    start_iter = 0
    if checkpointer is not None:
        _, state = checkpointer.restore_latest()
        if state is not None:
            print(f"=> Resuming from checkpoint at iter {state['iter']}")
            model.load_state_dict(state["model"])
            optimizer.torch_optimizer.load_state_dict(state["optimizer"])
            start_iter = int(state["iter"])
            no_improve = int(state["no_improve"])
            if state["best_iter"] >= 0:
                out.update(iter=int(state["best_iter"]),
                           val_acc=float(state["best_val_acc"]),
                           val_loss=float(state["best_val_loss"]),
                           model=state["best_params"])
            if has_image:
                image_iter = image_stream.skip(start_iter)
            if has_text:
                text_iter = text_stream.skip(start_iter)

    def save_ckpt(i):
        if not (checkpointer is not None and ckpt_every
                and (i + 1) % ckpt_every == 0):
            return
        checkpointer.save(i + 1, {
            "model": model.state_dict(),
            "optimizer": optimizer.torch_optimizer.state_dict(),
            "iter": i + 1, "best_params": out["model"],
            "best_val_acc": out["val_acc"] if out["val_acc"] is not None else -1.0,
            "best_val_loss": out["val_loss"] if out["val_loss"] is not None else 0.0,
            "best_iter": out["iter"] if out["iter"] is not None else -1,
            "no_improve": no_improve,
        })

    for i in range(start_iter, max_iters):
        img_b = next(image_iter) if has_image else None
        txt_b = next(text_iter) if has_text else None
        loss, metrics = step(i, img_b, txt_b)

        if logger is not None:
            logger.log({k: float(v) for k, v in metrics.items()})

        if i % eval_freq == 0:
            snapshot = model.state_tree()
            val_loss, val_acc = validate(None, val_batches)
            testlog = ""
            if test_batches is not None:
                _, test_acc = validate(None, test_batches)
                testlog = f" | Test Acc: {test_acc:.4f}"
            if out["val_acc"] is None or val_acc > out["val_acc"]:
                out.update(iter=i, val_acc=val_acc, val_loss=val_loss,
                           model=snapshot)
                no_improve = 0
            else:
                no_improve += 1
            if logger is not None:
                logger.log({"val/val_loss": val_loss, "val/val_acc": val_acc,
                            "iter": i})
            print(f"Iter {i} | Loss {float(loss):.4f} | Val Loss {val_loss:.4f}"
                  f" | Val Acc {val_acc:.4f}{testlog}"
                  f" | Count {no_improve}/{patience}")
            if no_improve >= patience:
                print(f"=> Early stopping at Iter {i}")
                stopped_at = i
                break
        # after the eval, so the checkpoint carries this iteration's best
        # snapshot and early-stopping count (a resume skips that eval)
        save_ckpt(i)

    if out["model"] is None:
        out["model"] = model.state_tree()
    val_loss, val_acc = validate(out["model"], val_batches)
    if logger is not None:
        logger.log({"val/best_val_loss": val_loss, "val/best_val_acc": val_acc,
                    "iter": out["iter"]})
    print(f"=> Best Val Loss {val_loss:.4f}, Val Acc {val_acc:.4f} "
          f"at Iter {out['iter']}")
    out["final_params"] = out["model"]
    out["stopped_at"] = stopped_at
    return out
