"""Self-supervised UML training loop (MultiBench).

The port of uml_tpu/train/selfsup.py (behavioural parity with
MultiBench/train.py:296-537):
  * two independently-shuffled streams zipped -> unpaired (x, y) batches
  * ``step_k`` warm start: alpha_x = 0 while epoch <= step_k in 'xy' mode
  * loss = alpha_x * loss_x + alpha_y * loss_y (next-step reconstruction)
  * per-batch diagnostics: the copy-last-step baselines, the effective
    rank of the valid y predictions, diff_next, loss_private
  * every ``eval_freq`` batches: probe evaluation (logistic on the masked
    mean-pooled zx / zy / [zx, zy], the modality-separability classifier)
    and the alignment of a fixed capture set of ~1000 samples (CKA, mutual
    kNN, cosine on proj / embed), with its pooled embeddings kept
  * the raw-feature probe baselines computed once up front (train.py:31-91)
  * a final ``evaluate`` -> the returned score dict.

The trainer holds the ``SeqUML`` module and its Adam (optax.adam's
betas and eps).  optax updates every leaf each step with one step count,
torch's Adam skips a parameter whose ``grad`` is None, so every parameter
starts with a zero gradient and ``zero_grad`` keeps it (the x branch in
'y' mode, ``dec_x`` / ``xproj_in`` under the ``step_k`` warm start).
Dropout masks come from a ``torch.Generator`` on the model's device
seeded ``seed + 1`` (uml_tpu's dropout key); the weights are drawn on the
CPU from ``seed``, so every device starts from the same ones.  A step's
metrics reach the host in one transfer.

Epoch-level resume (``checkpointer``, core.checkpoint.TrainCheckpointer):
after every epoch the model, Adam's state, the dropout generator's state
and the next epoch are saved; a run that finds a checkpoint restores them
and replays the skipped epochs' shuffles, so it takes the batches and
dropout masks an uninterrupted run would.  (uml_tpu splits its dropout
key once per replayed batch; a generator's state depends on the masks
drawn, so it is saved instead.)
"""

from __future__ import annotations

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.core.meshes import replicate
from uml_tpu_torch.data.affect import map_labels
from uml_tpu_torch.data.seq_augment import augment_single
from uml_tpu_torch.metrics.alignment import cka as cka_fn
from uml_tpu_torch.metrics.alignment import compute_effective_rank
from uml_tpu_torch.metrics.alignment import mutual_knn as mknn_fn
from uml_tpu_torch.models.seq_autoencoder import SeqUML, length_mask
from uml_tpu_torch.parallel.data_parallel import (
    global_gather,
    global_sum,
    make_dp_train_step,
)
from uml_tpu_torch.train.probes import make_classifier, probe_scores

def _clip01(v):
    return float(min(max(float(v), 0.0), 1.0))


def masked_mean_pool(z, lengths):
    """[B, T, D] -> [B, D] over valid steps (train.py:118-126)."""
    mask = length_mask(lengths, z.shape[1])[..., None].to(z.dtype)
    return (z * mask).sum(dim=1) / mask.sum(dim=1)


def _trivial_loss(data, lengths):
    """The copy-last-step baseline (train.py:404-426)."""
    if data.shape[1] == 1:
        return torch.zeros((), device=data.device)
    diff = data[:, :-1, :] - data[:, 1:, :]
    m = length_mask(lengths, data.shape[1])[..., None].expand(data.shape).to(data.dtype)
    return (global_sum(torch.sum(diff ** 2 * m[:, :-1, :]))
            / (global_sum(torch.sum(m[:, :-1, :])) + 1e-8))


class SelfSupTrainer:
    """A ``SeqUML`` on ``device`` (default: the card) and its Adam."""

    def __init__(self, model: SeqUML, *, lr=1e-4, seed=0, device=None):
        self.model = model
        self.lr = lr
        self.seed = seed
        self.device = torch.device(device) if device is not None else default_device()
        self.optimizer = None

    def init(self) -> SeqUML:
        """flax's init distributions from a CPU generator seeded ``seed``,
        then the model on the device and Adam over every parameter, each
        with a zero gradient."""
        self.model.init_random(torch.Generator().manual_seed(self.seed))
        self.model.to(self.device)
        params = list(self.model.parameters())
        for p in params:
            p.grad = torch.zeros_like(p)
        self.optimizer = torch.optim.Adam(params, lr=self.lr, betas=(0.9, 0.999),
                                          eps=1e-8)
        return self.model

    def to_device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def forward_loss(self, x, y, lx, ly, alpha_x, alpha_y, generator, mode="xy"):
        """-> (loss, the model's output dict) under autograd."""
        out = self.model(x if "x" in mode else None, y if "y" in mode else None,
                         lx, ly, generator=generator)
        return alpha_x * out["loss_x"] + alpha_y * out["loss_y"], out

    @torch.no_grad()
    def step_metrics(self, loss, out, x, y, lx, ly, mode="xy"):
        """The step's diagnostics as 0-d tensors on the device (train.py:
        380-426): the effective rank over the VALID predicted y tokens
        (zeroed padding rows add no singular mass to the uncentered SVD,
        so masking equals the reference's boolean gather)."""
        metrics = {"train/loss": loss.detach(), "train/loss_x": out["loss_x"].detach(),
                   "train/loss_y": out["loss_y"].detach(),
                   "train/loss_private": out["loss_private"].detach()}
        if "x" in mode:
            metrics["train/trivial_loss_x"] = _trivial_loss(x, lx)
            metrics["train/diff_next_x"] = out["diff_next_x"].detach()
        if "y" in mode:
            metrics["train/trivial_loss_y"] = _trivial_loss(y, ly)
            metrics["train/diff_next_y"] = out["diff_next_y"].detach()
            m = length_mask(ly, y.shape[1])[..., None].expand(y.shape).to(y.dtype)
            recon = out["y_recon"].detach()[:, :-1, :]
            metrics["train/recon_y_loss"] = global_sum(torch.sum(
                (recon - y[:, 1:, :]) ** 2 * m[:, 1:, :])) / (
                    global_sum(torch.sum(m[:, 1:, :])) + 1e-8)
            pred_flat = global_gather(
                (recon * m[:, 1:, :]).reshape(-1, recon.shape[-1]))
            metrics["train/pred_effective_rank_y"] = compute_effective_rank(pred_flat)
        return metrics

    def train_step(self, x, y, lx, ly, alpha_x, alpha_y, generator, mode="xy",
                   mesh=None):
        """One Adam step on a global batch already on the device -> its
        metrics (0-d tensors of the global batch, before the update, as
        uml_tpu's).  With a ``mesh`` the forward takes this rank's rows
        and the gradients are averaged over the data axis
        (parallel.make_dp_train_step)."""

        def loss_fn(x, y, lx, ly):
            loss, out = self.forward_loss(x, y, lx, ly, alpha_x, alpha_y,
                                          generator, mode)
            return loss, self.step_metrics(loss, out, x, y, lx, ly, mode)

        step = make_dp_train_step(loss_fn, mesh, self.model.parameters(),
                                  self.optimizer)
        return step(x, y, lx, ly)[1]

    # -- embedding extraction ---------------------------------------------

    @torch.no_grad()
    def _embed_batch(self, x, y, lx, ly):
        out = self.model(x, y, lx, ly)
        return (masked_mean_pool(out["zx"], lx), masked_mean_pool(out["zy"], ly),
                out["loss_x"], out["loss_y"])

    def extract_embeddings(self, stream):
        """-> (zx, zy, loss_x per batch, loss_y per batch, labels) as numpy,
        read from the device once at the end."""
        zx, zy, lsx, lsy, labels = [], [], [], [], []
        for data, lengths, lab in stream:
            a, b, lossx, lossy = self._embed_batch(*self.to_device(
                data["x"], data["y"], lengths["x"], lengths["y"]))
            zx.append(a)
            zy.append(b)
            lsx.append(lossx)
            lsy.append(lossy)
            labels.append(np.asarray(lab))
        return (torch.cat(zx).cpu().numpy(), torch.cat(zy).cpu().numpy(),
                torch.stack(lsx).double().cpu().numpy(),
                torch.stack(lsy).double().cpu().numpy(), np.concatenate(labels))


def evaluate(trainer, eval_streams, ds_name, *, seed: int = 0):
    """Probe evaluation of ``trainer.model`` (uml_tpu passes the variables
    beside its trainer); parity with train.py:93-239.

    ``seed`` drives the modality-separability shuffle through an explicit
    generator so identical runs produce identical results.pth regardless of
    ambient global-RNG state.
    """
    rng = np.random.default_rng(seed)
    embds = {}
    for split, stream in eval_streams.items():
        zx, zy, loss_x, loss_y, labels = trainer.extract_embeddings(stream())
        embds[split] = {"x1": zx, "x2": zy,
                        "loss_x1": loss_x, "loss_x2": loss_y,
                        "labels": map_labels(labels, ds_name)}

    results = {}
    # modality separability (train.py:148-154)
    sep = []
    for split in ("train", "val", "test"):
        e = embds[split]
        X = np.concatenate([e["x1"], e["x2"]], axis=0)
        y = np.concatenate([np.zeros(len(e["x1"])), np.ones(len(e["x2"]))])
        perm = rng.permutation(len(X))
        clf = make_classifier("logistic", ds_name)
        clf.fit(X[perm], y[perm])
        sep.append(clf.score(X[perm], y[perm]))
    results["val/modality_separate"] = float(np.mean(sep))

    results["val/loss_x"] = float(np.mean(embds["val"]["loss_x1"]))
    results["test/loss_x"] = float(np.mean(embds["test"]["loss_x1"]))
    results["val/loss_y"] = float(np.mean(embds["val"]["loss_x2"]))
    results["test/loss_y"] = float(np.mean(embds["test"]["loss_x2"]))

    def scores(train_X, val_X, test_X):
        return probe_scores(
            train_X, embds["train"]["labels"], val_X, embds["val"]["labels"],
            test_X, embds["test"]["labels"], ds_name)

    v, t = scores(embds["train"]["x1"], embds["val"]["x1"], embds["test"]["x1"])
    results["val/score_x"], results["test/score_x"] = v, t
    v, t = scores(embds["train"]["x2"], embds["val"]["x2"], embds["test"]["x2"])
    results["val/score_y"], results["test/score_y"] = v, t
    v, t = scores(
        np.concatenate([embds["train"]["x1"], embds["train"]["x2"]], axis=1),
        np.concatenate([embds["val"]["x1"], embds["val"]["x2"]], axis=1),
        np.concatenate([embds["test"]["x1"], embds["test"]["x2"]], axis=1))
    results["val/score_xy"], results["test/score_xy"] = v, t
    return results


def evaluate_raw(eval_streams, ds_name):
    """Raw-feature probe baselines (train.py:31-91): mean over the padded
    time axis of each raw modality."""
    feats = {}
    for split, stream in eval_streams.items():
        xs, ys, labels = [], [], []
        for data, lengths, lab in stream():
            # the reference means over the BATCH-max padded length
            # (collate pads per batch, train.py:52-58); divide by the
            # batch's true max length rather than the split-max padding
            tx = max(int(np.max(lengths["x"])), 1)
            ty = max(int(np.max(lengths["y"])), 1)
            xs.append(np.asarray(data["x"]).sum(axis=1) / tx)
            ys.append(np.asarray(data["y"]).sum(axis=1) / ty)
            labels.append(np.asarray(lab))
        feats[split] = {"x": np.concatenate(xs), "y": np.concatenate(ys),
                        "labels": map_labels(np.concatenate(labels), ds_name)}

    def scores(key):
        if key == "xy":
            get = lambda s: np.concatenate([feats[s]["x"], feats[s]["y"]], axis=1)
        else:
            get = lambda s: feats[s][key]
        return probe_scores(get("train"), feats["train"]["labels"],
                            get("val"), feats["val"]["labels"],
                            get("test"), feats["test"]["labels"], ds_name)

    out = {}
    for key, name in (("x", "score_x_raw"), ("y", "score_y_raw"),
                      ("xy", "score_xy_raw")):
        v, t = scores(key)
        out[f"val/{name}"] = v
        out[f"test/{name}"] = t
    return out


@torch.no_grad()
def capture_alignment(model, x, y, lx, ly):
    """CKA, mutual kNN and cosine of the capture set's pooled proj / embed
    -> floats (one transfer)."""
    out = model(x, y, lx, ly)
    zx, zy = masked_mean_pool(out["zx"], lx), masked_mean_pool(out["zy"], ly)
    px, py = masked_mean_pool(out["x_proj"], lx), masked_mean_pool(out["y_proj"], ly)
    n = min(zx.shape[0], zy.shape[0])
    topk = min(10, n - 1)
    cos = torch.mean(torch.sum(zx[:n] * zy[:n], -1)
                     / (torch.linalg.vector_norm(zx[:n], dim=-1)
                        * torch.linalg.vector_norm(zy[:n], dim=-1) + 1e-12))
    align = {
        "val/cka_embed": cka_fn(zx[:n], zy[:n], "ip"),
        "val/mknn_embed": mknn_fn(zx[:n], zy[:n], topk),
        "val/cos_sim_embed": cos,
        "val/cka_proj": cka_fn(px[:n], py[:n], "ip"),
        "val/mknn_proj": mknn_fn(px[:n], py[:n], topk),
    }
    values = torch.stack(list(align.values())).tolist()
    return {k: _clip01(v) if "cka" in k else float(v) for k, v in zip(align, values)}


def train_selfsup(
    trainer: SelfSupTrainer,
    stream_1,                 # callable -> epoch iterator of (x,y,lx,ly,...)
    stream_2,
    eval_streams: dict,       # {'train','val','test'} -> callable -> iterator
    *,
    mode: str = "xy",
    num_epochs: int = 100,
    step_k: int = -1,
    alpha_x: float = 1.0,
    alpha_y: float = 1.0,
    ds_name: str = "mosi",
    eval_freq: int = 100,
    capture: bool = True,
    capture_samples: int = 1000,
    augment: bool = False,
    logger=None,
    checkpointer=None,            # core.checkpoint.TrainCheckpointer
    check_finite: bool = False,
    mesh=None,                    # core.meshes.create_mesh(): data parallel
):
    """-> (the trained model, the final score dict, the capture set's
    pooled-embedding history {'x1': [...], 'x2': [...]} or None).
    ``check_finite``: raise at the first step whose loss is not finite.

    With a ``mesh`` every rank draws the same batches, the train step
    splits them over the data axis (train_step), and the model starts
    from rank 0's weights; the evaluations run whole on every rank, so
    every decision is taken from values every rank holds.  Every rank's
    dropout generator has the same seed and draws the global batch's
    masks (models/seq_autoencoder.py::dropout), so a run with a mesh takes
    the masks of a run without one."""
    # uml_tpu peeks one batch of each stream for the init shapes; the peek
    # draws one shuffle of each, so it is kept: the epochs then draw the
    # same orders as uml_tpu's
    next(iter(stream_1()))
    next(iter(stream_2()))
    model = replicate(mesh, trainer.init())

    cap = None
    if capture:
        xs, ys, lxs, lys = [], [], [], []
        count = 0
        for (da, la, _), (db, lb, _) in zip(stream_1(), stream_2()):
            xs.append(da["x"]); lxs.append(la["x"])
            ys.append(db["y"]); lys.append(lb["y"])
            count += len(da["x"])
            if count >= capture_samples:
                break
        cap = dict(zip(("x", "y", "lx", "ly"), trainer.to_device(*(
            np.concatenate(v)[:capture_samples] for v in (xs, ys, lxs, lys)))))

    raw_results = evaluate_raw(eval_streams, ds_name)

    # GT effective rank of the y modality: constant, computed once from the
    # capture set's valid tokens (train.py:388, flattened_fixed_samples_x2)
    gt_eff_rank_y = None
    if cap is not None and "y" in mode:
        m = length_mask(cap["ly"], cap["y"].shape[1])[..., None].to(cap["y"].dtype)
        gt_flat = (cap["y"] * m).reshape(-1, cap["y"].shape[-1])
        gt_eff_rank_y = float(compute_effective_rank(gt_flat))

    rng = torch.Generator(device=trainer.device).manual_seed(trainer.seed + 1)
    score = None
    embeddings_history = {"x1": [], "x2": []} if capture else None

    # epoch-level resume (net-new vs the reference's end-of-run save)
    start_epoch = 0
    if checkpointer is not None:
        _, state = checkpointer.restore_latest()
        if state is not None:
            print(f"=> Resuming from checkpoint at epoch {state['epoch']}")
            model.load_state_dict(state["model"])
            trainer.optimizer.load_state_dict(state["optimizer"])
            rng.set_state(state["dropout_rng"])
            start_epoch = int(state["epoch"])
            # replay the skipped epochs' shuffles
            for _ in range(start_epoch):
                for _ in zip(stream_1(), stream_2()):
                    pass

    for epoch in range(start_epoch, num_epochs):
        ax = alpha_x
        if epoch <= step_k and mode == "xy":
            print(f"Training only on y, step: [{epoch}/{step_k}]; "
                  f"total steps: {num_epochs}")
            ax = 0.0
        for i_batch, ((da, la, _), (db, lb, _)) in enumerate(
                zip(stream_1(), stream_2())):
            x_in = da["x"]
            if augment:
                # --augment applies per-sequence views (the reference
                # accepts this flag but never uses it, train.py:296); the
                # rng is derived per (seed, epoch, batch) so resumed runs
                # replay identical augmentations
                aug_rng = np.random.RandomState(
                    (trainer.seed * 1_000_003 + epoch * 10_007 + i_batch) % (2**31))
                x_in = augment_single(x_in, aug_rng)
            batch = trainer.to_device(x_in, db["y"], la["x"], lb["y"])
            metrics = trainer.train_step(*batch, ax, alpha_y, rng, mode=mode,
                                         mesh=mesh)
            if logger is not None or check_finite:
                values = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
                if check_finite and not np.isfinite(values["train/loss"]):
                    raise FloatingPointError(
                        f"non-finite loss {values['train/loss']} at epoch {epoch}, "
                        f"batch {i_batch} (--debug_nans)")
                if logger is not None:
                    if gt_eff_rank_y is not None:
                        values["train/gt_effective_rank_y"] = gt_eff_rank_y
                    logger.log(values)

            if eval_streams and i_batch % eval_freq == 0:
                score = evaluate(trainer, eval_streams, ds_name, seed=trainer.seed)
                score.update(raw_results)
                if cap is not None:
                    score.update(capture_alignment(model, cap["x"], cap["y"],
                                                   cap["lx"], cap["ly"]))
                    # per-eval pooled capture embeddings (the reference's
                    # embeddings.pth history, main.py:151-152)
                    zx, zy, _, _ = trainer._embed_batch(cap["x"], cap["y"],
                                                        cap["lx"], cap["ly"])
                    embeddings_history["x1"].append(zx.cpu().numpy())
                    embeddings_history["x2"].append(zy.cpu().numpy())
                if logger is not None:
                    logger.log(score)

        if checkpointer is not None:
            checkpointer.save(epoch + 1, {
                "model": model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "dropout_rng": rng.get_state(), "epoch": epoch + 1})

    # the final evaluation runs after the loop, so a resume at
    # start_epoch >= num_epochs still reports the finished result
    if eval_streams:
        print("Final evaluation...")
        score = evaluate(trainer, eval_streams, ds_name, seed=trainer.seed)
        score.update(raw_results)
        if logger is not None:
            logger.log({f"final_{k}": v for k, v in score.items()})

    return model, score, embeddings_history
