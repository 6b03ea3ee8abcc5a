"""Training loop for the Gaussian shared-autoencoder UML experiment.

The port of uml_tpu/train/gaussian.py (behavioural parity with
Gaussian_experiment/main.py:31-86):
  * per step: batch -> loss = alpha_x*loss_x + alpha_y*loss_y  (mode 'xy')
              or loss = loss_x with loss_y computed for logging (mode 'x')
  * Adam (optax.adam's formulas: betas 0.9 / 0.999, eps 1e-8 added to the
    bias-corrected root)
  * every EVAL_EVERY steps: val recon losses + CKA + mutual-kNN on the
    shared-encoder embeddings of the full val set

The X/Y pools and the val set live on the device; each chunk's [chunk, bs]
index arrays go up once, every step gathers its batch there, steps and
evaluates, and its metrics land in a preallocated [chunk, n_metrics]
device tensor read once per chunk: no per-step host round trip, as
uml_tpu's ``lax.scan`` gives.  On the card the step, with its eval, is
two CUDA graphs around Adam's eager step (``_GraphedStep``): launched
one by one, the step's many small kernels cost more host time than the
card spends on them.  In mode 'x' loss_y is computed outside
the graph: the y heads get no gradient and keep their initial values
(optax's zero update does the same).  Products run in fp32 with TF32 off.
The loop calls no hand-written kernel: uml_tpu's is plain jnp.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.data.gaussian import UnpairedIndexStream
from uml_tpu_torch.metrics.alignment import cka as cka_fn
from uml_tpu_torch.metrics.alignment import mutual_knn as mknn_fn
from uml_tpu_torch.models.shared_autoencoder import SharedAutoencoder

EVAL_EVERY = 1  # parity: Gaussian_experiment/main.py:29
MKNN_TOPK = 10

TRAIN_KEYS = ("train/loss", "train/loss_x", "train/loss_y")
VAL_KEYS = ("val/loss_x", "val/loss_y", "val/loss")
ALIGN_KEYS = ("val/cka", "val/mknn")


@dataclass
class GaussianTrainResult:
    params: Any                      # the trained state_dict, on the CPU
    history: dict[str, np.ndarray]   # per-step logged scalars
    final_val_loss_x: float
    final_val_loss_y: float
    final_cka: float
    final_mknn: float


def make_model(dim_obs: int, dim_common: int, dim_latent: int) -> SharedAutoencoder:
    return SharedAutoencoder(dim_obs=dim_obs, dim_common=dim_common, dim_latent=dim_latent)


GRAPH_WARMUP = 3   # eager steps on the card before the step is captured


class _GraphedStep:
    """A step on the card as two CUDA graphs around the optimizer's eager
    step: ``grads(ix, iy)`` (the batch's forward and backward -> its
    losses) and ``evaluate(losses)`` (the eval -> the step's metrics row).
    torch.optim.Adam stays eager: its capturable form computes the bias
    corrections in fp32 on the card, which moves the trajectory away from
    optax's (1.8e-3 in CKA over 200 steps at the paper's setting, on the
    CPU); eager, it is a few multi-tensor launches a step.

    The first GRAPH_WARMUP calls run eagerly on a side stream (Adam's
    state and the libraries' workspaces are made there, as a capture
    needs); the next call captures both graphs, and from then on each
    call copies its indices into the graphs' static inputs and replays
    them.  The row a replay returns is overwritten by the next call: copy
    it before."""

    def __init__(self, grads, optimizer, evaluate):
        self.grads, self.optimizer, self.evaluate = grads, optimizer, evaluate
        self.calls, self.graphs = 0, None
        self.ix = self.iy = self.out = None

    def _eager(self):
        losses = self.grads(self.ix, self.iy)
        self.optimizer.step()
        return self.evaluate(losses)

    def __call__(self, ix, iy):
        if self.ix is None:
            self.ix, self.iy = torch.empty_like(ix), torch.empty_like(iy)
        self.ix.copy_(ix)
        self.iy.copy_(iy)
        self.calls += 1
        if self.calls <= GRAPH_WARMUP:
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                out = self._eager()
            main.wait_stream(side)
            out.record_stream(main)
            return out
        if self.graphs is None:
            self.graphs = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graphs[0]):
                losses = self.grads(self.ix, self.iy)
            with torch.cuda.graph(self.graphs[1]):
                self.out = self.evaluate(losses)
        self.graphs[0].replay()
        self.optimizer.step()
        self.graphs[1].replay()
        return self.out


@contextlib.contextmanager
def _fp32_products():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def train_gaussian(
    model: SharedAutoencoder,
    pools: dict,              # {'x': [Nx, dim_obs], 'y': [Ny, dim_obs]}
    val_x,
    val_y,
    *,
    mode: str = "xy",
    alpha_x: float = 1.0,
    alpha_y: float = 1.0,
    lr: float = 1e-3,
    batch_size: int = 512,
    num_steps: int = 1000,
    seed: int = 0,
    loader_seed: int = 42,    # parity: main.py:141-143 generator seed
    chunk: int = 100,
    eval_metrics: bool = True,
    logger=None,
    stream=None,              # override the index stream (a parity harness
                              # replaying the reference's batches)
    init_params=None,         # a state_dict to start from (converted weights)
    device=None,
    check_finite: bool = False,
) -> GaussianTrainResult:
    """Train ``model`` in place on ``device`` (default: the card).
    ``check_finite``: raise at the first step whose loss is not finite
    (checked when its chunk's metrics are read)."""
    if mode not in ("xy", "x"):
        raise ValueError(f"mode must be 'xy' or 'x', got {mode!r}")
    device = torch.device(device) if device is not None else default_device()
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.init_random(torch.Generator().manual_seed(seed))
    model.to(device)
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)

    pool_x, pool_y = put(pools["x"]), put(pools["y"])
    val_x, val_y = put(val_x), put(val_y)
    names = TRAIN_KEYS + VAL_KEYS + (ALIGN_KEYS if eval_metrics else ())
    # the logged order is uml_tpu's: its scan returns the dict sorted
    keys = tuple(sorted(names))
    order = [names.index(k) for k in keys]

    def grads(ix, iy):
        """The batch's forward and backward -> (loss, loss_x, loss_y)."""
        xb, yb = pool_x[ix], pool_y[iy]
        optimizer.zero_grad()
        if mode == "xy":
            loss_x, loss_y, _, _ = model(x=xb, y=yb)
            loss = alpha_x * loss_x + alpha_y * loss_y
        else:
            loss_x = loss = model(x=xb)[0]
            with torch.no_grad():
                loss_y = model(y=yb)[1]
        loss.backward()
        return loss.detach(), loss_x.detach(), loss_y.detach()

    @torch.no_grad()
    def evaluate(losses):
        """The eval after the step -> the step's metrics row."""
        vx, vy, _, _ = model(x=val_x, y=val_y)
        row = [*losses, vx, vy, vx + vy]
        if eval_metrics:
            emb_x, emb_y = model.get_embeddings(x=val_x, y=val_y)
            row += [cka_fn(emb_x, emb_y, "ip"), mknn_fn(emb_x, emb_y, MKNN_TOPK)]
        return torch.stack([row[i].float() for i in order])

    def step(ix, iy):
        losses = grads(ix, iy)
        optimizer.step()
        return evaluate(losses)

    if stream is None:
        stream = UnpairedIndexStream(
            pool_x.shape[0], pool_y.shape[0], batch_size, seed=loader_seed)

    run = (_GraphedStep(grads, optimizer, evaluate) if device.type == "cuda"
           else step)
    history: dict[str, list] = {k: [] for k in keys}
    done = 0
    with _fp32_products():
        for idx_x, idx_y in stream.batch_chunks(num_steps, chunk):
            idx_x = torch.as_tensor(np.asarray(idx_x, np.int64)).to(device)
            idx_y = torch.as_tensor(np.asarray(idx_y, np.int64)).to(device)
            metrics = torch.empty(len(idx_x), len(keys), device=device)
            for s in range(len(idx_x)):
                metrics[s] = run(idx_x[s], idx_y[s])
            metrics = metrics.cpu().numpy()
            loss = metrics[:, keys.index("train/loss")]
            if check_finite and not np.isfinite(loss).all():
                bad = int(np.argmin(np.isfinite(loss)))
                raise FloatingPointError(
                    f"non-finite loss {loss[bad]} at step {done + bad} "
                    "(--debug_nans)")
            done += len(metrics)
            for j, k in enumerate(keys):
                history[k].append(metrics[:, j])
            if logger is not None:
                for row in metrics:
                    logger.log({k: float(v) for k, v in zip(keys, row)})

    hist = {k: np.concatenate(v) for k, v in history.items()}
    nan = float("nan")
    return GaussianTrainResult(
        params={k: v.detach().cpu().clone() for k, v in model.state_dict().items()},
        history=hist,
        final_val_loss_x=float(hist["val/loss_x"][-1]),
        final_val_loss_y=float(hist["val/loss_y"][-1]),
        final_cka=float(hist["val/cka"][-1]) if eval_metrics else nan,
        final_mknn=float(hist["val/mknn"][-1]) if eval_metrics else nan,
    )
