"""Optimizers + LR schedules with the reference semantics, in torch.

The port of uml_tpu/train/optim.py:
  * HYPER_DICT, the named sweep grids (engine/optimizer/default.py:1-61),
    copied and pinned to uml_tpu's by a test
  * adam/adamw/sgd (optim.py:15-72): adam betas (0.9, 0.999), eps 1e-8,
    sgd momentum 0.9 non-nesterov, torch-style coupled weight decay for
    adam/sgd, decoupled for adamw: torch's Adam/SGD ``weight_decay`` add
    wd * p to the gradient (optax's add_decayed_weights before the
    update), AdamW scales p by 1 - lr * wd (optax's adamw adds wd * p to
    the update)
  * cosine / linear schedules with constant / linear warmup
    (scheduler.py:11-143), a plain function of the step.

Two traps the port keeps: the warmup's step 0 is the ABSOLUTE
``warmup_min_lr``, not a factor of ``lr`` (so the learning rate is set in
``param_group["lr"]`` every step rather than through LambdaLR factors),
and optax counts the first update as step 0.
"""

from __future__ import annotations

import math

import torch

HYPER_DICT = {
    "full_ds_full_model_finetune": {
        "optim": "adamw",
        "lr": [5e-05],
        "weight_decay": [0.0, 0.01, 0.001],
        "lr_scheduler": "cosine",
        "batch_size": [64],
        "max_iter": [12800],
        "warmup_iter": 50,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [False],
        "patience": [10],
    },
    "clip_linear": {
        "optim": "adamw",
        "lr": [0.001, 0.0001],
        "weight_decay": [0.0, 0.01, 0.001],
        "lr_scheduler": "cosine",
        "batch_size": [32],
        "max_iter": [12800],
        "warmup_iter": 50,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [False],
        "patience": [5],
    },
    "linear": {
        "optim": "adamw",
        "lr": [0.001, 0.0001],
        "weight_decay": [0.0, 0.01, 0.001],
        "lr_scheduler": "cosine",
        "batch_size": [8, 32],
        "max_iter": [12800],
        "warmup_iter": 50,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [True],
        "patience": [10],
    },
    "audio": {
        "optim": "adamw",
        "lr": [0.1, 0.01, 0.001, 0.0001],
        "weight_decay": [0.0, 0.01, 0.0001],
        "lr_scheduler": "cosine",
        "batch_size": [8],
        "max_iter": [12800],
        "warmup_iter": 50,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [False],
        "patience": [5],
    },
    # fast full-finetune grid for smoke tests (same structure as
    # full_ds_full_model_finetune; tiny iteration budget)
    "smoke_full": {
        "optim": "adamw",
        "lr": [5e-05],
        "weight_decay": [0.0],
        "lr_scheduler": "cosine",
        "batch_size": [8],
        "max_iter": [30],
        "warmup_iter": 5,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [False],
        "patience": [3],
    },
    # fast grid for smoke tests / CI
    "smoke": {
        "optim": "adamw",
        "lr": [0.001],
        "weight_decay": [0.0],
        "lr_scheduler": "cosine",
        "batch_size": [8],
        "max_iter": [200],
        "warmup_iter": 10,
        "warmup_type": "linear",
        "warmup_min_lr": 1e-5,
        "dropout": [0.0],
        "learnable_temp": [False],
        "patience": [3],
    },
}


def build_schedule(lr, lr_scheduler, warmup_iter, max_iter,
                   warmup_type="linear", warmup_lr=1e-5):
    """step -> learning rate, matching the torch warmup wrappers:
    warmup step 0 is ``warmup_lr``, steps 1..warmup-1 are
    lr * step / warmup_iter (linear) or ``warmup_lr`` (constant); the
    cosine/linear schedule then starts at its own step 0."""
    if lr_scheduler == "cosine":
        def base(step):
            return lr * 0.5 * (1 + math.cos(math.pi * step / max_iter))
    elif lr_scheduler == "linear":
        def base(step):
            return lr * (1 - step / max_iter)
    else:
        raise ValueError(f"scheduler must be cosine|linear, got {lr_scheduler}")

    if warmup_iter <= 0:
        return base
    if warmup_type not in ("constant", "linear"):
        raise ValueError(f"warmup_type must be constant|linear, got {warmup_type}")

    def schedule(step):
        if step >= warmup_iter:
            return base(step - warmup_iter)
        if warmup_type == "constant" or step == 0:
            return warmup_lr
        return lr * step / warmup_iter

    return schedule


class Optimizer:
    """An optax-like optimizer spec: ``init(params)`` binds it to the
    parameters (a torch optimizer), ``step(it)`` sets the learning rate of
    update ``it`` (0 for the first) and applies the update."""

    def __init__(self, name: str, schedule, weight_decay: float):
        if name not in ("adam", "adamw", "sgd"):
            raise ValueError(f"Optimizer {name} not found; available = adam|sgd|adamw")
        self.name = name
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.torch_optimizer = None

    def init(self, params) -> "Optimizer":
        """Bind to ``params``.  Every parameter starts with a zero
        gradient: optax updates every leaf of the trainable tree, so a
        parameter the loss does not reach (the unused text tower of a
        full-model CLIP head) still takes adamw's decoupled decay, which
        torch would skip for a ``grad`` of None."""
        from uml_tpu_torch.parallel.tensor_parallel import split_sharded

        params = list(params)
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr, wd = float(self.schedule(0)), self.weight_decay
        # tensor-parallel parameters in a group of their own: the
        # multi-tensor kernels refuse a list that mixes DTensors and tensors
        groups = split_sharded(params)
        if self.name == "adamw":
            opt = torch.optim.AdamW(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=wd)
        elif self.name == "adam":
            opt = torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                   weight_decay=wd)
        else:
            opt = torch.optim.SGD(groups, lr=lr, momentum=0.9, nesterov=False,
                                  weight_decay=wd)
        self.torch_optimizer = opt
        return self

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=False)

    def step(self, it: int) -> None:
        for group in self.torch_optimizer.param_groups:
            group["lr"] = float(self.schedule(it))
        self.torch_optimizer.step()


def build_optimizer(name, schedule, weight_decay) -> Optimizer:
    """adam/adamw/sgd with the reference's decay semantics."""
    return Optimizer(name, schedule, weight_decay)
