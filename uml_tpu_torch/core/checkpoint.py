"""Mid-run checkpoint and resume (the port of uml_tpu/core/checkpoint.py).

uml_tpu hands the train loop's whole state (parameters, optimizer state,
iteration, best-so-far) to an orbax CheckpointManager every
``ckpt_every`` iterations, and a restarted run resumes from the latest
step.  Here the state is a tree of plain tensors, numbers, strings and
dicts / lists, written with ``torch.save`` and read with
``torch.load(weights_only=True)``: one file per step, ``step_<n>.pt``,
written to a temporary name and renamed, so a run killed mid-write never
leaves a half-written latest step.  The newest ``MAX_TO_KEEP`` steps are
kept.  A run without checkpoints passes no checkpointer (None).

Under data parallelism (``mesh``) rank 0 alone writes, then every rank
waits for the write; every rank restores the step rank 0 found, so all of
them resume from one state.
"""

from __future__ import annotations

import os
import re

import torch

from uml_tpu_torch.core.distributed import is_primary
from uml_tpu_torch.core.meshes import agree, barrier

MAX_TO_KEEP = 2
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class TrainCheckpointer:
    """Save / restore a state tree by step number in ``directory``."""

    def __init__(self, directory: str, mesh=None):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                                   os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def save(self, step: int, state) -> None:
        if is_primary():
            path = self._path(step)
            tmp = f"{path}.tmp.{os.getpid()}"
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self._steps()[:-MAX_TO_KEEP]:
                os.remove(self._path(old))
        barrier(self.mesh)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self):
        """-> (step, state) or (None, None)."""
        step = agree(self.mesh, self.latest_step())
        if step is None:
            return None, None
        return step, torch.load(self._path(step), map_location="cpu",
                                weights_only=True)
