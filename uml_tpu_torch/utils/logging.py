"""Pluggable experiment logging (the counterpart of uml_tpu.utils.logging;
framework-free, so the same code).

The reference hardcodes wandb (entity ``unpaired_multimodal``,
finetune.py:318-321, MultiBench/main.py:63, Gaussian main.py:33).  Here
wandb is optional: by default metrics stream to a local ``metrics.jsonl``
(no network needed), and ``UML_WANDB=1`` switches to wandb with the same
entity/project/tags contract.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class JsonlLogger:
    """Append-only metrics log, one JSON object per .log() call."""

    def __init__(self, path: str | None, config: dict | None = None):
        self._fh = None
        self._step = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
            if config is not None:
                self._write({"_config": _jsonable(config), "_t": time.time()})

    def _write(self, obj: dict) -> None:
        if self._fh is not None:
            self._fh.write(json.dumps(obj) + "\n")

    def log(self, metrics: dict[str, Any]) -> None:
        self._step += 1
        self._write({"_step": self._step, **_jsonable(metrics)})

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if hasattr(v, "item"):
            try:
                v = v.item()
            except Exception:
                v = str(v)
        elif not isinstance(v, (int, float, str, bool, type(None), list, dict)):
            v = str(v)
        out[k] = v
    return out


def init_logger(
    project: str,
    config: dict,
    tags: list[str] | None = None,
    entity: str = "unpaired_multimodal",
    logdir: str | None = None,
):
    """wandb if UML_WANDB=1 and importable, else a local jsonl logger."""
    if os.environ.get("UML_WANDB") == "1":
        try:
            import wandb

            return wandb.init(
                entity=entity, project=project, tags=tags or [], config=config
            )
        except Exception as e:  # pragma: no cover - needs wandb and a network
            print(f"=> wandb unavailable ({e}); falling back to jsonl logging")
    path = os.path.join(logdir, "metrics.jsonl") if logdir else None
    return JsonlLogger(path, config=config)
