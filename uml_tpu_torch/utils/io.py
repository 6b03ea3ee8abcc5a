"""Filesystem / logging helpers.

Capability parity with the reference's shared utilities
(engine/tools/utils.py:13-104): JSON/pickle IO, directory creation,
hidden-file-free listing, and a stdout Tee used to mirror logs into
``log.txt`` per experiment.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import pickle
import warnings
from typing import Any


class Tee:
    """Fan out writes to several streams (stdout + logfile).

    Mirrors the behavior of engine/tools/utils.py:13-23 so experiment
    entry points can redirect stdout into a per-run ``log.txt``.
    """

    def __init__(self, *streams):
        self.streams = streams

    def write(self, data) -> None:
        for s in self.streams:
            s.write(data)

    def flush(self) -> None:
        for s in self.streams:
            s.flush()

    def isatty(self) -> bool:  # pragma: no cover - cosmetic
        return False


def makedirs(path: str | None) -> None:
    if path and not osp.exists(path):
        os.makedirs(path, exist_ok=True)


def check_isfile(fpath: str) -> bool:
    isfile = osp.isfile(fpath)
    if not isfile:
        warnings.warn(f'No file found at "{fpath}"')
    return isfile


def load_json(fpath: str) -> Any:
    with open(fpath, "r") as f:
        return json.load(f)


def save_as_json(obj: Any, fpath: str) -> None:
    makedirs(osp.dirname(fpath))
    with open(fpath, "w") as f:
        # indent=4 + sorted separators match the reference's output format so
        # generated few-shot index files are byte-comparable.
        json.dump(obj, f, indent=4, separators=(",", ": "))


def load_pickle(fpath: str) -> Any:
    with open(fpath, "rb") as f:
        return pickle.load(f)


def save_pickle(obj: Any, fpath: str) -> None:
    makedirs(osp.dirname(fpath))
    with open(fpath, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def listdir_nohidden(path: str, sort: bool = True) -> list[str]:
    items = [f for f in os.listdir(path) if not f.startswith(".")]
    if sort:
        items.sort()
    return items
