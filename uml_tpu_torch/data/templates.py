"""Prompt template registry.

Capability parity with engine/templates/__init__.py:5-19.  The template
tables themselves (Tip-Adapter hand-crafted picks, the 180-template
ensemble pool, the per-dataset mined templates) are prompt *data*, stored as
JSON under uml_tpu/assets/templates/ (read by path) rather than python
constants.
"""

from __future__ import annotations

import functools
import json
import os

from uml_tpu_torch import ASSET_DIR

_ASSET_DIR = os.path.join(ASSET_DIR, "templates")

TEXT_AUGMENTATIONS = (
    "classname", "vanilla", "hand_crafted", "ensemble", "template_mining"
)


@functools.lru_cache()
def _load(name: str):
    with open(os.path.join(_ASSET_DIR, f"{name}.json")) as f:
        return json.load(f)


def get_templates(dataset_name: str, text_augmentation: str) -> list[str]:
    """List of '{}'-style format strings for the given dataset/augmentation."""
    if text_augmentation == "classname":
        return ["{}"]
    if text_augmentation == "vanilla":
        return ["a photo of a {}."]
    if text_augmentation == "hand_crafted":
        print(f"=> Producing hand-crafted templates for dataset: {dataset_name}")
        return _load("hand_crafted")[dataset_name]
    if text_augmentation == "ensemble":
        return _load("template_pool")
    if text_augmentation == "template_mining":
        return _load("template_mining")[dataset_name]
    raise ValueError(f"Unknown template: {text_augmentation}")
