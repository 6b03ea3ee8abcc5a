"""Tiny configurations and cells of the real families, for the CPU tests:
the program runs its plain PyTorch paths there."""

from __future__ import annotations

import copy

from port_bench import harness


def clip_cfg() -> dict:
    cfg = harness.config("clip_vit_b16")
    cfg.update(image_resolution=32, vision_width=64, vision_layers=2, vision_heads=1,
               mlp_width=256, embed_dim=32, context_length=8, vocab_size=50,
               transformer_width=64, transformer_heads=1, transformer_layers=1)
    cfg["assumed"] = {**cfg["assumed"], "text_feature_width": 32}
    return cfg


def dino_cfg() -> dict:
    cfg = harness.config("dinov2_vit_b14")
    cfg.update(image_size=28, hidden_size=64, num_hidden_layers=2, num_attention_heads=1)
    cfg["assumed"] = {**cfg["assumed"], "text_feature_width": 48}
    return cfg


def text_cfg() -> dict:
    """Mistral-7B's schema at hidden 64, 2 layers, 4 heads over 2 kv heads."""
    cfg = harness.config("mistral_7b")
    cfg.update(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=100)
    return cfg


def cell(name: str) -> dict:
    """The cell's file at batch 8, 10 classes, a pool of 4 (batches or
    classes), its limits."""
    wl = copy.deepcopy(harness.workload(name))
    wl.update(batch=8, text_batch=8, pool_batches=4, pool_classes=4, classes=10)
    return wl
