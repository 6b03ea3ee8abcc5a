"""uml_tpu_torch — the PyTorch/CUDA port of uml_tpu for NVIDIA Hopper.

The JAX package ``uml_tpu`` is the reference; this package mirrors its
subpackage and module names so each module has an obvious counterpart:

core      flags, YAML sweeps, device choice
utils     IO and seeding helpers
data      benchmark registry, few-shot splits, templates, descriptors,
          transforms, the uint8 image loader, feature caches
native    the libjpeg decoder of the host pipeline (C++ built by g++ at
          first use, bound with ctypes)
ops       the hand-written Hopper kernels (``csrc/*.cu``) behind PyTorch
          wrappers, each beside its plain PyTorch version
models    CLIP ViT and RN50 / RN101 + text tower (OpenAI state_dict
          schema), DINO / DINOv2 ViT, tokenizer, encoder loading
cli       ``generate_fewshot``, ``features``, ``finetune``,
          ``collect_results``

Importing this package imports neither ``jax`` nor ``uml_tpu``; the BPE
vocab and the template / descriptor JSONs are read from ``uml_tpu/assets``
by file path.
"""

import os

__version__ = "0.1.0"

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "uml_tpu", "assets")
