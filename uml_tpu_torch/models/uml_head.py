"""UML heads: a shared linear classifier over image and text features.

The port of uml_tpu/models/uml_head.py (capability parity with the
reference's engine/models/head.py):

* ``UMLHead`` (head.py:39-98): optional bias-free ``img_proj_w``
  [feat_dim, text_dim] from the vision dim into the text dim, the shared
  bias-free head ``head_w`` [D, C], per-modality learnable scales
  (``img_scale``, ``txt_scale``) with ``learnable_temp``.
* UMLClip semantics (head.py:101-141) with ``logit_scale``: logits are
  scaled by the fixed exp(logit_scale).
* ``zero_shot_init`` (head.py:7-37): head columns = L2-normalized
  class-mean text features.

Where uml_tpu keeps a functional pytree, this is an ``nn.Module``: the
trainable parameters are the module's parameters that require a
gradient.  A CLIP or DINO ``backbone`` is a submodule; frozen (the
feature-space path) its parameters are set to ``requires_grad_(False)``
and it runs under ``torch.no_grad()``; trainable (the full-model path)
every backbone parameter trains (for CLIP the unused text tower and
``logit_scale`` included), as uml_tpu's ``make_uml_clip_head`` and
``make_uml_dino_head`` put all of the backbone's variables in the
trainable tree.

An RN backbone that trains (``make_uml_clip_head`` with
``freeze_backbone=False``) runs BatchNorm in its train form when
``image_features`` is given a ``bn_updates`` list; the running statistics
are buffers, never in the optimizer, and ``merge_bn_updates`` writes their
new values (from the pre-step statistics) in place after the optimizer
step, as uml_tpu merges its "bn_updates" collection
(train/supervised.py:213-216).

``state_tree`` / ``load_state_tree`` move the parameters as the tree that
uml_tpu saves in ``test_result.pth["model"]``: the head leaves under their
JAX names, and ``backbone`` (full-model path only) as the state_dict of
the port's backbone (the OpenAI schema for CLIP, the port's DinoViT names
for DINO).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from uml_tpu_torch.models.clip_resnet import merge_bn_updates

HEAD_LEAVES = ("head_w", "img_proj_w", "img_scale", "txt_scale")


class UMLHead(nn.Module):
    """forward(images_or_feats, text_features) -> (img_logits, txt_logits).

    ``backbone``: a CLIP or a DinoViT whose ``encode_image_u8`` maps uint8
    images (flat [B, H*W*3] or [B, H, W, 3]) to features; float inputs are
    taken as precomputed features.  Parameters are drawn from ``generator``
    (torch-Linear-like uniform, +-1/sqrt(fan_in)); parity with uml_tpu
    comes from loading its parameters (``load_state_tree``), not from the
    random bits.
    """

    def __init__(self, feat_dim: int, num_classes: int, *, text_indim: int = 0,
                 learnable_temp: bool = False, logit_scale: float | None = None,
                 backbone: nn.Module | None = None, freeze_backbone: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.feat_dim = feat_dim
        self.num_classes = num_classes
        self.text_indim = text_indim
        self.shared_dim = text_indim if text_indim > 0 else feat_dim
        self.learnable_temp = learnable_temp
        self.logit_scale = logit_scale
        self.freeze_backbone = freeze_backbone
        gen = generator if generator is not None else torch.Generator().manual_seed(0)

        def uniform(*shape, fan_in):
            bound = 1.0 / math.sqrt(fan_in)
            return nn.Parameter((torch.rand(shape, generator=gen) * 2 - 1) * bound)

        self.head_w = uniform(self.shared_dim, num_classes, fan_in=self.shared_dim)
        self.img_proj_w = (uniform(feat_dim, text_indim, fan_in=feat_dim)
                           if text_indim > 0 else None)
        if learnable_temp:
            self.img_scale = nn.Parameter(torch.tensor(1.0))
            self.txt_scale = nn.Parameter(torch.tensor(1.0))
        self.backbone = backbone
        if backbone is not None and freeze_backbone:
            backbone.requires_grad_(False)

    # -- params ---------------------------------------------------------------

    def zero_shot_init(self, text_features, text_labels) -> None:
        """head_w <- normalized class-mean text features (head.py:22-37)."""
        feats = np.asarray(text_features, np.float32)
        labels = np.asarray(text_labels)
        weights = np.zeros((self.num_classes, self.shared_dim), np.float32)
        for label in np.unique(labels):
            weights[int(label)] = feats[labels == label].mean(axis=0)
        weights /= np.linalg.norm(weights, axis=1, keepdims=True) + 1e-12
        with torch.no_grad():
            self.head_w.copy_(torch.from_numpy(weights.T))

    def state_tree(self) -> dict:
        """Detached CPU copies of the trainable parameters, as uml_tpu's
        tree: head leaves by name, ``backbone`` the backbone's state_dict
        when it trains.  The optimizer updates the parameters in
        place, so these are clones."""
        tree = {name: getattr(self, name).detach().cpu().clone()
                for name in HEAD_LEAVES if getattr(self, name, None) is not None}
        if self.backbone is not None and not self.freeze_backbone:
            tree["backbone"] = {k: v.detach().cpu().clone()
                                for k, v in self.backbone.state_dict().items()}
        return tree

    def load_state_tree(self, tree: dict) -> None:
        """Copy a ``state_tree`` (or uml_tpu's tree through
        models.convert.uml_head_params_from_jax) into the parameters."""
        with torch.no_grad():
            for name in HEAD_LEAVES:
                if name in tree:
                    getattr(self, name).copy_(torch.as_tensor(tree[name]))
        if "backbone" in tree:
            self.backbone.load_state_dict(
                {k: torch.as_tensor(v) for k, v in tree["backbone"].items()})

    # -- forward --------------------------------------------------------------

    def scales(self):
        """(img_scale, txt_scale): exp(logit_scale) for UMLClip, the
        learnable scales with ``learnable_temp``, else 1."""
        if self.logit_scale is not None:
            s = torch.exp(torch.tensor(self.logit_scale, dtype=torch.float32,
                                       device=self.head_w.device))
            return s, s
        if self.learnable_temp:
            return self.img_scale, self.txt_scale
        one = torch.ones((), device=self.head_w.device)
        return one, one

    @staticmethod
    def is_images(x) -> bool:
        """Backbone inputs are 4D pixel batches or uint8 (raw streams are
        flat [B, H*W*3] uint8); precomputed features are 2D floats."""
        return x.dim() == 4 or x.dtype == torch.uint8

    def image_features(self, x, bn_updates: list | None = None):
        """Backbone forward (+ img_proj) -> shared-space features, fp32.
        ``bn_updates`` (a trainable RN tower only, uml_head.py:134-148): a
        list that BatchNorm's train form fills with each layer's new
        running statistics, for ``merge_bn_updates``."""
        if self.backbone is not None and self.is_images(x):
            if self.freeze_backbone:
                with torch.no_grad():
                    x = self.backbone.encode_image_u8(x)
            elif bn_updates is None:
                x = self.backbone.encode_image_u8(x)
            else:
                x = self.backbone.encode_image_u8(x, bn_updates=bn_updates)
        x = x.float()
        if self.img_proj_w is not None:
            x = x @ self.img_proj_w
        return x

    # the step writes image_features' new running statistics after the
    # optimizer step (uml_head.py:150-170)
    merge_bn_updates = staticmethod(merge_bn_updates)

    def forward(self, images_or_feats, text_features=None):
        img_scale, txt_scale = self.scales()
        img_logits = self.image_features(images_or_feats) @ self.head_w * img_scale
        if text_features is None:
            return img_logits, None
        return img_logits, text_features.float() @ self.head_w * txt_scale


def make_uml_clip_head(clip, num_classes: int,
                       logit_scale: float = float(np.log(1 / 0.07)),
                       learnable_temp: bool = False, freeze_backbone: bool = True,
                       generator: torch.Generator | None = None) -> UMLHead:
    """UMLClip: the CLIP image tower + the shared head (head.py:101-141).
    An RN tower that trains (``freeze_backbone=False``) runs BatchNorm in
    its train form where the step passes ``bn_updates``
    (uml_head.py:200-212)."""
    return UMLHead(clip.config.embed_dim, num_classes, text_indim=0,
                   learnable_temp=learnable_temp, logit_scale=logit_scale,
                   backbone=clip, freeze_backbone=freeze_backbone,
                   generator=generator)


def make_uml_dino_head(dino, num_classes: int, text_indim: int = 0,
                       learnable_temp: bool = False, freeze_backbone: bool = True,
                       generator: torch.Generator | None = None) -> UMLHead:
    """UML with a DINO / DINOv2 backbone (head.py:39-98; uml_tpu's
    make_uml_dino_head): ``img_proj_w`` from the DINO width into
    ``text_indim`` when it is positive, the shared head, learnable scales
    with ``learnable_temp``.  The backbone takes uint8 images through
    ``encode_image_u8`` (the CLIP normalization folded into the patch
    embedding); with ``freeze_backbone=False`` (the full-model finetune)
    every DINO parameter trains."""
    return UMLHead(dino.num_features, num_classes, text_indim=text_indim,
                   learnable_temp=learnable_temp, backbone=dino,
                   freeze_backbone=freeze_backbone, generator=generator)
