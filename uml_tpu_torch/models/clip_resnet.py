"""CLIP ModifiedResNet image towers (RN50 / RN101) in PyTorch.

The port of uml_tpu/models/clip_resnet.py (behavioral parity with the
OpenAI CLIP ResNet, engine/clip/model.py:10-150):

* a 3-conv stem (each 3x3, BN + ReLU), then a 2x2 average pool;
* anti-aliased strided Bottlenecks: a stride above 1 is an average pool
  before the third conv, and the downsample branch is average pool ->
  1x1 conv -> BN;
* AttentionPool2d: the mean token first, the learned positional
  embedding, one multi-head attention whose only query is the mean token
  (fp32 scores).

Parameter names follow the OpenAI state_dict schema
(``visual.layer1.0.conv1.weight``, ``downsample.0`` / ``.1``,
``attnpool.q_proj``), so a checkpoint loads without conversion.  No
uml_tpu kernel lives here (uml_tpu computes the convolutions in XLA): the
convolutions are ``F.conv2d``, cuDNN on the card, in the model's compute
dtype (bf16 for serving) and in ``channels_last`` there.

BatchNorm has two forms, as uml_tpu's ``FrozenBatchNorm``
(clip_resnet.py:52-88):

* eval, over the running statistics: ``x * inv + (bias - mean * inv)``
  with ``inv = scale / sqrt(var + 1e-5)``; the towers fold it into the
  preceding convolution's weight and bias (cached, keyed on the tensors'
  version counters so an in-place update rebuilds it, and derived anew
  when autograd wants a gradient);
* train (``bn_updates``, a list, passed down the tower: uml_tpu's
  ``train_bn=True``): conv -> BN -> ReLU unfolded under autograd; the
  batch statistics in fp32 over every axis but the channel, ``bvar =
  max(E[x^2] - E[x]^2, 0)``, normalize; the running statistics' new
  values (momentum 0.1, the unbiased ``bvar * n / (n - 1)``) are appended
  to ``bn_updates`` as (module, mean, var), and written into the buffers
  only by ``merge_bn_updates``, after the optimizer step (uml_tpu's
  "bn_updates" collection and ``UMLHead.merge_bn_updates``).
  ``F.batch_norm(training=True)`` computes the variance another way, so
  it is not used.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from uml_tpu_torch.core.meshes import data_size
from uml_tpu_torch.models.clip import Linear, _Cached, _needs_grad
from uml_tpu_torch.parallel.data_parallel import active_shard

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


@dataclass(frozen=True)
class ClipResNetConfig:
    layers: tuple[int, int, int, int]
    output_dim: int
    width: int = 64
    image_resolution: int = 224

    @property
    def heads(self) -> int:
        return self.width * 32 // 64

    @property
    def embed_dim(self) -> int:
        return self.output_dim


CLIP_RESNET_CONFIGS = {
    "RN50": ClipResNetConfig((3, 4, 6, 3), 1024),
    "RN101": ClipResNetConfig((3, 4, 23, 3), 512),
}


class FrozenBatchNorm(nn.Module):
    """BatchNorm2d's parameters and running statistics (OpenAI names);
    the forward is the eval form, per channel of an NCHW tensor."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def scale_shift(self):
        """(inv, bias - mean * inv) in fp32, inv = scale / sqrt(var + eps)."""
        inv = self.weight.float() / torch.sqrt(self.running_var.float() + BN_EPS)
        return inv, self.bias.float() - self.running_mean.float() * inv

    def forward(self, x, bn_updates: list | None = None):
        if bn_updates is not None:
            return batch_norm_train(x, self, bn_updates)
        inv, shift = self.scale_shift()
        return (x * inv.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


def batch_norm_train(x, bn: FrozenBatchNorm, bn_updates: list):
    """The train form on NCHW ``x`` (clip_resnet.py:72-87): batch
    statistics in fp32 normalize, the result in x's dtype; appends (bn,
    new running mean, new running var) to ``bn_updates`` (no autograd
    history), leaving the buffers as they are.

    Under data parallelism (parallel/data_parallel.py::global_batch) the
    statistics are the global batch's: the sums of x and x² over every
    rank's rows, so every rank writes the same running statistics."""
    xf = x.float()
    axes = (0, 2, 3)
    n = x.numel() // x.shape[1]
    shard = active_shard()
    if shard is None:
        bmean = xf.mean(axes)
        sq_mean = (xf * xf).mean(axes)
    else:
        n *= data_size(shard.mesh)
        bmean = shard.sum(xf.sum(axes)) / n
        sq_mean = shard.sum((xf * xf).sum(axes)) / n
    bvar = torch.clamp(sq_mean - bmean * bmean, min=0.0)
    inv = bn.weight.float() / torch.sqrt(bvar + BN_EPS)
    y = xf * inv[:, None, None] + (bn.bias.float() - bmean * inv)[:, None, None]
    n = max(n, 2)
    with torch.no_grad():
        unbiased = bvar * n / (n - 1)
        new_mean = (1 - BN_MOMENTUM) * bn.running_mean + BN_MOMENTUM * bmean
        new_var = (1 - BN_MOMENTUM) * bn.running_var + BN_MOMENTUM * unbiased
    bn_updates.append((bn, new_mean, new_var))
    return y.to(x.dtype)


def merge_bn_updates(bn_updates) -> None:
    """Write the new running statistics of a train-form forward into the
    BatchNorm buffers, in place (after the optimizer step; None: no-op).
    The writes move the buffers' version counters, so the eval form's
    cached fold rebuilds."""
    with torch.no_grad():
        for bn, mean, var in bn_updates or ():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


class Conv2d(nn.Module):
    """A bias-free convolution's weight [out, in, k, k], with the cache of
    that weight with the following BatchNorm folded in."""

    def __init__(self, c_in: int, c_out: int, k: int, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c_out, c_in, k, k))
        self.stride, self.padding = stride, padding
        self._folded = _Cached()


def conv_bn(x, conv: Conv2d, bn: FrozenBatchNorm, relu: bool = True,
            bn_updates: list | None = None):
    """bn(conv(x)) as one convolution in x's dtype: the weight scaled by
    inv per output channel, the shift as its bias (folded in fp32, then
    cast), ReLU after it unless ``relu`` is False.  With ``bn_updates``
    the train form: the convolution, then BatchNorm on the batch
    statistics, unfolded."""
    dtype, cuda = x.dtype, x.is_cuda
    if bn_updates is not None:
        w = conv.weight.to(dtype)
        if cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        y = bn(F.conv2d(x, w, None, conv.stride, conv.padding), bn_updates)
        return F.relu(y) if relu else y

    def fold():
        inv, shift = bn.scale_shift()
        w = (conv.weight.float() * inv[:, None, None, None]).to(dtype)
        if cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        return w, shift.to(dtype)

    params = [conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var]
    if _needs_grad(x, *params):
        w, b = fold()
    else:
        w, b = conv._folded.get(params, (dtype, cuda), fold)
    y = F.conv2d(x, w, b, conv.stride, conv.padding)
    return F.relu(y) if relu else y


class Bottleneck(nn.Module):
    EXPANSION = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.EXPANSION
        self.stride = stride
        self.conv1, self.bn1 = Conv2d(in_planes, planes, 1), FrozenBatchNorm(planes)
        self.conv2, self.bn2 = Conv2d(planes, planes, 3, padding=1), FrozenBatchNorm(planes)
        self.conv3, self.bn3 = Conv2d(planes, out, 1), FrozenBatchNorm(out)
        self.downsample = None
        if stride > 1 or in_planes != out:
            # OpenAI's "-1" is the parameter-free average pool
            self.downsample = nn.ModuleList([Conv2d(in_planes, out, 1),
                                             FrozenBatchNorm(out)])

    def forward(self, x, bn_updates: list | None = None):
        out = conv_bn(x, self.conv1, self.bn1, bn_updates=bn_updates)
        out = conv_bn(out, self.conv2, self.bn2, bn_updates=bn_updates)
        if self.stride > 1:
            out = F.avg_pool2d(out, self.stride)
        out = conv_bn(out, self.conv3, self.bn3, relu=False, bn_updates=bn_updates)
        identity = x
        if self.downsample is not None:
            if self.stride > 1:
                identity = F.avg_pool2d(x, self.stride)
            identity = conv_bn(identity, *self.downsample, relu=False,
                               bn_updates=bn_updates)
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    def __init__(self, spacial_dim: int, embed_dim: int, num_heads: int,
                 output_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim))
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.c_proj = Linear(embed_dim, output_dim)
        self._cast = _Cached()

    def _weights(self, dtype):
        def cast():
            return tuple(t.to(dtype) for p in (self.q_proj, self.k_proj,
                                               self.v_proj, self.c_proj)
                         for t in (p.weight, p.bias))
        params = list(self.parameters())
        if _needs_grad(*params):
            return cast()
        return self._cast.get(params, dtype, cast)

    def forward(self, x):
        """x [B, C, H, W] -> [B, output_dim] fp32 (clip_resnet.py:127-158)."""
        b, c = x.shape[:2]
        dt = x.dtype
        wq, bq, wk, bk, wv, bv, wc, bc = self._weights(dt)
        tokens = x.flatten(2).transpose(1, 2)                     # [B, HW, C]
        tokens = torch.cat([tokens.float().mean(1, keepdim=True).to(dt),
                            tokens], dim=1)
        tokens = tokens + self.positional_embedding.to(dt)
        h = self.num_heads
        dh = c // h
        q = F.linear(tokens[:, :1], wq, bq).view(b, 1, h, dh).transpose(1, 2)
        k = F.linear(tokens, wk, bk).view(b, -1, h, dh).transpose(1, 2)
        v = F.linear(tokens, wv, bv).view(b, -1, h, dh).transpose(1, 2)
        scores = (q.float() @ k.float().transpose(-1, -2)) * dh ** -0.5
        attn = scores.softmax(-1)
        pooled = (attn.to(dt) @ v).transpose(1, 2).reshape(b, 1, c)
        return F.linear(pooled, wc, bc)[:, 0].float()


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: ClipResNetConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv1, self.bn1 = Conv2d(3, w // 2, 3, stride=2, padding=1), FrozenBatchNorm(w // 2)
        self.conv2, self.bn2 = Conv2d(w // 2, w // 2, 3, padding=1), FrozenBatchNorm(w // 2)
        self.conv3, self.bn3 = Conv2d(w // 2, w, 3, padding=1), FrozenBatchNorm(w)
        in_planes = w
        for stage, (blocks, planes, stride) in enumerate(zip(
                cfg.layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            layer = []
            for blk in range(blocks):
                layer.append(Bottleneck(in_planes, planes, stride if blk == 0 else 1))
                in_planes = planes * Bottleneck.EXPANSION
            setattr(self, f"layer{stage + 1}", nn.Sequential(*layer))
        self.attnpool = AttentionPool2d(cfg.image_resolution // 32, w * 32,
                                        cfg.heads, cfg.output_dim)

    def forward(self, pixels, dtype, return_tokens: bool = False,
                bn_updates: list | None = None):
        """Normalized pixels [B, H, W, 3] -> features [B, output_dim] fp32,
        or with ``return_tokens`` the last stage's map as [B, HW, C] fp32.
        ``bn_updates``: a list, for BatchNorm's train form (uml_tpu's
        ``train_bn=True``), which receives every layer's new running
        statistics."""
        x = pixels.permute(0, 3, 1, 2).to(dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2),
                         (self.conv3, self.bn3)):
            x = conv_bn(x, conv, bn, bn_updates=bn_updates)
        x = F.avg_pool2d(x, 2)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for block in stage:
                x = block(x, bn_updates)
        if return_tokens:
            return x.flatten(2).transpose(1, 2).float()
        return self.attnpool(x)

    def init_random(self, generator: torch.Generator) -> "ModifiedResNet":
        """Lecun-normal convolution and projection weights, zero biases,
        the positional embedding normal with std C^-0.5 (uml_tpu's flax
        init); BatchNorm scales, shifts and running statistics drawn near
        the identity, so the fold is exercised and every residual branch
        (bn3 included) counts."""
        def rnd(p, std, mean=0.0):
            with torch.no_grad():
                p.copy_(mean + std * torch.randn(p.shape, generator=generator))

        for name, m in self.named_modules():
            if isinstance(m, Conv2d):
                rnd(m.weight, m.weight[0].numel() ** -0.5)
            elif isinstance(m, Linear):
                rnd(m.weight, m.weight.shape[1] ** -0.5)
            elif isinstance(m, FrozenBatchNorm):
                rnd(m.weight, 0.1, 0.5 if name.endswith("bn3") else 1.0)
                rnd(m.bias, 0.1)
                rnd(m.running_mean, 0.1)
                with torch.no_grad():
                    m.running_var.copy_(1.0 + 0.2 * torch.rand(
                        m.running_var.shape, generator=generator))
        pos = self.attnpool.positional_embedding
        rnd(pos, pos.shape[1] ** -0.5)
        return self
