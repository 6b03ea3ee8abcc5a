"""Shared causal Transformer autoencoder for self-supervised UML (MultiBench).

The port of uml_tpu/models/seq_autoencoder.py as ``nn.Module``s, with the
flax parameter names (``xproj_in``, ``encoder.embed``,
``encoder.layers_{i}.{qkv,out_proj,linear1,linear2,norm1,norm2}``,
``encoder.pos_embedding``, ``dec_x``, ``dec_y``; ``models/convert.py``
maps the trees both ways).  Capability parity with MultiBench/models.py:

  * ``SeqTransformer`` == reference ``Transformer`` (models.py:39-127):
    Conv1d(k=1, no bias) input embed, written as the bias-free ``Linear``
    it is (no cuDNN convolution, so no TF32 default on the card), optional
    learnable / sinusoidal positions capped at ``max_len``, post-LN
    encoder layers (ReLU MLP, dim_feedforward 2048, dropout on the
    attention and MLP outputs) under the additive mask of uml_tpu (causal
    -inf plus -inf on padded keys), optional last-valid-step pooling;
  * ``TorchEncoderLayer`` is written by hand on ``ops/attention.py``'s
    ``mha_plain`` (the math of uml_tpu's ``mha_reference``), not on
    ``nn.TransformerEncoderLayer``, whose eval fast path returns zeros at
    padded steps: uml_tpu computes real values there, and they enter
    ``diff_next`` and ``loss_private``;
  * masked ``MSE`` and the fixed-shape ``SequenceInfoNCELoss``
    (models.py:129-175); their sums, the mask's count and InfoNCE's
    negatives span the global batch under data parallelism
    (parallel/data_parallel.py::global_batch), as uml_tpu's do on a mesh;
  * ``SeqUML`` == reference ``UML`` (models.py:178-278), the y branch not
    key-padding masked (the reference's quirk, kept).

fp32 end to end.  Dropout is on only when a ``generator`` is passed: each
mask is drawn from that ``torch.Generator`` (on the model's device; under
data parallelism the global batch's mask, of which each rank keeps its
rows) and scaled by 1 / (1 - p), flax's ``nn.Dropout``; jax.random's masks cannot
be reproduced, so the parity tests set ``dropout`` to 0.  ``init_random``
draws flax's init distributions (truncated lecun-normal kernels, zero
biases, unit LayerNorm scales, ``pos_embedding`` normal(1.0)) from a
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from uml_tpu_torch.ops.attention import mha_plain
from uml_tpu_torch.parallel.data_parallel import (
    global_gather,
    global_mean,
    global_rows,
    global_sum,
    row_offset,
)

# flax's truncated lecun-normal: N(0, 1) cut at +-2, rescaled to unit
# variance (jax.nn.initializers.variance_scaling's constant)
_TRUNC_STD = 0.87962566103423978


def length_mask(lengths, seq_len):
    """[B] lengths -> bool [B, T] valid mask."""
    return torch.arange(seq_len, device=lengths.device)[None, :] < lengths[:, None]


def masked_mse(predictions, targets, mask=None):
    """Parity with models.py:129-143; the denominator counts mask elements
    after the broadcast over the feature dim (the reference's expand_as)."""
    if mask is None:
        return global_mean((predictions - targets) ** 2)
    m = mask[..., None].expand(targets.shape).to(predictions.dtype)
    return (global_sum(torch.sum((predictions - targets) ** 2 * m))
            / (global_sum(torch.sum(m)) + 1e-8))


def sequence_info_nce(predictions, targets, mask=None, temperature=0.07):
    """In-batch InfoNCE over valid tokens (models.py:145-175), fixed-shape:
    a [B*T, B*T] logit matrix with padded targets set to -1e30 (each row
    keeps its own positive).  predictions / targets [B, T, D], mask bool
    [B, T] (True = valid)."""
    b, t, d = predictions.shape
    n = b * t
    preds = predictions.reshape(n, d)
    targs = targets.reshape(n, d)
    valid = (torch.ones(n, dtype=torch.bool, device=preds.device)
             if mask is None else mask.reshape(n))
    preds = preds / (torch.linalg.vector_norm(preds, dim=-1, keepdim=True) + 1e-12)
    targs = targs / (torch.linalg.vector_norm(targs, dim=-1, keepdim=True) + 1e-12)
    # under data parallelism the negatives are every rank's targets and
    # row i's positive is column offset + i of the gathered targets
    targs_all = global_gather(targs)
    valid_all = global_gather(valid.to(torch.uint8)).bool()
    rows = torch.arange(n, device=preds.device)
    cols = rows + row_offset(n)
    eye = torch.zeros(n, targs_all.shape[0], dtype=torch.bool, device=preds.device)
    eye[rows, cols] = True
    logits = preds @ targs_all.T / temperature
    logits = logits.masked_fill(~(valid_all[None, :] | eye), -1e30)
    per_row = -F.log_softmax(logits, dim=-1)[rows, cols]
    w = valid.to(predictions.dtype)
    return global_sum(torch.sum(per_row * w)) / (global_sum(torch.sum(w)) + 1e-8)


def dropout(x, p: float, generator):
    """flax ``nn.Dropout``: keep with probability 1 - p, scale by 1 / (1 - p);
    the identity without a ``generator`` or at p = 0.  Under data
    parallelism every rank draws the global batch's mask from the same
    generator and keeps its rows: the masks of a one-process run."""
    if generator is None or p == 0.0:
        return x
    n = x.shape[0]
    start = row_offset(n)
    keep = torch.rand((global_rows(n), *x.shape[1:]), generator=generator,
                      device=x.device)[start:start + n] >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def _lecun_normal_(weight, generator):
    """flax's default Dense kernel init on a [out, in] weight: a truncated
    normal by the inverse CDF, as jax.random.truncated_normal draws it."""
    lo, hi = (math.erf(v / math.sqrt(2)) for v in (-2.0, 2.0))
    u = torch.rand(weight.shape, generator=generator, device=weight.device,
                   dtype=torch.float64)
    z = math.sqrt(2) * torch.erfinv(lo + (hi - lo) * u)
    std = weight.shape[1] ** -0.5 / _TRUNC_STD
    with torch.no_grad():
        weight.copy_((z * std).to(weight.dtype))


class TorchEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer semantics (post-LN, ReLU), by hand."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model ({d_model}) must be divisible by nhead "
                             f"({nhead}) — pick zdim as a multiple of 5")
        self.d_model, self.nhead, self.dropout = d_model, nhead, dropout
        self.qkv = nn.Linear(d_model, 3 * d_model)
        self.out_proj = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, attn_mask=None, generator=None):
        b, t, _ = x.shape
        h, dh = self.nhead, self.d_model // self.nhead
        qkv = self.qkv(x).reshape(b, t, 3, h, dh).permute(2, 0, 3, 1, 4)
        attn = mha_plain(qkv[0], qkv[1], qkv[2], mask=attn_mask)
        attn = self.out_proj(attn.transpose(1, 2).reshape(b, t, self.d_model))
        x = self.norm1(x + dropout(attn, self.dropout, generator))
        y = dropout(F.relu(self.linear1(x)), self.dropout, generator)
        y = dropout(self.linear2(y), self.dropout, generator)
        return self.norm2(x + y)


def sinusoid_table(max_len: int, dim: int) -> torch.Tensor:
    """The fixed position table (seq_autoencoder.py:134-139): sin in the
    even columns, cos in the odd ones."""
    position = torch.arange(max_len, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-math.log(10000.0) / dim))
    table = torch.zeros(max_len, dim)
    table[:, 0::2] = torch.sin(position * div)
    table[:, 1::2] = torch.cos(position * div)[:, : dim // 2]
    return table


class SeqTransformer(nn.Module):
    """Reference ``Transformer`` (models.py:39-127), batch-major."""

    def __init__(self, n_features: int, dim: int, nhead: int = 5,
                 num_layers: int = 5, conv1d: bool = True, out_last: bool = True,
                 pos_embd: bool = False, pos_learnable: bool = False,
                 max_len: int = 128, dropout: float = 0.1):
        super().__init__()
        self.dim, self.conv1d, self.out_last = dim, conv1d, out_last
        self.pos_embd, self.pos_learnable, self.max_len = pos_embd, pos_learnable, max_len
        self.num_layers = num_layers
        if conv1d:
            # Conv1d(kernel_size=1, bias=False) == a bias-free Linear per step
            self.embed = nn.Linear(n_features, dim, bias=False)
        if pos_embd and pos_learnable:
            self.pos_embedding = nn.Parameter(torch.empty(max_len, dim))
        elif pos_embd:
            self.register_buffer("pos_table", sinusoid_table(max_len, dim),
                                 persistent=False)
        for i in range(num_layers):
            self.add_module(f"layers_{i}", TorchEncoderLayer(dim, nhead,
                                                             dropout=dropout))

    def forward(self, x, lengths=None, generator=None):
        t = x.shape[1]
        if self.conv1d:
            x = self.embed(x)
        if self.pos_embd:
            t = min(t, self.max_len)
            table = self.pos_embedding if self.pos_learnable else self.pos_table
            x = x[:, :t] + table[:t][None]

        # additive mask: causal + key padding (-inf on padded keys)
        keep = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        zero = torch.zeros((), device=x.device)
        mask = torch.where(keep, zero, float("-inf"))[None, None]
        if lengths is not None:
            pad = torch.where(length_mask(lengths, t), zero, float("-inf"))
            mask = mask + pad[:, None, None, :]

        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, attn_mask=mask, generator=generator)

        if self.out_last:
            if lengths is not None:
                idx = torch.clamp(lengths - 1, 0, t - 1).long()
                return x[torch.arange(x.shape[0], device=x.device), idx]
            return x[:, -1]
        return x


class SeqUML(nn.Module):
    """Reference ``UML`` (models.py:178-278).

    forward(x, y, x_lengths, y_lengths, generator) -> dict of losses and
    activations (uml_tpu's keys).
    """

    def __init__(self, xdim: int, ydim: int, zdim: int, nhead: int = 5,
                 num_layers: int = 5, pos_embd: bool = False,
                 pos_learnable: bool = False, max_len: int = 128,
                 info_nce: bool = False, dropout: float = 0.1):
        super().__init__()
        self.info_nce = info_nce
        self.xproj_in = nn.Linear(xdim, zdim)
        self.yproj_in = nn.Linear(ydim, zdim)
        self.encoder = SeqTransformer(zdim, zdim, nhead=nhead, num_layers=num_layers,
                                      conv1d=True, out_last=False, pos_embd=pos_embd,
                                      pos_learnable=pos_learnable, max_len=max_len,
                                      dropout=dropout)
        self.dec_x = nn.Linear(zdim, xdim)
        self.dec_y = nn.Linear(zdim, ydim)

    def init_random(self, generator: torch.Generator) -> "SeqUML":
        """flax's init distributions, drawn from ``generator``: truncated
        lecun-normal Dense kernels, zero biases, unit LayerNorm scales,
        ``pos_embedding`` normal(1.0)."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                _lecun_normal_(module.weight, generator)
                if module.bias is not None:
                    nn.init.zeros_(module.bias)
            elif isinstance(module, nn.LayerNorm):
                nn.init.ones_(module.weight)
                nn.init.zeros_(module.bias)
        if hasattr(self.encoder, "pos_embedding"):
            p = self.encoder.pos_embedding
            with torch.no_grad():
                p.copy_(torch.randn(p.shape, generator=generator, device=p.device))
        return self

    def _branch(self, proj_fn, dec_fn, data, lengths, generator, critic,
                mask_encoder: bool):
        if data.dim() == 2:
            data = data[:, None, :]
        proj = proj_fn(data)
        # parity quirk: the reference key-padding-masks the encoder for x
        # (models.py:201) but NOT for y (models.py:233); y lengths only mask
        # the loss
        z = self.encoder(proj, lengths=lengths if mask_encoder else None,
                         generator=generator)
        recon = dec_fn(z)
        mask = length_mask(lengths, data.shape[1]) if lengths is not None else None
        if recon.shape[1] == 1:
            loss = masked_mse(recon[:, 0, :], data[:, 0, :])
        else:
            loss = critic(recon[:, :-1, :], data[:, 1:, :],
                          mask[:, 1:] if mask is not None else None)
        diff_next = global_mean((proj - z) ** 2)
        return loss, proj, z, recon, diff_next

    def forward(self, x=None, y=None, x_lengths=None, y_lengths=None,
                generator=None):
        ref = x if x is not None else y
        zero = torch.zeros((), dtype=torch.float32, device=ref.device)
        out = {"loss_x": zero, "loss_y": zero, "loss_private": zero}
        if x is not None:
            (out["loss_x"], out["x_proj"], out["zx"], out["x_recon"],
             out["diff_next_x"]) = self._branch(
                self.xproj_in, self.dec_x, x, x_lengths, generator, masked_mse,
                mask_encoder=True)
        if y is not None:
            y_critic = sequence_info_nce if self.info_nce else masked_mse
            (out["loss_y"], out["y_proj"], out["zy"], out["y_recon"],
             out["diff_next_y"]) = self._branch(
                self.yproj_in, self.dec_y, y, y_lengths, generator, y_critic,
                mask_encoder=False)
        if x is not None and y is not None:
            x_private = out["x_proj"] - out["zx"]
            y_private = out["y_proj"] - out["zy"]
            out["x_private"], out["y_private"] = x_private, y_private
            # models.py:258-262: sum over the batch of the squared mean
            # cross-correlation of the residuals
            out["loss_private"] = global_sum(torch.sum(
                torch.mean(x_private * y_private, dim=(1, 2)) ** 2))
        return out

    def get_embedding(self, x, y):
        """Mean-pooled shared-encoder latents (models.py:273-278)."""
        if x.dim() == 2:
            x = x[:, None, :]
        if y.dim() == 2:
            y = y[:, None, :]
        zx = self.encoder(self.xproj_in(x))
        zy = self.encoder(self.yproj_in(y))
        return zx.mean(dim=1), zy.mean(dim=1)


def make_seq_uml(xdim, ydim, zdim, pos_embd=False, pos_learnable=False,
                 info_nce=False, dropout=0.1) -> SeqUML:
    """Assemble the reference main.py:117-121 architecture."""
    return SeqUML(xdim=xdim, ydim=ydim, zdim=zdim, nhead=5, num_layers=5,
                  pos_embd=pos_embd, pos_learnable=pos_learnable, max_len=128,
                  info_nce=info_nce, dropout=dropout)
