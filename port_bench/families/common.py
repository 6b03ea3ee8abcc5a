"""What the families share: weights from a seed, drawn on the device in
one call, and the ViT half-blocks' launch counters."""

from __future__ import annotations

import torch


def draw(schema, seed: int, device) -> dict:
    """``schema``: [(key, shape, mean, std)] -> {key: float32 tensor}: one
    normal draw from a generator on ``device`` seeded with ``seed``, cut
    into the leaves and scaled in place."""
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in schema]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for (key, shape, mean, std), n in zip(schema, sizes):
        leaf = flat[off:off + n].view(shape)
        out[key] = leaf.mul_(std).add_(mean)
        off += n
    return out


def linear(prefix: str, d_in: int, d_out: int, weight: str = "weight",
           bias: str = "bias"):
    """A [out, in] weight N(0, in^-1/2) and a bias N(0, 0.02)."""
    return [(f"{prefix}{weight}", (d_out, d_in), 0.0, d_in ** -0.5),
            (f"{prefix}{bias}", (d_out,), 0.0, 0.02)]


def layer_norm(prefix: str, d: int):
    return [(f"{prefix}weight", (d,), 1.0, 0.1), (f"{prefix}bias", (d,), 0.0, 0.02)]


def vit_counters() -> dict:
    """The program's launch counters of a ViT tower's half-blocks: which
    forward and backward route a step took."""
    from uml_tpu_torch.ops import attention, fused_attention, ln_matmul

    return {
        "attn_block_stash": fused_attention.attn_block_stash.launches,
        "attn_block": fused_attention.attn_block.launches,
        "attn_block_bwd": fused_attention.attn_block_bwd.launches,
        "attn_block_bwd_recompute": fused_attention.attn_block_bwd_recompute.launches,
        "qkv_attention": fused_attention.qkv_attention.launches,
        "flash_attention": attention.flash_attention.launches,
        "mlp_block_stash": ln_matmul.mlp_block_stash.launches,
        "mlp_block": ln_matmul.mlp_block.launches,
        "mlp_bwd": ln_matmul.mlp_bwd.launches,
        "mlp_bwd_dw": ln_matmul.mlp_bwd_dw.launches,
        "mlp_bwd_via_stash": ln_matmul.mlp_bwd_via_stash.launches,
    }
