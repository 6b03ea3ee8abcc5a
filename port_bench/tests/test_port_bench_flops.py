"""The FLOP and byte counts of both configurations against sums worked
by hand for one layer."""

import pytest

from port_bench import flops, harness


def _shape(name):
    cfg = harness.config(name)
    return harness.module("families", cfg["family"]).shape(cfg)


def test_clip_layer_by_hand():
    sh = _shape("clip_vit_b16")
    assert (sh["d"], sh["m"], sh["s"], sh["layers"]) == (768, 3072, 197, 12)
    b, s, d, m = 64, 197, 768, 3072
    t = b * s
    ops = dict((n, (f, by)) for n, f, by in flops.layer_forward(sh, b))
    # QKV: [T, 768] @ [768, 2304]; attention: QK^T and PV, 2 x 2 x B S^2 D
    assert ops["attn_qkv"][0] == 2 * t * d * 3 * d
    assert ops["attn_core"][0] == 4 * b * s * s * d
    assert ops["attn_out"][0] == 2 * t * d * d
    assert ops["mlp_in"][0] == ops["mlp_out"][0] == 2 * t * d * m
    total = 2 * t * d * 3 * d + 4 * b * s * s * d + 2 * t * d * d + 4 * t * d * m
    assert sum(f for f, _ in ops.values()) == total == pytest.approx(1.86106e11, rel=1e-5)
    # bytes, bf16: x in, weights, outputs; the residual read by the two
    # products that add it
    assert ops["attn_qkv"][1] == 2 * (t * d + 3 * d * d + 3 * t * d)
    assert ops["attn_core"][1] == 2 * (3 * t * d + t * d)
    assert ops["attn_out"][1] == 2 * (t * d + d * d + t * d + t * d)
    assert ops["mlp_in"][1] == 2 * (t * d + d * m + t * m)
    assert ops["mlp_out"][1] == 2 * (t * m + m * d + t * d + t * d)


def test_clip_cls_only_layer_by_hand():
    sh = _shape("clip_vit_b16")
    b, s, d, m = 64, 197, 768, 3072
    ops = dict((n, f) for n, f, _ in flops.layer_forward(sh, b, cls_only=True))
    # keys and values for every row, the query and the rest for the CLS row
    assert ops["attn_qkv"] == 2 * b * s * d * 2 * d + 2 * b * d * d
    assert ops["attn_core"] == 4 * b * s * d
    assert ops["mlp_in"] == 2 * b * d * m


def test_dinov2_layer_by_hand():
    sh = _shape("dinov2_vit_b14")
    assert (sh["d"], sh["m"], sh["s"], sh["p"]) == (768, 3072, 257, 14)
    b, s, d, m = 64, 257, 768, 3072
    t = b * s
    total = 2 * t * d * 3 * d + 4 * b * s * s * d + 2 * t * d * d + 4 * t * d * m
    assert sum(f for _, f, _ in flops.layer_forward(sh, b)) == total


def test_step_is_three_forwards_of_products():
    cfg = harness.config("clip_vit_b16")
    fam = harness.module("families", cfg["family"])
    fwd = fam.forward_ops(cfg, 64)
    assert fwd == flops.tower_forward(fam.shape(cfg), 64)
    ops = flops.train_step(fwd, fam.feature_width(cfg), 64, 64, 100, 512,
                           150_000_000, 86_000_000)
    patch = [f for n, f, _ in fwd if n == "patch_embed"][0]
    head = 2 * 64 * 512 * 100
    # the patch embedding's input (uint8 pixels) takes no gradient
    assert flops.model_flops(ops) == pytest.approx(
        3 * flops.model_flops(fwd) - patch + 3 * 2 * head, rel=1e-12)
    assert flops.model_flops(ops) / 64 == pytest.approx(97.86e9, rel=1e-3)
    dino = harness.config("dinov2_vit_b14")
    fam = harness.module("families", dino["family"])
    per_img = flops.model_flops(flops.train_step(
        fam.forward_ops(dino, 64), fam.feature_width(dino), 64, 64, 100, 3200, 1, 1)) / 64
    assert per_img == pytest.approx(129.09e9, rel=1e-3)


def test_least_time_is_the_slower_bound_op_by_op():
    ops = [("a", 989e12, 0.0), ("b", 0.0, 3.35e12), ("c", 989e12, 2 * 3.35e12)]
    assert flops.least_seconds(ops, flops.PEAK_BF16_FLOPS) == pytest.approx(1 + 1 + 2)


def test_mistral_call_by_hand():
    """Real tokens only: two rows of 3 and 5 tokens, causal pairs 6 + 15."""
    cfg = harness.config("mistral_7b")
    fam = harness.module("families", cfg["family"])
    d, m, kv, layers = 4096, 14336, 1024, 32
    ops = fam.forward_ops(cfg, [3, 5])
    n, pairs = 8, 6 + 15
    per_token = 2 * (d * d + 2 * d * kv + d * d + 3 * d * m)
    assert flops.model_flops(ops) == layers * (n * per_token + 4 * pairs * d)
    # every layer weight read once: 27.9 GB a call
    weights = 4 * layers * (2 * d * d + 2 * d * kv + 3 * d * m)
    assert weights == pytest.approx(27.92e9, rel=1e-3)
    # activations, 4 bytes: each op's input read and output written once,
    # the residual read by the two products that add it
    per_layer = ((n * d + n * (d + 2 * kv)) + (n * d + 2 * n * kv + n * d)
                 + 3 * n * d + (n * d + n * m) + (n * m + 2 * n * d))
    acts = 2 * n * d + layers * per_layer + (n * d + 2 * d)
    assert sum(b for _, _, b in ops) == 4 * acts + weights
    # float32 products are held to the TF32 tensor peak
    peak = flops.peak_flops(cfg["compute_dtype"])
    assert peak == 494.7e12
    assert flops.least_seconds(ops, peak) >= weights / flops.HBM_BYTES_PER_S
