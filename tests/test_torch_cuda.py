"""The CUDA kernels of uml_tpu_torch on the card, against their plain
PyTorch versions (bf16, small shapes: K=128, 2 heads of 64, S in {9, 17,
197}).  Marked ``cuda``: they skip without an NVIDIA GPU (sm_90a) and
run on the card with ``python -m pytest tests/test_torch_cuda.py -q``.

Bound: max |kernel - plain| <= 2^-6 * max|plain| (two bf16 ulps of the
largest output; the kernel and the plain version sum in other orders, so
an intermediate can round to the neighbouring bf16 value).
"""

import numpy as np
import pytest
import torch

from uml_tpu_torch.ops import fused_attention as fa
from uml_tpu_torch.ops import ln_matmul as lm
from uml_tpu_torch.ops import text_tower as tt

pytestmark = pytest.mark.cuda

K, HEADS, B = 128, 2, 3
M = 4 * K
REL = 2.0 ** -6


@pytest.fixture
def dev():
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _weights(dev, layers=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    lead = () if layers is None else (layers,)

    def rnd(*shape, std, dtype=torch.bfloat16):
        return (torch.randn(lead + shape, generator=g) * std).to(dtype).to(dev)

    f32 = torch.float32
    return (rnd(K, 3 * K, std=K ** -0.5), rnd(3 * K, std=0.1, dtype=f32),
            rnd(K, K, std=K ** -0.5), rnd(K, std=0.1, dtype=f32),
            rnd(K, M, std=K ** -0.5), rnd(M, std=0.1, dtype=f32),
            rnd(M, K, std=M ** -0.5), rnd(K, std=0.1, dtype=f32))


def _x(dev, s, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(B, s, K, generator=g).to(torch.bfloat16).to(dev)


def _close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL * want.float().abs().max().item(), err


@pytest.mark.parametrize("s", [9, 17, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_kernel(dev, s, causal):
    x, w = _x(dev, s), _weights(dev)
    n = fa.attn_block.launches
    got = fa.attn_block(x, *w[:4], heads=HEADS, causal=causal)
    assert fa.attn_block.launches == n + 1
    _close(got, fa.attn_block_plain(x, *w[:4], heads=HEADS, causal=causal))


@pytest.mark.parametrize("s", [9, 17, 197])
def test_attn_block_cls_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    n = fa.attn_block_cls.launches
    got = fa.attn_block_cls(x, *w[:4], heads=HEADS)
    assert fa.attn_block_cls.launches == n + 1
    _close(got, fa.attn_block_cls_plain(x, *w[:4], heads=HEADS))


@pytest.mark.parametrize("s", [9, 197])
def test_mlp_block_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    n = lm.mlp_block.launches
    got = lm.mlp_block(x, *w[4:])
    assert lm.mlp_block.launches == n + 1
    _close(got, lm.mlp_block_plain(x, *w[4:]))


def test_text_tower_kernel(dev):
    x, w = _x(dev, 77), _weights(dev, layers=2)
    n = tt.text_tower.launches
    got = tt.text_tower(x, *w, heads=HEADS)
    assert tt.text_tower.launches == n + 1
    _close(got, tt.text_tower_plain(x, *w, heads=HEADS))


def _close_all(got, want):
    for a, b in zip(got, want):
        _close(a, b)


def _g(dev, shape, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("s", [9, 17, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_stash_kernel(dev, s, causal):
    x, w = _x(dev, s), _weights(dev)
    n = fa.attn_block_stash.launches
    got = fa.attn_block_stash(x, *w[:4], heads=HEADS, causal=causal)
    assert fa.attn_block_stash.launches == n + 1
    _close_all(got, fa.attn_block_stash_plain(x, *w[:4], heads=HEADS,
                                              causal=causal))


@pytest.mark.parametrize("s", [9, 17, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_bwd_kernel(dev, s, causal):
    x, w = _x(dev, s), _weights(dev)
    _, qkv, _ = fa.attn_block_stash_plain(x, *w[:4], heads=HEADS, causal=causal)
    g = _g(dev, x.shape)
    n = fa.attn_block_bwd.launches
    got = fa.attn_block_bwd(x, g, qkv, w[0], w[2], heads=HEADS, causal=causal)
    assert fa.attn_block_bwd.launches == n + 1
    _close_all(got, fa.attn_block_bwd_plain(x, g, qkv, w[0], w[2], heads=HEADS,
                                            causal=causal))


@pytest.mark.parametrize("s", [9, 17, 197])
def test_attn_block_cls_bwd_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    _, qkv, _ = fa.attn_block_stash_plain(x, *w[:4], heads=HEADS, q_rows=1)
    g = _g(dev, (B, 1, K))
    n = fa.attn_block_cls_bwd.launches
    got = fa.attn_block_cls_bwd(x, g, qkv, w[0], w[2], heads=HEADS)
    assert fa.attn_block_cls_bwd.launches == n + 1
    _close_all(got, fa.attn_block_cls_bwd_plain(x, g, qkv, w[0], w[2],
                                                heads=HEADS))


@pytest.mark.parametrize("s", [9, 197])
def test_mlp_block_stash_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    n = lm.mlp_block_stash.launches
    got = lm.mlp_block_stash(x, *w[4:])
    assert lm.mlp_block_stash.launches == n + 1
    _close_all(got, lm.mlp_block_stash_plain(x, *w[4:]))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x, w = _x(dev, 17), _weights(dev)
    with pytest.raises(TypeError):
        fa.attn_block(x.float(), *w[:4], heads=HEADS)
    with pytest.raises(ValueError):
        lm.mlp_block(x.transpose(0, 1), *w[4:])
    with pytest.raises(ValueError):
        fa.attn_block(x, w[0].cpu(), *w[1:4], heads=HEADS)
    _, qkv, _ = fa.attn_block_stash(x, *w[:4], heads=HEADS)
    with pytest.raises(ValueError):
        fa.attn_block_bwd(x, x[:, :1].contiguous(), qkv, w[0], w[2], heads=HEADS)
    with pytest.raises(ValueError):
        fa.attn_block_bwd(_x(dev, 300), _x(dev, 300), qkv, w[0], w[2],
                          heads=HEADS)


@pytest.mark.parametrize("return_tokens", [False, True])
def test_tiny_clip_on_the_card_matches_the_cpu(dev, return_tokens):
    """The whole model, image tower (CLS path or every token) and text
    tower, on the card against the same weights on the CPU (bf16 both):
    per-row cosine >= 0.999."""
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.models.tokenizer import tokenize

    cfg = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=2,
                     vision_width=128, vision_patch_size=16,
                     transformer_width=128, transformer_heads=2,
                     transformer_layers=2)
    cpu = CLIP(cfg, dtype=torch.bfloat16).init_random(
        torch.Generator().manual_seed(0))
    gpu = CLIP(cfg, dtype=torch.bfloat16).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 64 * 64 * 3), dtype=np.uint8))
    toks = torch.from_numpy(tokenize(["a photo of a cat.", "a dog"]).astype(np.int64))
    with torch.no_grad():
        pairs = [
            (cpu.encode_image_u8(u8, return_tokens=return_tokens),
             gpu.encode_image_u8(u8.to(dev), return_tokens=return_tokens)),
            (cpu.encode_text(toks, return_tokens=return_tokens),
             gpu.encode_text(toks.to(dev), return_tokens=return_tokens)),
        ]
    for a, b in pairs:
        a = a.float().reshape(-1, a.shape[-1])
        b = b.float().cpu().reshape(-1, b.shape[-1])
        cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
        assert cos.min().item() >= 0.999
