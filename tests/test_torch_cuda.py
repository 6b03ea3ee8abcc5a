"""The CUDA kernels of uml_tpu_torch on the card, against their plain
PyTorch versions (bf16, small shapes: K=128, 2 heads of 64, S in {9, 17,
197}, and S = 257 and 785 for the attention halves and the training
rows, and the 64-row tile edges S in {63, 64, 65, 128, 129} for the MLP
halves, the attention backwards and the attention backward's two passes
on their own; the fused QKV + attention kernel and the attention halves
(rows 1, 2, 5, 7 and 10) at S in {9, 17, 50, 63, 64, 65, 128, 129, 197,
256, 257}: both sides of its m64 edges and of its route limit, S <= 256,
with the route each S took read off the launch counters; the streaming attention at S from 1 to 2048, head dims 64 and 128,
also on strided views of a packed qkv; layer_norm at row counts up to
40,000; the stand-alone ops of rows 14-17 (the LN pre-pass and the
engine) at row counts 1 to 4 x 197 and both towers' QKV and c_fc widths,
every activation; each product triple of the wgmma engine and gemm_at at
ragged row counts and both towers' widths, against an fp32 product of the
same bf16 operands, gemm_at at every row-chunk count; the int8 GEMM at ragged
row counts and every int8 width, equal to torch._int_mm's integer sum and
to its plain version bit for bit; DINO's exact-GELU MLP halves, row 3 at
K in {384, 768, 1024} and S in {197, 257, 785}, row 11 and c_fc's
exact-GELU quantizing pass, a DINOv2 batch against the CPU, and the
exact-GELU training rows 9, 19 and 20 at S in {9, 17, 257} with the
engine's exact-GELU triples).  Also: every attention wrapper refuses head
dim 32 (F8), and the features loop's staging (the copy stream, the ring of
four reused pinned buffers, the copy back into pinned memory) gives the
synchronous encode's features bit for bit.  Marked ``cuda``: they skip without an NVIDIA GPU (sm_90a) and
run on the card with ``python -m pytest tests/test_torch_cuda.py -q``.
The text tower runs at B in {1, 3, 64} and S in {77, 129}, both sides of
its route (one launch for S <= 128, the chain above), and at the ViT-B
text widths at B = 1; the CLS backward is also held to its rank-2H plain
version.

Bound: max |kernel - plain| <= 2^-6 * max|plain| (two bf16 ulps of the
largest output; the kernel and the plain version sum in other orders, so
an intermediate can round to the neighbouring bf16 value).  The int8
ports are held to the same bound per half-block (an int8 activation at a
.5 tie can move by one step, ~1/254 of its row's range) and to 2^-4 for
the 2-layer int8 tower, whose output must also equal the per-layer int8
kernels' bit for bit; the int8 attention output's integers may differ from
the plain version's by one step at most.  c_fc's two int8 passes (the row
maxima, then the int8 hidden) against the F32 product followed by the
plain act_quantize_rows, at rows 197, 12,545 and 12,608: the row maxima
bit for bit, the scales within rtol 1e-6 and the integers within one step
on at most 0.1% of them (torch's quick_gelu may round otherwise).
"""

import numpy as np
import pytest
import torch

from uml_tpu_torch.ops import fused_attention as fa
from uml_tpu_torch.ops import ln_matmul as lm
from uml_tpu_torch.ops import quant as q8
from uml_tpu_torch.ops import text_tower as tt
from uml_tpu_torch.ops import tower_q8 as tq8

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


SEQ = [9, 17, 50, 63, 64, 65, 128, 129, 197, 256, 257]


def _route(counter, n, launches=1):
    """-> a check that ``counter`` moved by ``launches`` on the fused route
    (S <= 256) and stayed on the chain."""
    def check(s):
        assert counter.launches == n + launches * fa.qkv_attention_fused(s), (
            s, counter.launches, n)
    return check


@pytest.mark.parametrize("s", sorted(set(SEQ + [785])))
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_kernel(dev, s, causal):
    x, w = _x(dev, s), _weights(dev)
    n, route = fa.attn_block.launches, _route(fa.qkv_attention, fa.qkv_attention.launches)
    got = fa.attn_block(x, *w[:4], heads=HEADS, causal=causal)
    assert fa.attn_block.launches == n + 1
    route(s)
    _close(got, fa.attn_block_plain(x, *w[:4], heads=HEADS, causal=causal))


@pytest.mark.parametrize("s", SEQ + [785])
def test_attn_block_cls_kernel(dev, s):
    """#2, and its training form (the CLS forward that keeps its stash,
    projecting q of every row where the inference form projects the first
    64)."""
    x, w = _x(dev, s), _weights(dev)
    n, route = fa.attn_block_cls.launches, _route(fa.qkv_attention, fa.qkv_attention.launches)
    got = fa.attn_block_cls(x, *w[:4], heads=HEADS)
    assert fa.attn_block_cls.launches == n + 1
    route(s)
    _close(got, fa.attn_block_cls_plain(x, *w[:4], heads=HEADS))
    stash = fa._attn_block_cls_stash(x, *w[:4], heads=HEADS, eps=1e-5)
    _close_all(stash, fa.attn_block_stash_plain(x, *w[:4], heads=HEADS, q_rows=1))
    assert torch.equal(stash[0], got)


@pytest.mark.parametrize("s", SEQ[:-1])
@pytest.mark.parametrize("causal, q_rows", [(False, "all"), (True, "all"),
                                            (False, "cls")])
def test_qkv_attention_kernel(dev, s, causal, q_rows):
    """The fused QKV + attention kernel on its own: attn without the
    stash, (qkv, attn) with it, each launch counted (the CLS row is never
    causal)."""
    x, w = _x(dev, s), _weights(dev)
    sq = s if q_rows == "all" else 1
    n = fa.qkv_attention.launches
    want = fa.qkv_attention_plain(x, *w[:2], heads=HEADS, causal=causal, q_rows=sq,
                                  stash=True)
    _close(fa.qkv_attention(x, *w[:2], heads=HEADS, causal=causal, q_rows=sq), want[1])
    _close_all(fa.qkv_attention(x, *w[:2], heads=HEADS, causal=causal, q_rows=sq,
                                stash=True), want)
    assert fa.qkv_attention.launches == n + 2


@pytest.mark.parametrize("s", SEQ[:-1])
@pytest.mark.parametrize("causal", [False, True])
def test_qkv_attention_q8_kernel(dev, s, causal):
    x, w = _x(dev, s), _q8_weights(dev)
    n = q8.qkv_attention_q8.launches
    got = q8.qkv_attention_q8(x, *w[:3], heads=HEADS, causal=causal)
    assert q8.qkv_attention_q8.launches == n + 1
    _close(got, q8.qkv_attention_q8_plain(x, *w[:3], heads=HEADS, causal=causal))


def test_qkv_attention_refuses_s_past_its_route(dev):
    x, w = _x(dev, 257), _weights(dev)
    with pytest.raises(ValueError, match="S <= 256"):
        fa.qkv_attention(x, *w[:2], heads=HEADS)


@pytest.mark.parametrize("s", [9, 63, 64, 65, 128, 129, 197])
def test_mlp_block_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    n = lm.mlp_block.launches
    got = lm.mlp_block(x, *w[4:])
    assert lm.mlp_block.launches == n + 1
    _close(got, lm.mlp_block_plain(x, *w[4:]))


# DINO's widths (ViT-S/14, B/14, L/14) and lengths (257 at 224 / 14, 785
# at 224 / 8, and the CLIP ViT-B/16 length)
@pytest.mark.parametrize("k", [384, 768, 1024])
@pytest.mark.parametrize("s", [197, 257, 785])
def test_mlp_block_gelu_exact_kernel(dev, k, s):
    """Row 3 with exact GELU (DINO's MLP half: the engine's OUT_GELU_EXACT
    on the PRO_LN route), and with no activation at one shape."""
    g = torch.Generator().manual_seed(k + s)
    m, f32 = 4 * k, torch.float32
    x = torch.randn(2, s, k, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(k, m, generator=g) * k ** -0.5, torch.randn(m, generator=g) * 0.1,
         torch.randn(m, k, generator=g) * m ** -0.5, torch.randn(k, generator=g) * 0.1)
    w = tuple(t.to(torch.bfloat16 if t.dim() == 2 else f32).to(dev) for t in w)
    for act in ("gelu_exact",) + ((None,) if (k, s) == (768, 257) else ()):
        n = lm.mlp_block.launches
        got = lm.mlp_block(x, *w, eps=1e-6, activation=act)
        assert lm.mlp_block.launches == n + 1
        _close(got, lm.mlp_block_plain(x, *w, eps=1e-6, activation=act))


def test_text_tower_kernel(dev):
    x, w = _x(dev, 77), _weights(dev, layers=2)
    n = tt.text_tower.launches
    got = tt.text_tower(x, *w, heads=HEADS)
    assert tt.text_tower.launches == n + 1
    _close(got, tt.text_tower_plain(x, *w, heads=HEADS))


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("s", [77, 129])
def test_text_tower_kernel_on_both_routes(dev, b, s):
    """The one-launch tower (S <= 128) and the chain (S = 129), told apart
    by the fused QKV + attention kernel's counter, which only the chain
    moves; the second call on the same shape reuses the zeroed counters."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(b, s, K, generator=g).to(torch.bfloat16).to(dev)
    w = _weights(dev, layers=3)
    want = tt.text_tower_plain(x, *w, heads=HEADS)
    for _ in range(2):
        n, nq = tt.text_tower.launches, fa.qkv_attention.launches
        got = tt.text_tower(x, *w, heads=HEADS)
        assert tt.text_tower.launches == n + 1
        assert fa.qkv_attention.launches == nq + 3 * (not tt.text_tower_fused(s, K, HEADS))
        _close(got, want)


def test_text_tower_kernel_at_the_clip_text_widths(dev):
    """K = 512, 8 heads, M = 2048 (the ViT-B text tower) at B = 1: the
    one-launch route, held to the 12-layer bound of chip_smoke.py (2^-4)."""
    g = torch.Generator().manual_seed(6)
    k, heads, m, layers = 512, 8, 2048, 4

    def rnd(*shape, std, dtype=torch.bfloat16):
        return (torch.randn((layers,) + shape, generator=g) * std).to(dtype).to(dev)

    f32 = torch.float32
    w = (rnd(k, 3 * k, std=k ** -0.5), rnd(3 * k, std=0.1, dtype=f32),
         rnd(k, k, std=k ** -0.5), rnd(k, std=0.1, dtype=f32),
         rnd(k, m, std=k ** -0.5), rnd(m, std=0.1, dtype=f32),
         rnd(m, k, std=m ** -0.5), rnd(k, std=0.1, dtype=f32))
    x = torch.randn(1, 77, k, generator=g).to(torch.bfloat16).to(dev)
    assert tt.text_tower_fused(77, k, heads)
    got = tt.text_tower(x, *w, heads=heads)
    want = tt.text_tower_plain(x, *w, heads=heads)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -4 * want.float().abs().max().item(), err


def _q8_weights(dev, layers=None, seed=0):
    """(wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2):
    quantize_weight of random fp32 weights, stacked when ``layers``."""
    g = torch.Generator().manual_seed(seed)

    def one():
        def rnd(*shape, std):
            return torch.randn(shape, generator=g) * std

        out = []
        for shape in ((K, 3 * K), (K, K), (K, M), (M, K)):
            out.append(q8.quantize_weight(rnd(*shape, std=shape[0] ** -0.5)))
            out.append(rnd(shape[1], std=0.1))
        (wq, wsc), b_eff, (woq, wosc), bo, (w1q, w1sc), b1, (w2q, w2sc), b2 = out
        return (wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2)

    if layers is None:
        return tuple(t.contiguous().to(dev) for t in one())
    per_layer = [one() for _ in range(layers)]
    return tuple(torch.stack(t).to(dev) for t in zip(*per_layer))


@pytest.mark.parametrize("s", SEQ)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q8_out", [True, False])
def test_attn_block_q8_kernel(dev, s, causal, q8_out):
    x, w = _x(dev, s), _q8_weights(dev)
    wo_ops = w[3:5] if q8_out else (_weights(dev)[2],)
    n, route = q8.attn_block_q8.launches, _route(q8.qkv_attention_q8,
                                                 q8.qkv_attention_q8.launches)
    got = q8.attn_block_q8(x, *w[:3], wo_ops, w[5], heads=HEADS, causal=causal,
                           q8_out=q8_out)
    assert q8.attn_block_q8.launches == n + 1
    route(s)
    _close(got, q8.attn_block_q8_plain(x, *w[:3], wo_ops, w[5], heads=HEADS,
                                       causal=causal, q8_out=q8_out))


@pytest.mark.parametrize("s", [9, 197, 257, 785])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_q8_integers_within_one_step(dev, s, causal):
    """The attention output's int8 integers (q8_out) against those of the
    plain version on the same inputs, each quantizing the fp32 attention
    output (qkv_attention_q8_plain): the flash core of the fused blocks
    rounds P once, against each row's final max, as attention_plain does,
    so no integer moves by more than one step."""
    x, w = _x(dev, s), _q8_weights(dev)
    wq, wsc, b_eff, woq, wosc, bo = w[:6]
    ints = q8._launch_attn_block_q8(x, wq.t().contiguous(), wsc, b_eff,
                                    (woq.t().contiguous(), wosc), bo, HEADS,
                                    causal, True, 1e-5)[1]
    attn = q8.qkv_attention_q8_plain(x, wq, wsc, b_eff, heads=HEADS, causal=causal)
    want = q8.quantize_rows(attn.reshape(B * s, -1))[0]
    torch.cuda.synchronize()
    diff = (ints[:want.numel()].view_as(want).int() - want.int()).abs()
    assert diff.max().item() <= 1, (s, causal, diff.max().item())


@pytest.mark.parametrize("s", [9, 17, 197])
def test_mlp_block_q8_kernel(dev, s):
    x, w = _x(dev, s), _q8_weights(dev)
    n = q8.mlp_block_q8.launches
    got = q8.mlp_block_q8(x, *w[6:])
    assert q8.mlp_block_q8.launches == n + 1
    _close(got, q8.mlp_block_q8_plain(x, *w[6:]))


@pytest.mark.parametrize("s", [9, 197, 257])
def test_mlp_block_q8_gelu_exact_kernel(dev, s):
    """Row 11 with exact GELU (DINO's int8 MLP half: c_fc's ACTQ_GELU
    pass): the half against its plain version, and its int8 hidden and
    row scales against the plain act quantization of the exact
    pre-activation of the card's own LN-quantized operand, read from the
    scratch (integers within one step on at most 0.1%, scales rtol 1e-6:
    torch's erf on the card may round an ulp off the kernel's)."""
    x, w = _x(dev, s), _q8_weights(dev)
    n = q8.mlp_block_q8.launches
    got = q8.mlp_block_q8(x, *w[6:], eps=1e-6, activation="gelu_exact")
    assert q8.mlp_block_q8.launches == n + 1
    _close(got, q8.mlp_block_q8_plain(x, *w[6:], eps=1e-6, activation="gelu_exact"))
    w1q, w1sc, b1, w2q, w2sc, b2 = w[6:]
    _, hq, hs = q8._launch_mlp_block_q8(x, w1q.t().contiguous(), w1sc, b1,
                                        w2q.t().contiguous(), w2sc, b2, 1e-6,
                                        "gelu_exact")
    rows = B * s
    xq, xs = hq[rows * M:rows * (M + K)].view(rows, K), hs[rows:2 * rows, None]
    want_q, want_s = q8.act_quantize_rows(q8.q8_dot(xq, xs, w1q, w1sc) + b1,
                                          "gelu_exact")
    torch.cuda.synchronize()
    torch.testing.assert_close(hs[:rows], want_s[:, 0], rtol=1e-6, atol=0)
    diff = (hq[:rows * M].view(rows, M).int() - want_q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("rows", [197, 16448, 12545])
def test_q8_gemm_two_pass_act_quantize_gelu_exact(dev, rows):
    """c_fc's ROWMAX then ACTQ with exact GELU at DINOv2-B/14 widths (K =
    768, M = 3072; 16,448 rows = 64 images of 257) against the F32 product
    and the plain act quantization: the test above's tolerances."""
    from uml_tpu_torch.ops import gemm

    a, w, rs, cs, bias, _ = _q8_operands(dev, rows, 768, 3072, 7 * rows)
    rowmax = gemm.q8_gemm(a, w, rs, cs, bias, epi="ROWMAX")
    got_q, got_s = gemm.q8_gemm(a, w, rs, cs, bias, epi="ACTQ", rowmax=rowmax,
                                activation="gelu_exact")
    pre = gemm.q8_gemm(a, w, rs, cs, bias, epi="F32")
    want_q, want_s = q8.act_quantize_rows(pre, "gelu_exact")
    torch.cuda.synchronize()
    assert torch.equal(rowmax, pre.amax(-1))
    torch.testing.assert_close(got_s, want_s[:, 0], rtol=1e-6, atol=0)
    diff = (got_q.int() - want_q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_dino_on_the_card_matches_the_cpu(dev, quant, return_tokens):
    """A DINOv2 encoder batch (the ViT-S/14 widths, K = 384, 6 heads, cut
    to 2 layers, S = 257: the chain) on the card against the same weights
    on the CPU, bf16 and int8: per-row cosine >= 0.999; the launches of the
    layer plan (the last layer CLS-only and bf16 when token-pooled)."""
    import dataclasses

    from uml_tpu_torch.models.dino import DINO_CONFIGS, DinoViT
    from uml_tpu_torch.ops import attention as at

    cfg = dataclasses.replace(DINO_CONFIGS["vit_small_patch14_dinov2.lvd142m"][0],
                              num_layers=2)
    cpu = DinoViT(cfg, torch.bfloat16, quant=quant).init_random(
        torch.Generator().manual_seed(0)).requires_grad_(False)
    gpu = DinoViT(cfg, torch.bfloat16, quant=quant).to(dev).requires_grad_(False)
    gpu.load_state_dict(cpu.state_dict())
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 224 * 224 * 3), dtype=np.uint8))
    counters = (fa.attn_block, fa.attn_block_cls, lm.mlp_block, q8.attn_block_q8,
                q8.mlp_block_q8, at.flash_attention, fa.qkv_attention)
    before = [c.launches for c in counters]
    got = gpu.encode_image_u8(u8.to(dev), return_tokens=return_tokens)
    launched = [c.launches - n for c, n in zip(counters, before)]
    want = cpu.encode_image_u8(u8, return_tokens=return_tokens)
    torch.cuda.synchronize()
    assert got.shape == want.shape == ((4, 257, 384) if return_tokens else (4, 384))
    cls = 0 if return_tokens else 1
    full = 2 - cls
    q = quant == "int8"
    assert launched == [0 if q else full, cls, 2 if not q else cls,
                        full if q else 0, full if q else 0, 2, 0]
    a, b = got.float().cpu().reshape(-1, 384), want.float().reshape(-1, 384)
    cos = ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min().item()
    assert cos >= 0.999, cos


@pytest.mark.parametrize("s", [9, 17, 197])
def test_tower_q8_kernel(dev, s):
    x, w = _x(dev, s), _q8_weights(dev, layers=2)
    n = tq8.tower_q8.launches
    got = tq8.tower_q8(x, *w, heads=HEADS)
    assert tq8.tower_q8.launches == n + 1
    torch.cuda.synchronize()
    want = tq8.tower_q8_plain(x, *w, heads=HEADS)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 2.0 ** -4 * want.float().abs().max().item(), err
    per_layer = x
    for l in range(2):
        per_layer = q8.attn_block_q8(per_layer, w[0][l], w[1][l], w[2][l],
                                     (w[3][l], w[4][l]), w[5][l], heads=HEADS)
        per_layer = q8.mlp_block_q8(per_layer, *(t[l] for t in w[6:]))
    assert torch.equal(got, per_layer)


def test_q8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from uml_tpu_torch.ops import gemm

    x, w = _x(dev, 17), _q8_weights(dev)
    with pytest.raises(TypeError):
        q8.attn_block_q8(x, w[0].float(), *w[1:3], w[3:5], w[5], heads=HEADS)
    with pytest.raises(ValueError):
        q8.mlp_block_q8(x, *w[6:], activation=None)
    with pytest.raises(RuntimeError, match="inference-only"):
        q8.mlp_block_q8(x.float().requires_grad_(), *w[6:])
    # the launchers and q8_gemm read the int8 weights K-major: an [in,
    # out] weight where [out, in] is needed raises
    w1q, w1sc, b1, w2q, w2sc, b2 = w[6:]
    with pytest.raises(ValueError):
        q8._launch_mlp_block_q8(x, w1q, w1sc, b1, w2q.t().contiguous(), w2sc, b2,
                                1e-5)
    with pytest.raises(ValueError):
        q8._launch_attn_block_q8(x, w[0], *w[1:3], (w[3].t().contiguous(), w[4]),
                                 w[5], HEADS, False, True, 1e-5)
    a = torch.zeros((17, K), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        gemm.q8_gemm(a, w1q, torch.ones(17, device=dev), w1sc, b1, epi="F32")


@pytest.mark.parametrize("s", [9, 197])
def test_q8_wrappers_read_a_k_major_view_in_place(dev, s):
    """A [in, out] view of a K-major weight (what the model passes) and a
    row-major [in, out] weight (transposed for the call) give the same
    bits, through the halves and the tower."""
    x, w = _x(dev, s), _q8_weights(dev)

    def view(t):
        return t.t().contiguous().t() if t.dtype == torch.int8 else t

    assert torch.equal(q8.mlp_block_q8(x, *w[6:]),
                       q8.mlp_block_q8(x, *(view(t) for t in w[6:])))
    assert torch.equal(
        q8.attn_block_q8(x, *w[:3], w[3:5], w[5], heads=HEADS),
        q8.attn_block_q8(x, view(w[0]), *w[1:3], (view(w[3]), w[4]), w[5],
                         heads=HEADS))
    ws = _q8_weights(dev, layers=2)
    stacked = tuple(t.transpose(1, 2).contiguous().transpose(1, 2)
                    if t.dtype == torch.int8 else t for t in ws)
    assert torch.equal(tq8.tower_q8(x, *ws, heads=HEADS),
                       tq8.tower_q8(x, *stacked, heads=HEADS))


@pytest.mark.parametrize("quant", ["int8", "int8_mlp", "int8_attn", "int8_qkv"])
def test_tiny_clip_int8_on_the_card_matches_the_cpu(dev, quant):
    """A tiny CLIP in each int8 mode on the card against the same weights
    on the CPU (plain path): per-row cosine >= 0.999."""
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.models.tokenizer import tokenize

    cfg = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=2,
                     vision_width=128, vision_patch_size=16,
                     transformer_width=128, transformer_heads=2,
                     transformer_layers=2)
    cpu = CLIP(cfg, dtype=torch.bfloat16, quant=quant).init_random(
        torch.Generator().manual_seed(0))
    gpu = CLIP(cfg, dtype=torch.bfloat16, quant=quant).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 64 * 64 * 3), dtype=np.uint8))
    toks = torch.from_numpy(tokenize(["a photo of a cat.", "a dog"]).astype(np.int64))
    with torch.no_grad():
        pairs = [(cpu.encode_image_u8(u8), gpu.encode_image_u8(u8.to(dev))),
                 (cpu.encode_text(toks), gpu.encode_text(toks.to(dev)))]
    for a, b in pairs:
        cos = torch.nn.functional.cosine_similarity(a.float(), b.float().cpu(),
                                                    dim=-1)
        assert cos.min().item() >= 0.999


def _close_all(got, want):
    for a, b in zip(got, want):
        _close(a, b)


def _g(dev, shape, seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)


@pytest.mark.parametrize("s", SEQ)
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_stash_kernel(dev, s, causal):
    x, w = _x(dev, s), _weights(dev)
    n, route = fa.attn_block_stash.launches, _route(fa.qkv_attention,
                                                    fa.qkv_attention.launches)
    got = fa.attn_block_stash(x, *w[:4], heads=HEADS, causal=causal)
    assert fa.attn_block_stash.launches == n + 1
    route(s)
    _close_all(got, fa.attn_block_stash_plain(x, *w[:4], heads=HEADS,
                                              causal=causal))


@pytest.mark.parametrize("s", [9, 17, 63, 64, 65, 128, 129, 197, 257, 785])
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


@pytest.mark.parametrize("s", [9, 17, 197, 257, 785])
def test_attn_block_cls_bwd_kernel(dev, s):
    x, w = _x(dev, s), _weights(dev)
    _, qkv, _ = fa.attn_block_stash_plain(x, *w[:4], heads=HEADS, q_rows=1)
    g = _g(dev, (B, 1, K))
    n = fa.attn_block_cls_bwd.launches
    got = fa.attn_block_cls_bwd(x, g, qkv, w[0], w[2], heads=HEADS)
    assert fa.attn_block_cls_bwd.launches == n + 1
    _close_all(got, fa.attn_block_cls_bwd_plain(x, g, qkv, w[0], w[2],
                                                heads=HEADS))
    _close_all(got, fa.attn_block_cls_bwd_factored_plain(x, g, qkv, w[0], w[2],
                                                         heads=HEADS))


@pytest.mark.parametrize("s", [9, 63, 64, 65, 128, 129, 197])
def test_mlp_block_stash_kernel(dev, s):
    """#9, and its out equals mlp_block's (#3) bit for bit: the two share
    their launches, the stash aside."""
    x, w = _x(dev, s), _weights(dev)
    n = lm.mlp_block_stash.launches
    got = lm.mlp_block_stash(x, *w[4:])
    assert lm.mlp_block_stash.launches == n + 1
    _close_all(got, lm.mlp_block_stash_plain(x, *w[4:]))
    assert torch.equal(got[0], lm.mlp_block(x, *w[4:]))


@pytest.mark.parametrize("s", sorted(set(SEQ + [785])))
@pytest.mark.parametrize("causal", [False, True])
def test_attn_block_bwd_recompute_kernel(dev, s, causal):
    """#7, and its recompute equals the forward kernels' qkv and attention
    output bit for bit."""
    x, w = _x(dev, s), _weights(dev)
    g = _g(dev, x.shape)
    n, route = fa.attn_block_bwd_recompute.launches, _route(fa.qkv_attention,
                                                            fa.qkv_attention.launches)
    got = fa.attn_block_bwd_recompute(x, g, *w[:3], heads=HEADS, causal=causal)
    assert fa.attn_block_bwd_recompute.launches == n + 1
    route(s)
    _close_all(got, fa.attn_block_bwd_recompute_plain(x, g, *w[:3], heads=HEADS,
                                                      causal=causal))
    _, qkv, attn = fa.attn_block_stash(x, *w[:4], heads=HEADS, causal=causal)
    assert torch.equal(got[3], attn)
    stash_bwd = fa.attn_block_bwd(x, g, qkv, w[0], w[2], heads=HEADS, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], stash_bwd))


@pytest.mark.parametrize("s", [9, 17, 63, 64, 65, 128, 129, 197, 785])
@pytest.mark.parametrize("causal", [False, True])
def test_attn_bwd_passes_kernel(dev, s, causal):
    """The attention backward's dq pass (dq and the statistics (m, 1/l,
    D), fp32 within 1e-3 of their largest entry: summation order only) and
    its dkv pass from the plain statistics, each on its own; both passes
    give the same bits on a second call."""
    x, w = _x(dev, s), _weights(dev)
    _, qkv, _ = fa.attn_block_stash_plain(x, *w[:4], heads=HEADS, causal=causal)
    dattn = _g(dev, (B, s, HEADS * 64))
    n = fa.attn_bwd.launches
    dq, st = fa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal)
    assert fa.attn_bwd.launches == n + 1
    want_dq, want_st = fa.attn_bwd_plain(qkv, dattn, heads=HEADS, causal=causal)
    _close(dq, want_dq)
    err = (st - want_st).abs().max().item()
    assert err <= 1e-3 * want_st.abs().max().item(), err
    got = fa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal, stats=want_st)
    _close_all(got, fa.attn_bwd_plain(qkv, dattn, heads=HEADS, causal=causal,
                                      stats=want_st))
    again = fa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal, stats=want_st)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(dq, fa.attn_bwd(qkv, dattn, heads=HEADS, causal=causal)[0])


@pytest.mark.parametrize("s", [9, 17, 197])
def test_mlp_bwd_kernel(dev, s):
    """#19 at B*S rows that are not a multiple of 64."""
    x, w = _x(dev, s), _weights(dev)
    dy = _g(dev, (B, s, M))
    n = lm.mlp_bwd.launches
    got = lm.mlp_bwd(x, dy, w[5], w[4])
    assert lm.mlp_bwd.launches == n + 1
    _close_all(got, lm.mlp_bwd_plain(x, dy, w[5], w[4]))


@pytest.mark.parametrize("s", [9, 17, 197, 257, 785])
def test_mlp_bwd_dw_kernel(dev, s):
    """#20 at B*S rows that are not a multiple of 64 (nor of 32)."""
    x, w = _x(dev, s), _weights(dev)
    g = _g(dev, x.shape)
    n = lm.mlp_bwd_dw.launches
    got = lm.mlp_bwd_dw(x, g, w[5], w[4], w[6])
    assert lm.mlp_bwd_dw.launches == n + 1
    want = lm.mlp_bwd_dw_plain(x, g, w[5], w[4], w[6])
    _close_all(got, want)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 3


# DINO's training rows with exact GELU and eps 1e-6 (9 the stash forward,
# 19 and 20 the recompute backwards) at S = 9, 17 and DINOv2's 257
@pytest.mark.parametrize("s", [9, 17, 257])
def test_mlp_gelu_exact_training_kernels(dev, s):
    """Rows 9, 19 and 20 with exact GELU against their plain versions;
    row 9's out equals row 3's (mlp_block with exact GELU) bit for bit,
    and the quick_gelu default of each wrapper still runs its own
    instance (a different result on the same inputs)."""
    x, w = _x(dev, s), _weights(dev)
    g, dy = _g(dev, x.shape), _g(dev, (B, s, M))
    gelu = dict(eps=1e-6, activation="gelu_exact")
    n = (lm.mlp_block_stash.launches, lm.mlp_bwd.launches, lm.mlp_bwd_dw.launches)
    stash = lm.mlp_block_stash(x, *w[4:], **gelu)
    bwd = lm.mlp_bwd(x, dy, w[5], w[4], **gelu)
    bwd_dw = lm.mlp_bwd_dw(x, g, w[5], w[4], w[6], **gelu)
    assert (lm.mlp_block_stash.launches, lm.mlp_bwd.launches,
            lm.mlp_bwd_dw.launches) == tuple(c + 1 for c in n)
    _close_all(stash, lm.mlp_block_stash_plain(x, *w[4:], **gelu))
    _close_all(bwd, lm.mlp_bwd_plain(x, dy, w[5], w[4], **gelu))
    _close_all(bwd_dw, lm.mlp_bwd_dw_plain(x, g, w[5], w[4], w[6], **gelu))
    assert torch.equal(stash[0], lm.mlp_block(x, *w[4:], **gelu))
    assert not torch.equal(bwd[2], lm.mlp_bwd(x, dy, w[5], w[4], eps=1e-6)[2])


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
    with pytest.raises(ValueError):     # a stash of another S
        fa.attn_block_bwd(_x(dev, 300), _x(dev, 300), qkv, w[0], w[2],
                          heads=HEADS)
    with pytest.raises(ValueError):     # K not a multiple of 64
        fa.attn_block_bwd_recompute(_g(dev, (B, 300, 96)), _g(dev, (B, 300, 96)),
                                    _g(dev, (96, 3 * HEADS * 64)), w[1],
                                    _g(dev, (HEADS * 64, 96)), heads=HEADS)
    with pytest.raises(TypeError):
        fa.attn_block_bwd_recompute(x, x, w[0], w[1].bfloat16(), w[2], heads=HEADS)
    with pytest.raises(TypeError):
        lm.mlp_bwd(x, _g(dev, (B, 17, M)).float(), w[5], w[4])
    with pytest.raises(ValueError):
        lm.mlp_bwd_dw(x, x[:, :1].contiguous(), w[5], w[4], w[6])


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


# -- the stand-alone ops: ln_matmul, add_ln_matmul, ln_qkv_attention,
#    layer_norm, flash_attention ----------------------------------------------

def _ln_params(dev, k, seed=3):
    g = torch.Generator().manual_seed(seed)
    return ((1 + 0.1 * torch.randn(k, generator=g)).to(dev),
            (0.1 * torch.randn(k, generator=g)).to(dev))


# rows 14-17 on the engine: the row counts on both sides of its 128-row
# tile (1, 127, 129, 4 x 197) and the towers' widths (K, N): the test
# width, the text QKV and c_fc, the ViT-B/16 QKV and c_fc
LN_LEAD = [(37,), (1,), (127,), (129,), (B, 17), (B, 197), (4, 197)]
LN_WIDTHS = [(K, M), (512, 1536), (512, 2048), (768, 2304), (768, 3072)]


def _ln_operands(dev, lead, k, n, seed):
    """x [*lead, k], delta like x, the LN (scale, bias) [k] fp32, w [k, n]
    bf16, b [n] fp32."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * std).to(dtype).to(dev)

    f32 = torch.float32
    return (rnd(*lead, k), rnd(*lead, k), 1 + rnd(k, std=0.1, dtype=f32),
            rnd(k, std=0.1, dtype=f32), rnd(k, n, std=k ** -0.5),
            rnd(n, std=0.1, dtype=f32))


@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu_exact"])
@pytest.mark.parametrize("kn", LN_WIDTHS)
@pytest.mark.parametrize("lead", LN_LEAD)
def test_ln_matmul_kernel(dev, lead, kn, act):
    """2-d and 3-d x through one entry, rows not a multiple of the 128-row
    tile; a 4-d x is rows all the same."""
    k, n = kn
    x, _, scale, bias, w, b = _ln_operands(dev, lead, k, n, seed=4 + len(lead))
    c = lm.ln_matmul.launches
    got = lm.ln_matmul(x, scale, bias, w, b, activation=act)
    assert lm.ln_matmul.launches == c + 1
    assert got.shape == (*lead, n)
    _close(got, lm.ln_matmul_plain(x, scale, bias, w, b, activation=act))
    assert torch.equal(got, lm.ln_matmul(x, scale, bias, w, b, activation=act,
                                         impl="pallas"))
    x4 = x.reshape(1, 1, -1, k)
    assert torch.equal(got.reshape(1, 1, -1, n),
                       lm.ln_matmul(x4, scale, bias, w, b, activation=act))
    assert lm.ln_matmul.launches == c + 3


@pytest.mark.parametrize("act", [None, "quick_gelu", "gelu_exact"])
@pytest.mark.parametrize("kn", LN_WIDTHS)
@pytest.mark.parametrize("lead", LN_LEAD)
def test_add_ln_matmul_kernel(dev, lead, kn, act):
    k, n = kn
    x, delta, scale, bias, w, b = _ln_operands(dev, lead, k, n, seed=5 + len(lead))
    c = lm.add_ln_matmul.launches
    t, out = lm.add_ln_matmul(x, delta, scale, bias, w, b, activation=act)
    assert lm.add_ln_matmul.launches == c + 1
    t_want, out_want = lm.add_ln_matmul_plain(x, delta, scale, bias, w, b,
                                              activation=act)
    torch.cuda.synchronize()
    # t is one bf16 rounding of the same fp32 sum: bit for bit
    assert torch.equal(t, t_want)
    assert torch.equal(t, (x.float() + delta.float()).to(torch.bfloat16))
    _close(out, out_want)


@pytest.mark.parametrize("bs", [(3, 9), (3, 17), (3, 197), (4, 197), (1, 1),
                                (1, 127), (1, 129)])
@pytest.mark.parametrize("kh", [(K, HEADS), (512, 8), (768, 12)])
@pytest.mark.parametrize("causal", [False, True])
def test_ln_qkv_attention_kernel(dev, bs, kh, causal):
    (b, s), (k, heads) = bs, kh
    x, _, scale, bias, w, wb = _ln_operands(dev, (b, s), k, 3 * heads * 64, seed=s)
    c = fa.ln_qkv_attention.launches
    got = fa.ln_qkv_attention(x, scale, bias, w, wb, heads=heads, causal=causal)
    assert fa.ln_qkv_attention.launches == c + 1
    _close(got, fa.ln_qkv_attention_plain(x, scale, bias, w, wb, heads=heads,
                                          causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(5, 96), (B, 197, K), (3, 2, 7, 1024),
                                   (9, 2056), (12609, 768), (1057, 2048),
                                   (2113, 8), (40000, 16)])
def test_layer_norm_kernel(dev, shape, dtype):
    """Rows kept in registers (K <= 2048) and re-read (K = 2056); row
    counts from 5 to 40,000, not a multiple of the 4-row block; fp32
    within 1e-5 of the largest output, bf16 within one rounding."""
    from uml_tpu_torch.ops import layer_norm as layer_norm_op
    from uml_tpu_torch.ops.layer_norm import layer_norm_plain

    g = torch.Generator().manual_seed(6)
    x = (3 + 2 * torch.randn(shape, generator=g)).to(dtype).to(dev)
    scale, bias = _ln_params(dev, shape[-1])
    n = layer_norm_op.launches
    got = layer_norm_op(x, scale, bias)
    assert layer_norm_op.launches == n + 1
    assert got.dtype == dtype and got.shape == tuple(shape)
    want = layer_norm_plain(x, scale, bias)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("s", [1, 9, 17, 63, 64, 65, 129, 197, 1030, 2048])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_kernel(dev, s, d, causal):
    """Any S (a ragged last key tile, padded query rows, one query tile or
    many), both head dims."""
    from uml_tpu_torch.ops import attention as at

    q, k, v = (_g(dev, (2, 3, s, d), seed=7 + i) for i in range(3))
    n = at.flash_attention.launches
    got = at.flash_attention(q, k, v, causal=causal)
    assert at.flash_attention.launches == n + 1
    _close(got, at.attention_plain(q, k, v, causal=causal))
    _close(got, at.mha_plain(q, k, v, causal=causal))
    # multi_head_attention: the kernel from S = 1024 up under "auto"
    auto = at.multi_head_attention(q, k, v, causal=causal)
    assert at.flash_attention.launches == n + 1 + (s >= at.FLASH_MIN_SEQ)
    _close(auto, got)


@pytest.mark.parametrize("s", [1, 65, 197])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_strided_reads_packed_qkv_in_place(dev, s, d, causal):
    """q, k, v as views of a packed [B, S, 3, H, D] qkv, the output written
    into a [B, S, H, D] buffer: bit for bit the contiguous call's result."""
    from uml_tpu_torch.ops import attention as at

    heads = 3
    qkv = _g(dev, (2, s, 3, heads, d), seed=11)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    attn = torch.full((2, s, heads, d), float("nan"), dtype=torch.bfloat16,
                      device=dev)
    n = at.flash_attention.launches
    got = at._flash_attention_strided(q, k, v, causal=causal,
                                      out=attn.transpose(1, 2))
    assert at.flash_attention.launches == n + 1
    assert got.data_ptr() == attn.data_ptr()
    want = at.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(attn.transpose(1, 2), want)
    _close(want, at.attention_plain(q, k, v, causal=causal))
    with pytest.raises(ValueError):     # the last axis strided
        at._flash_attention_strided(*(_g(dev, (1, 1, 9, 128))[..., ::2]
                                      for _ in range(3)))


def test_stand_alone_ops_raise_on_what_the_kernels_do_not_take(dev):
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import layer_norm as layer_norm_op

    x, w = _x(dev, 17), _weights(dev)
    scale, bias = _ln_params(dev, K)
    with pytest.raises(TypeError):      # "pallas" with an fp32 tensor
        lm.ln_matmul(x.float(), scale, bias, w[4].float(), w[5], impl="pallas")
    with pytest.raises(ValueError):     # K not a multiple of 64, "pallas"
        fa.ln_qkv_attention(_g(dev, (B, 401, 96)), *_ln_params(dev, 96),
                            _g(dev, (96, 3 * HEADS * 64)), w[1], heads=HEADS,
                            impl="pallas")
    with pytest.raises(ValueError):     # head dim 96
        at.flash_attention(*(_g(dev, (1, 1, 9, 96)) for _ in range(3)))
    with pytest.raises(ValueError):     # K not a multiple of 8
        layer_norm_op(_g(dev, (4, 100)), *_ln_params(dev, 100), impl="pallas")


def test_auto_raises_on_the_card_where_the_kernel_does_not_take_the_input(dev):
    """Under the default impl="auto" a tensor on the card launches the
    kernel or raises: it never takes the plain version unasked.  Only an
    explicit impl="reference" runs the plain version there."""
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import layer_norm as layer_norm_op

    x, w = _x(dev, 17), _weights(dev)
    scale, bias = _ln_params(dev, K)
    ops = (lm.ln_matmul, lm.add_ln_matmul, fa.ln_qkv_attention, layer_norm_op,
           at.flash_attention)
    before = [op.launches for op in ops]
    with pytest.raises(TypeError):      # fp32
        lm.ln_matmul(x.float(), scale, bias, w[4].float(), w[5])
    with pytest.raises(TypeError):
        lm.add_ln_matmul(x.float(), x.float(), scale, bias, w[4].float(), w[5])
    with pytest.raises(ValueError):
        fa.ln_qkv_attention(x.float(), scale, bias, w[0].float(), w[1],
                            heads=HEADS)
    with pytest.raises(ValueError):     # K, M not multiples of 64
        lm.ln_matmul(_g(dev, (B, 17, 96)), *_ln_params(dev, 96),
                     _g(dev, (96, 128)), torch.zeros(128, device=dev))
    with pytest.raises(ValueError):
        lm.add_ln_matmul(x, x, scale, bias, _g(dev, (K, 100)),
                         torch.zeros(100, device=dev))
    with pytest.raises(ValueError):     # K not a multiple of 64
        fa.ln_qkv_attention(_g(dev, (B, 401, 96)), *_ln_params(dev, 96),
                            _g(dev, (96, 3 * HEADS * 64)), w[1], heads=HEADS)
    with pytest.raises(ValueError):     # x not [B, S, K]
        fa.ln_qkv_attention(x[0], scale, bias, w[0], w[1], heads=HEADS)
    with pytest.raises(ValueError):     # K not a multiple of 8; fp16
        layer_norm_op(_g(dev, (4, 100)), *_ln_params(dev, 100))
    with pytest.raises(ValueError):
        layer_norm_op(x.half(), scale, bias)
    q32 = _g(dev, (1, 1, at.FLASH_MIN_SEQ, 64)).float()
    with pytest.raises(ValueError):     # fp32 from S = 1024 up
        at.multi_head_attention(q32, q32, q32)
    assert [op.launches for op in ops] == before
    # the explicit request for the plain version
    got = lm.ln_matmul(x.float(), scale, bias, w[4].float(), w[5],
                       impl="reference")
    assert got.dtype == torch.float32 and got.is_cuda
    assert [op.launches for op in ops] == before


@pytest.mark.parametrize("attn_impl", ["reference", "pallas", "dense_bshd"])
def test_tiny_non_fused_clip_on_the_card_matches_the_cpu(dev, attn_impl):
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.models.tokenizer import tokenize

    cfg = ClipConfig(embed_dim=64, image_resolution=64, vision_layers=2,
                     vision_width=128, vision_patch_size=16,
                     transformer_width=128, transformer_heads=2,
                     transformer_layers=2)
    cpu = CLIP(cfg, dtype=torch.bfloat16, attn_impl=attn_impl).init_random(
        torch.Generator().manual_seed(0))
    gpu = CLIP(cfg, dtype=torch.bfloat16, attn_impl=attn_impl).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    u8 = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (4, 64 * 64 * 3), dtype=np.uint8))
    toks = torch.from_numpy(tokenize(["a photo of a cat.", "a dog"]).astype(np.int64))
    n = lm.ln_matmul.launches, lm.add_ln_matmul.launches
    with torch.no_grad():
        pairs = [(cpu.encode_image_u8(u8), gpu.encode_image_u8(u8.to(dev))),
                 (cpu.encode_text(toks), gpu.encode_text(toks.to(dev)))]
    assert (lm.ln_matmul.launches, lm.add_ln_matmul.launches) == (n[0] + 4,
                                                                  n[1] + 4)
    for a, b in pairs:
        cos = torch.nn.functional.cosine_similarity(a.float(), b.float().cpu(),
                                                    dim=-1)
        assert cos.min().item() >= 0.999


# the wgmma engine's products on their own (ops/gemm.py), at ragged row
# counts and both towers' widths (ViT-B/16 K=768, the text tower K=512),
# against fp32 products of the same bf16 operands: a bf16 output within
# REL of its largest entry; an fp32 output (summation order only, and an
# LN'd operand that may round to the neighbouring bf16 value) within 1e-3
GEMM_ROWS = [9, 17 * 64, 12608]
GEMM_F32_REL = 1e-3


def _triple_operands(dev, triple, rows, k):
    """a, w, bias, res of one triple as the layer launches it: QKV x [rows,
    K] . W_eff [K, 3K]; TRANS_B g . wo^T; TRANS_B_F32 dqkv [rows, 3K] .
    W_eff^T; DACT_F32 x . w1 [K, 4K] with an fp32 dy; QUICK_GELU and
    GELU_STASH x . w1 (the MLP in); RESIDUAL hidden [rows, 4K] . w2 [4K,
    K] + x (the MLP out); DACT x . w1 with a bf16 dy (row 19); the
    exact-GELU twins GELU_EXACT_STASH, DACT_EXACT and DACT_F32_EXACT
    (DINO's rows 9, 19 and 20) as their quick_gelu triples."""
    g = torch.Generator().manual_seed(rows + k)
    triple = triple.replace("GELU_EXACT_STASH", "GELU_STASH").replace("_EXACT", "")

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * std).to(dtype).to(dev)

    wide = triple in ("DACT", "DACT_F32", "QUICK_GELU", "GELU_STASH")
    bias = rnd(4 * k if wide else 3 * k, std=0.1, dtype=torch.float32)
    if triple == "QKV":
        return rnd(rows, k), rnd(k, 3 * k, std=k ** -0.5), bias, None
    if triple in ("QUICK_GELU", "GELU_STASH"):
        return rnd(rows, k), rnd(k, 4 * k, std=k ** -0.5), bias, None
    if triple == "RESIDUAL":
        return (rnd(rows, 4 * k), rnd(4 * k, k, std=(4 * k) ** -0.5),
                bias[:k], rnd(rows, k))
    if triple == "TRANS_B":
        return rnd(rows, k), rnd(k, k, std=k ** -0.5), None, None
    if triple == "TRANS_B_F32":
        return rnd(rows, 3 * k), rnd(k, 3 * k, std=k ** -0.5), None, None
    return (rnd(rows, k), rnd(k, 4 * k, std=k ** -0.5), bias,
            rnd(rows, 4 * k, dtype=torch.float32 if triple == "DACT_F32"
                else torch.bfloat16))


@pytest.mark.parametrize("k", [768, 512])
@pytest.mark.parametrize("rows", GEMM_ROWS)
@pytest.mark.parametrize("triple", ["QKV", "TRANS_B", "TRANS_B_F32", "DACT", "DACT_F32",
                                    "QUICK_GELU", "GELU_STASH", "RESIDUAL",
                                    "GELU_EXACT_STASH", "DACT_EXACT", "DACT_F32_EXACT"])
def test_engine_triple_kernel(dev, triple, rows, k):
    from uml_tpu_torch.ops import gemm

    ops = _triple_operands(dev, triple, rows, k)
    n = gemm.ln_gemm.launches
    got = gemm.ln_gemm(*ops, triple=triple)
    assert gemm.ln_gemm.launches == n + 1
    want = gemm.ln_gemm_plain(*ops, triple=triple)
    torch.cuda.synchronize()
    for a, b in zip(*((t if isinstance(t, tuple) else (t,)) for t in (got, want))):
        assert a.shape == b.shape and a.dtype == b.dtype
        rel = REL if a.dtype == torch.bfloat16 else GEMM_F32_REL
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * b.float().abs().max().item(), (triple, err)


@pytest.mark.parametrize("k", [768, 512])
@pytest.mark.parametrize("rows", GEMM_ROWS)
@pytest.mark.parametrize("triple", ["AFFINE", "AFFINE_QUICK_GELU", "AFFINE_GELU_EXACT",
                                    "ADD", "ADD_QUICK_GELU", "ADD_GELU_EXACT"])
def test_affine_engine_triple_kernel(dev, triple, rows, k):
    """Rows 14-17's triples on their own: the affine or add LN pre-pass,
    then the engine with the bias and the activation (the c_fc width);
    the add triples' t bit for bit."""
    from uml_tpu_torch.ops import gemm

    x, delta, scale, bias, w, b = _ln_operands(dev, (rows,), k, 4 * k, seed=rows + k)
    kw = {"ln": (scale, bias), "delta": delta if triple.startswith("ADD") else None}
    n = gemm.ln_gemm.launches
    got = gemm.ln_gemm(x, w, b, triple=triple, **kw)
    assert gemm.ln_gemm.launches == n + 1
    want = gemm.ln_gemm_plain(x, w, b, triple=triple, **kw)
    torch.cuda.synchronize()
    if triple.startswith("ADD"):
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    _close(got, want)


@pytest.mark.parametrize("pn", [(768, 3072), (3072, 768), (512, 2048)])
@pytest.mark.parametrize("rows", GEMM_ROWS)
def test_gemm_at_kernel(dev, rows, pn):
    """A^T B over every row, split into chunks that add in a fixed order:
    two calls give the same bits."""
    from uml_tpu_torch.ops import gemm

    p, n = pn
    a, b = _g(dev, (rows, p), seed=5), _g(dev, (rows, n), seed=6)
    got = gemm.gemm_at(a, b)
    want = gemm.gemm_at_plain(a, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert torch.equal(got, gemm.gemm_at(a, b))


@pytest.mark.parametrize("splits", range(1, 9))
def test_gemm_at_kernel_row_chunks(dev, splits):
    """Each row-chunk count at row 20's shape: chunk 0 into C, the others
    into the workspace, added in chunk order: within the bound, and the
    same bits on a second call."""
    from uml_tpu_torch.ops import gemm

    a, b = _g(dev, (12608, 768), seed=5), _g(dev, (12608, 3072), seed=6)
    got = gemm.gemm_at(a, b, splits=splits)
    want = gemm.gemm_at_plain(a, b)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), (splits, err)
    assert torch.equal(got, gemm.gemm_at(a, b, splits=splits))


def test_engine_refuses_what_it_does_not_take(dev):
    from uml_tpu_torch.ops import gemm

    a = _g(dev, (17, 128))
    with pytest.raises(ValueError):     # N not a multiple of 64
        gemm.ln_gemm(a, _g(dev, (128, 96)), triple="QKV")
    with pytest.raises(TypeError):      # fp32 operands
        gemm.ln_gemm(a.float(), _g(dev, (128, 128)).float(), triple="TRANS_B")
    with pytest.raises(ValueError):     # P not a multiple of 64
        gemm.gemm_at(_g(dev, (17, 96)), a)


# the int8 GEMM (ops/gemm.py::q8_gemm, wgmma s8 + TMA) at ragged row counts
# and (K, N) of every int8 product: ViT-B/16 QKV, out-projection, c_fc,
# c_proj, and the text tower's
Q8_ROWS = [17, 77 * 4, 12608]
Q8_WIDTHS = [(768, 2304), (768, 768), (768, 3072), (3072, 768),
             (512, 1536), (512, 512), (512, 2048), (2048, 512)]


def _q8_operands(dev, rows, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    rs = torch.rand(rows, generator=g) * 0.02 + 1e-3
    cs = torch.rand(n, generator=g) * 0.02 + 1e-3
    bias = torch.randn(n, generator=g) * 0.1
    res = torch.randn(rows, n, generator=g).to(torch.bfloat16)
    return tuple(t.to(dev) for t in (a, w, rs, cs, bias, res))


@pytest.mark.parametrize("kn", Q8_WIDTHS)
@pytest.mark.parametrize("rows", Q8_ROWS)
def test_q8_gemm_equals_int_mm(dev, rows, kn):
    """Unit scales and a zero bias (Q8_EPI_F32): the output is the exact
    integer sum as fp32, torch._int_mm's bit for bit."""
    from uml_tpu_torch.ops import gemm

    k, n = kn
    a, w, *_ = _q8_operands(dev, rows, k, n, rows + k + n)
    n0 = gemm.q8_gemm.launches
    got = gemm.q8_gemm(a, w, torch.ones(rows, device=dev), torch.ones(n, device=dev),
                       torch.zeros(n, device=dev), epi="F32")
    assert gemm.q8_gemm.launches == n0 + 1
    want = torch._int_mm(a, w.t().contiguous()).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# c_fc's two passes: one image's rows, ViT-B/16 B = 64 and a count that
# ends inside a 128-row tile; the c_fc widths (K, M) of both towers and a
# last column tile of 64 (M = 192)
@pytest.mark.parametrize("km", [(768, 3072), (512, 2048), (128, 192)])
@pytest.mark.parametrize("rows", [197, 12608, 12545])
def test_q8_gemm_two_pass_act_quantize_matches_one_pass(dev, rows, km):
    """c_fc's ROWMAX then ACTQ (the int8 MLP in without an fp32
    pre-activation) against the one-pass composition on the card: the F32
    product, then quant.act_quantize_rows of it.  The s32 sum is exact and
    a max does not depend on its order: the row maxima equal the F32
    product's bit for bit.  torch's quick_gelu on the card can differ from
    the kernel's (quantize.cuh's one-pass act pass rounded as the kernel
    does; tools/exp_torch_q8_mlp.py holds the hidden and its scales to the
    one-pass kernel's bit for bit at ViT-B/16 B = 64) by an ulp: the scales
    within rtol 1e-6, the integers equal except one step on at most 0.1%
    of them, test_torch_quant.py's row-quantizer tolerance."""
    from uml_tpu_torch.ops import gemm

    k, m = km
    a, w, rs, cs, bias, _ = _q8_operands(dev, rows, k, m, 11 * rows + m)
    n0 = gemm.q8_gemm.launches
    rowmax = gemm.q8_gemm(a, w, rs, cs, bias, epi="ROWMAX")
    got_q, got_s = gemm.q8_gemm(a, w, rs, cs, bias, epi="ACTQ", rowmax=rowmax)
    assert gemm.q8_gemm.launches == n0 + 2
    pre = gemm.q8_gemm(a, w, rs, cs, bias, epi="F32")
    want_q, want_s = q8.act_quantize_rows(pre, "quick_gelu")
    torch.cuda.synchronize()
    assert torch.equal(rowmax, pre.amax(-1))
    torch.testing.assert_close(got_s, want_s[:, 0], rtol=1e-6, atol=0)
    assert got_q.dtype == torch.int8
    diff = (got_q.int() - want_q.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).float().mean().item() <= 1e-3


@pytest.mark.parametrize("kn", [(768, 3072), (3072, 768), (512, 1536)])
@pytest.mark.parametrize("rows", Q8_ROWS)
@pytest.mark.parametrize("epi", ["BF16", "F32", "RESIDUAL"])
def test_q8_gemm_epilogues_bit_for_bit(dev, epi, rows, kn):
    from uml_tpu_torch.ops import gemm

    k, n = kn
    a, w, rs, cs, bias, res = _q8_operands(dev, rows, k, n, 7 * rows + k)
    got = gemm.q8_gemm(a, w, rs, cs, bias, res, epi=epi)
    want = gemm.q8_gemm_plain(a, w, rs, cs, bias, res, epi=epi)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_kernels_raise_at_head_dim_32(dev):
    """F8: the wrappers refuse head dim 32 (hidden 64, 2 heads) on a CUDA
    tensor before any launch; the plain versions take it
    (tests/test_torch_head_dim.py)."""
    k, heads, b, s = 64, 2, 2, 9
    g = torch.Generator().manual_seed(6)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g).to(dtype).to(dev)

    x, grad = rnd(b, s, k), rnd(b, s, k)
    w_eff, b_eff = rnd(k, 3 * k), rnd(3 * k, dtype=torch.float32)
    wo, bo = rnd(k, k), rnd(k, dtype=torch.float32)
    qkv = rnd(b, s, 3 * k)
    stacked = [rnd(2, k, 3 * k), rnd(2, 3 * k, dtype=torch.float32), rnd(2, k, k),
               rnd(2, k, dtype=torch.float32), rnd(2, k, 4 * k),
               rnd(2, 4 * k, dtype=torch.float32), rnd(2, 4 * k, k),
               rnd(2, k, dtype=torch.float32)]
    calls = [
        lambda: fa.attn_block(x, w_eff, b_eff, wo, bo, heads=heads),
        lambda: fa.attn_block_cls(x, w_eff, b_eff, wo, bo, heads=heads),
        lambda: fa.attn_block_stash(x, w_eff, b_eff, wo, bo, heads=heads),
        lambda: fa.attn_block_bwd(x, grad, qkv, w_eff, wo, heads=heads),
        lambda: fa.attn_block_bwd_recompute(x, grad, w_eff, b_eff, wo, heads=heads),
        lambda: fa.qkv_attention(x, w_eff, b_eff, heads=heads),
        lambda: fa.attn_bwd(qkv, qkv[..., :k].contiguous(), heads=heads),
        lambda: tt.text_tower(x, *stacked, heads=heads),
        lambda: q8.ln_attn_block_q8(x, torch.ones(k, device=dev),
                                    torch.zeros(k, device=dev), w_eff.float(),
                                    b_eff, wo, bo, heads=heads),
    ]
    for call in calls:
        with pytest.raises(ValueError, match="head dim"):
            call()


def test_pinned_ring_and_copy_stream(dev, tmp_path, monkeypatch):
    """The features loop's staging on the card: four reused pinned buffers
    on a copy stream of their own, the forward waiting for each copy, the
    copy back into pinned memory; the pipelined loop (threads and the
    spawn pool) equals a synchronous per-batch encode bit for bit."""
    from PIL import Image

    from uml_tpu_torch.cli import features
    from uml_tpu_torch.data import loader
    from uml_tpu_torch.models import encoders
    from uml_tpu_torch.models.clip import CLIP, ClipConfig

    weights = tmp_path / "weights"
    weights.mkdir()
    tiny = ClipConfig(embed_dim=64, image_resolution=224, vision_layers=2,
                      vision_width=128, vision_patch_size=32,
                      transformer_width=128, transformer_heads=2,
                      transformer_layers=1)
    torch.save(CLIP(tiny).init_random(torch.Generator().manual_seed(4)).state_dict(),
               str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    enc = encoders.ClipEncoder("ViT-B/32", device="cuda")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (5, 224, 224, 3), dtype=np.uint8)
               for _ in range(9)]
    staged = [enc.stage_images(u8) for u8 in batches]
    assert len({buf.data_ptr() for buf in enc._ring.buffers}) == 4
    assert all(st.copied is not None for st, _ in staged)
    for u8, (st, n) in zip(batches, staged):
        out = enc.encode_staged(st, n)[0]
        assert torch.equal(st.pixels.cpu(), torch.from_numpy(u8.reshape(5, -1)))
        with torch.no_grad():
            want = enc.model.encode_image_u8(torch.from_numpy(u8.reshape(5, -1)).to(dev))
        assert torch.equal(out, want)
    pending = [encoders.PendingOutput(*enc.encode_staged(*enc.stage_images(u8)))
               for u8 in batches]
    for u8, p in zip(batches, pending):
        assert p.host.is_pinned()
        np.testing.assert_array_equal(p.result(), enc.encode_images(u8))

    items = []
    for i in range(10):
        path = tmp_path / f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (150 + i, 200, 3), dtype=np.uint8)
                        ).save(path)
        items.append({"impath": str(path), "label": i % 3})
    want = np.concatenate([enc.encode_images(u8) for u8, _, _ in
                           loader.ImageBatchLoader(items, "crop", 4, num_workers=2)])
    try:
        for kind in ("thread", "process"):
            monkeypatch.setenv("UML_DECODE_WORKERS", kind)
            got = features.image_features(enc, items, "crop", 4, 2)
            np.testing.assert_array_equal(got["features"], want)
    finally:
        loader.shutdown_proc_pools()
