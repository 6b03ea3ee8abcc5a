"""The Python side of the attention halves' route on the card, on the CPU.

For S <= 256 the halves run their QKV product and attention as one kernel
(csrc/qkv_attention.cu) that keeps q, k and v in shared memory; above it,
the chain of the QKV product into a qkv scratch and flash_attention.cu.
csrc/blocks.cuh takes the route by shape; the wrappers mirror it to size
their scratch: on the fused route the inference halves pass no qkv buffer
(NULL) and allocate none, the training stash and the recompute backward
pass one.  Here the launchers run on CPU tensors with the C call replaced
by a recorder, so what each would hand the card is visible without one.
"""

import contextlib
import os
import re

import pytest
import torch

from uml_tpu_torch.ops import _build
from uml_tpu_torch.ops import fused_attention as fa
from uml_tpu_torch.ops import quant as q8

K, HEADS, B = 128, 2, 2
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "uml_tpu_torch", "csrc")


@pytest.mark.parametrize("s", [1, 9, 50, 64, 65, 77, 128, 129, 197, 256, 257, 785])
def test_the_fused_route_takes_s_up_to_256(s):
    assert fa.qkv_attention_fused(s) == (s <= 256)


def test_python_and_cuda_share_the_route_limit():
    """The wrappers' limit is the one csrc/qkv_attention.cuh states, which
    blocks.cuh routes by."""
    with open(os.path.join(CSRC, "qkv_attention.cuh")) as f:
        header = f.read()
    limit = re.search(r"constexpr int QKV_ATTN_MAX_S = (\d+);", header)
    assert limit is not None and int(limit.group(1)) == fa.QKV_ATTN_MAX_S == 256
    with open(os.path.join(CSRC, "blocks.cuh")) as f:
        blocks = f.read()
    assert blocks.count("if (qkv_attention_fused(S))") == 2


@pytest.mark.parametrize("s", [64, 256, 257])
@pytest.mark.parametrize("stash", [False, True])
def test_qkv_scratch(s, stash):
    qkv = fa.qkv_scratch(B, s, HEADS * 64, torch.device("cpu"), stash)
    if s <= 256 and not stash:
        assert qkv is None
    else:
        assert qkv.shape == (B * s, 3 * HEADS * 64) and qkv.dtype == torch.bfloat16


@pytest.fixture
def recorder(monkeypatch):
    """Replace the C call (and the CUDA device context around it) with a
    recorder of each call's name and arguments."""
    calls = []
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: _Stream())
    return calls


def _attn_inputs(s):
    g = torch.Generator().manual_seed(s)
    hd = HEADS * 64

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype)

    return (rnd(B, s, K), rnd(K, 3 * hd), rnd(3 * hd, dtype=torch.float32),
            rnd(hd, K), rnd(K, dtype=torch.float32))


# the position of the qkv pointer among each C entry's arguments
QKV_ARG = {"uml_attn_block": 6, "uml_attn_block_stash": 6, "uml_attn_block_q8": 9}


@pytest.mark.parametrize("s", [9, 197, 256, 257])
@pytest.mark.parametrize("q_rows", ["all", "cls"])
def test_the_inference_half_allocates_no_qkv_on_the_fused_route(recorder, s, q_rows):
    x, *w = _attn_inputs(s)
    rows = s if q_rows == "all" else 1
    n = fa.qkv_attention.launches
    _, qkv, _ = fa._launch_attn_block(x, *w, HEADS, False, 1e-5, rows)
    (name, args), = recorder
    assert name == "uml_attn_block"
    fused = s <= 256
    assert (args[QKV_ARG[name]] is None) == fused
    assert (qkv is None) == fused
    assert fa.qkv_attention.launches == n + fused


@pytest.mark.parametrize("s", [9, 197, 257])
def test_the_stash_always_takes_a_qkv_buffer(recorder, s):
    """The training forward (and the CLS forward that keeps its stash)
    pass the qkv buffer on either route: the fused kernel writes it."""
    x, *w = _attn_inputs(s)
    n = fa.qkv_attention.launches
    _, qkv, _ = fa._launch_attn_block(x, *w, HEADS, False, 1e-5, s,
                                      entry="uml_attn_block_stash", stash=True)
    _, qkv_cls, _ = fa._launch_attn_block(x, *w, HEADS, False, 1e-5, 1, stash=True)
    assert [name for name, _ in recorder] == ["uml_attn_block_stash", "uml_attn_block"]
    for (name, args), t in zip(recorder, (qkv, qkv_cls)):
        assert args[QKV_ARG[name]] == t.data_ptr()
        assert t.shape == (B, s, 3 * HEADS * 64)
    assert fa.qkv_attention.launches == n + 2 * (s <= 256)


@pytest.mark.parametrize("s", [9, 197, 257])
@pytest.mark.parametrize("q8_out", [True, False])
def test_the_int8_half_allocates_no_qkv_on_the_fused_route(recorder, s, q8_out):
    x, w_eff, b_eff, wo, bo = _attn_inputs(s)
    wq, wsc = q8.quantize_weight(w_eff.float())
    woq, wosc = q8.quantize_weight(wo.float())
    wo_ops = (woq.t().contiguous(), wosc) if q8_out else (wo,)
    n = q8.qkv_attention_q8.launches
    q8._launch_attn_block_q8(x, wq.t().contiguous(), wsc, b_eff, wo_ops, bo,
                             HEADS, False, q8_out, 1e-5)
    (name, args), = recorder
    assert name == "uml_attn_block_q8"
    assert (args[QKV_ARG[name]] is None) == (s <= 256)
    assert q8.qkv_attention_q8.launches == n + (s <= 256)


def test_the_fused_kernels_refuse_s_past_the_route():
    """On a CUDA tensor the stand-alone fused wrappers raise above S = 256
    (a CPU tensor takes the plain version at any S)."""
    x, w_eff, b_eff, _, _ = _attn_inputs(257)
    with pytest.raises(ValueError, match="S <= 256"):
        fa.qkv_attention(x.to("meta"), w_eff.to("meta"), b_eff.to("meta"),
                         heads=HEADS)
    wq, wsc = q8.quantize_weight(w_eff.float())
    with torch.no_grad(), pytest.raises(ValueError, match="S <= 256"):
        q8.qkv_attention_q8(x.to("meta"), wq.to("meta"), wsc.to("meta"),
                            b_eff.to("meta"), heads=HEADS)


@pytest.mark.parametrize("s", [9, 65, 197])
@pytest.mark.parametrize("causal", [False, True])
def test_qkv_attention_plain_is_the_half_blocks_first_two_steps(s, causal):
    """The fused kernel's plain version (the yardstick on the card) is the
    stash forward's (qkv, attn), and attn_block_q8_plain's attention is
    qkv_attention_q8_plain's."""
    x, *w = _attn_inputs(s)
    _, qkv, attn = fa.attn_block_stash_plain(x, *w, heads=HEADS, causal=causal)
    got = fa.qkv_attention(x, *w[:2], heads=HEADS, causal=causal, stash=True)
    assert torch.equal(got[0], qkv) and torch.equal(got[1], attn)
    assert torch.equal(fa.qkv_attention(x, *w[:2], heads=HEADS, causal=causal), attn)
    if not causal:
        _, _, cls_attn = fa.attn_block_stash_plain(x, *w, heads=HEADS, q_rows=1)
        assert torch.equal(fa.qkv_attention(x, *w[:2], heads=HEADS, q_rows=1),
                           cls_attn)
    wq, wsc = q8.quantize_weight(w[0].float())
    attn_q8 = q8.qkv_attention_q8(x, wq, wsc, w[1], heads=HEADS, causal=causal)
    assert attn_q8.shape == (B, s, HEADS * 64)
    woq, wosc = q8.quantize_weight(w[2].float())
    aq, asc = q8.quantize_rows(attn_q8.float())
    out = (x.float() + q8.q8_dot(aq, asc, woq, wosc) + w[3]).to(x.dtype)
    assert torch.equal(out, q8.attn_block_q8_plain(x, wq, wsc, w[1], (woq, wosc),
                                                   w[3], heads=HEADS, causal=causal))
