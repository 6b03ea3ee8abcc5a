#!/usr/bin/env python3
"""Time the kernels of one checkout of ``uml_tpu_torch`` with
``chip_smoke.py``'s graph harness (``_graph_time_ms``: calls captured in a
CUDA graph over input copies larger than the L2, no host work in the
interval), beside the PyTorch call that computes the same function:

* the stand-alone ``layer_norm`` and ``flash_attention`` (rows 18, 13);
* the training rows at ViT-B/16 B=64 (rows 6, 7, 8, 9, 19, 20, and row 7
  causal at the text tower's widths), the forward halves (rows 1, 2, 3,
  5; row 1 causal at the text widths), the 12-layer text tower (row 4),
  the int8 attention half with an int8 and with a bf16 out-projection
  (row 10, ``int8_qkv``), the int8 MLP half (row 11) and the 11-layer
  int8 tower (row 12);
* where the checkout has ``ops/gemm.py``: each product triple of the
  wgmma engine and ``gemm_at`` at the shapes the rows launch them, each
  beside one cuBLAS call (``torch.matmul``) at the same shape; where it
  has ``q8_gemm``, the int8 products (QKV, c_fc, c_proj) beside
  ``torch._int_mm``;
* where the checkout has ``attn_bwd``: the attention backward's dq and
  dkv passes on their own; where it has ``qkv_attention``: the fused QKV +
  attention kernel on its own (bf16, with its stash, int8);
* where the checkout's ``gemm_at`` takes ``splits``: each row-chunk
  count at both of row 20's shapes;
* the fused attention against the fp32 witness (``chip_smoke.py``'s
  ``_attention_fp32``: unrounded probabilities): the bf16 output's
  error, and the int8 block's activation integers that differ from the
  witness's and from the plain version's (``_int8_flips``);
* the stand-alone ops of the non-fused branch: ``ln_matmul`` 3-d (the
  QKV, row 15) and 2-d (c_fc, quick_gelu and gelu_exact, row 14),
  ``add_ln_matmul`` (c_fc, quick_gelu, row 16) and ``ln_qkv_attention``
  (row 17, and causal at the text widths), and the bits of their LN
  operand: each op run with an identity weight and no bias returns the
  normalized rows exactly, printed as a sha256 (equal digests on two
  checkouts: the same xn and t);
* the device time by kernel of rows 1, 2, 5, 6, 7, 9, 10 (with an int8
  and a bf16 out-projection), 11, 14-17, 19 and 20 and of row 1 causal at
  the text widths (torch.profiler, printed as ``[profile]`` lines);
* the bf16 and int8 image encoders' img/s at batch 64 (random-init
  ViT-B/16, a staged batch, host work included as in chip_smoke.py), the
  non-fused encoder's (``attn_impl`` "reference" and "pallas"), the text
  encoder's prompts/s at 64 prompts, with a profile of each; the
  full-model train step (chip_smoke.py's ``_train_step_rates``) at bs 64
  with the stashes, at bs 256 under the default gate and, non-fused, at
  bs 64.

Run it on two checkouts one after the other on the same card to set an
earlier commit's kernels beside the current ones:

    git archive <commit> | tar -x -C build/parent
    python3 tools/exp_torch_retime.py --root build/parent
    python3 tools/exp_torch_retime.py            # this checkout

Needs a CUDA card; prints one JSON line (milliseconds per call, img/s,
and the card's name and power limit).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _products(gemm, dev, gen):
    """(name, fn, inputs, FLOPs, cuBLAS call) of each product rows 7 and
    20 launch, at ViT-B/16 B=64 (12,608 rows, K=768, M=3072)."""
    import torch

    bf = torch.bfloat16
    rows, k, m = 64 * 197, 768, 3072

    def rnd(*shape, std=1.0, dtype=bf):
        return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

    x, g = rnd(rows, k), rnd(rows, k)
    dqkv, dpre = rnd(rows, 3 * k), rnd(rows, m)
    w_eff, wo = rnd(k, 3 * k, std=k ** -0.5), rnd(k, k, std=k ** -0.5)
    w1, w2 = rnd(k, m, std=k ** -0.5), rnd(m, k, std=m ** -0.5)
    b_eff, b1 = rnd(3 * k, dtype=torch.float32), rnd(m, dtype=torch.float32)
    dy = rnd(rows, m, dtype=torch.float32)

    def triple(name):
        return lambda *a: gemm.ln_gemm(*a, triple=name)

    mm = torch.matmul
    return [
        ("QKV [12608,768]x[768,2304] (LN pre-pass + engine)", triple("QKV"),
         (x, w_eff, b_eff), 2.0 * rows * k * 3 * k, lambda a, w, *_: mm(a, w)),
        ("TRANS_B g.wo^T [12608,768]x[768,768]^T", triple("TRANS_B"),
         (g, wo), 2.0 * rows * k * k, lambda a, w: mm(a, w.t())),
        ("TRANS_B_F32 dqkv.W_eff^T [12608,2304]x[768,2304]^T",
         triple("TRANS_B_F32"), (dqkv, w_eff), 2.0 * rows * k * 3 * k,
         lambda a, w: mm(a, w.t())),
        ("TRANS_B_F32 g.w2^T [12608,768]x[3072,768]^T", triple("TRANS_B_F32"),
         (g, w2), 2.0 * rows * k * m, lambda a, w: mm(a, w.t())),
        ("TRANS_B_F32 dpre.w1^T [12608,3072]x[768,3072]^T",
         triple("TRANS_B_F32"), (dpre, w1), 2.0 * rows * k * m,
         lambda a, w: mm(a, w.t())),
        ("DACT_F32 [12608,768]x[768,3072] (LN pre-pass + engine)",
         lambda a, w, b, d: gemm.ln_gemm(a, w, b, d, triple="DACT_F32"),
         (x, w1, b1, dy), 2.0 * rows * k * m, lambda a, w, *_: mm(a, w)),
        ("gemm_at xn^T.dpre [12608,768]^T x [12608,3072]", gemm.gemm_at,
         (x, dpre), 2.0 * rows * k * m, lambda a, b: mm(a.t(), b)),
        ("gemm_at yact^T.g [12608,3072]^T x [12608,768]", gemm.gemm_at,
         (dpre, g), 2.0 * rows * k * m, lambda a, b: mm(a.t(), b)),
    ] + ([
        ("DACT bf16 dy [12608,768]x[768,3072] (LN pre-pass + engine)",
         lambda a, w, b, d: gemm.ln_gemm(a, w, b, d, triple="DACT"),
         (x, w1, b1, dy.to(bf)), 2.0 * rows * k * m, lambda a, w, *_: mm(a, w)),
    ] if "DACT" in gemm.TRIPLES else []) + ([
        ("GELU_STASH MLP in [12608,768]x[768,3072] (LN pre-pass + engine)",
         triple("GELU_STASH"), (x, w1, b1), 2.0 * rows * k * m,
         lambda a, w, *_: mm(a, w)),
        ("RESIDUAL MLP out [12608,3072]x[3072,768]", triple("RESIDUAL"),
         (dpre, w2, b1[:k], x), 2.0 * rows * k * m, lambda a, w, *_: mm(a, w)),
        ("RESIDUAL out-projection [12608,768]x[768,768]", triple("RESIDUAL"),
         (g, wo, b1[:k], x), 2.0 * rows * k * k, lambda a, w, *_: mm(a, w)),
    ] if "RESIDUAL" in gemm.TRIPLES else []) + (_q8_products(gemm, dev, gen)
                                                 if hasattr(gemm, "q8_gemm") else [])


def _q8_products(gemm, dev, gen):
    """The int8 products of rows 10-12 (K-major weights) beside
    torch._int_mm (a row-major [K, N] weight, as cuBLAS runs it fastest)."""
    import torch

    rows = 64 * 197
    out = []
    for name, k, n, epi in (("QKV", 768, 2304, "BF16"), ("c_fc", 768, 3072, "F32"),
                            ("c_proj", 3072, 768, "RESIDUAL")):
        a = torch.randint(-127, 128, (rows, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8)
        rs = torch.rand(rows, generator=gen, device=dev) * 0.02
        cs = torch.rand(n, generator=gen, device=dev) * 0.02
        b = torch.randn(n, generator=gen, device=dev) * 0.02
        ins = (a, w, rs, cs, b) + ((torch.randn(rows, n, generator=gen, device=dev)
                                    .to(torch.bfloat16),) if epi == "RESIDUAL" else ())
        w_kn = w.t().contiguous()
        out.append((f"q8_gemm {name} [{rows},{k}]x[{k},{n}] int8 ({epi})",
                    lambda *t, e=epi: gemm.q8_gemm(*t, epi=e), ins, 2.0 * rows * k * n,
                    lambda a_, *_, w_=w_kn: torch._int_mm(a_, w_)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose uml_tpu_torch is timed")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("exp_torch_retime: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.models.encoders import ClipEncoder
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import text_tower as tt
    from uml_tpu_torch.ops import tower_q8 as tq8
    from uml_tpu_torch.ops.layer_norm import layer_norm

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_harness", os.path.join(HERE, "chip_smoke.py"))
    harness = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(harness)

    F = torch.nn.functional
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    scale = 1 + 0.1 * torch.randn(768, generator=gen, device=dev)
    bias = 0.1 * torch.randn(768, generator=gen, device=dev)
    scale_bf, bias_bf = scale.to(bf), bias.to(bf)

    def qkv(*shape):
        return tuple(torch.randn(*shape, generator=gen, device=dev).to(bf)
                     for _ in range(3))

    q197, q2048, q128 = qkv(64, 12, 197, 64), qkv(8, 16, 2048, 64), qkv(8, 8, 1024, 128)
    # one ViT-B/16 layer's weights and cotangents, and the text widths
    wv = harness._block_weights(gen, 768, 3072, 768, dev)
    attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
    g = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    g_cls = torch.randn(64, 1, 768, generator=gen, device=dev).to(bf)
    dy = torch.matmul(g, wv["w2"].t())
    _, qkv_v, _ = fa.attn_block_stash_plain(x, *attn_v, heads=12)
    _, qkv_c, _ = fa.attn_block_stash_plain(x, *attn_v, heads=12, q_rows=1)
    wt = harness._block_weights(gen, 512, 2048, 512, dev)
    xt = torch.randn(64, 77, 512, generator=gen, device=dev).to(bf)
    gt = torch.randn(64, 77, 512, generator=gen, device=dev).to(bf)
    row7 = lambda *a: fa.attn_block_bwd_recompute(*a, heads=12)  # noqa: E731
    row20 = lm.mlp_bwd_dw
    row7_in = (x, g, *attn_v[:3])
    row20_in = (x, g, wv["b1"], wv["w1"], wv["w2"])
    row6 = lambda *a: fa.attn_block_bwd(*a, heads=12)  # noqa: E731
    row6_in = (x, g, qkv_v, wv["w_eff"], wv["wo"])
    mlp_v = (wv["w1"], wv["b1"], wv["w2"], wv["b2"])
    attn_t = (wt["w_eff"], wt["b_eff"], wt["wo"], wt["bo"])
    layers = [harness._block_weights(gen, 512, 2048, 512, dev) for _ in range(12)]
    tower = tuple(torch.stack([layer[n] for layer in layers])
                  for n in ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
    try:
        from uml_tpu_torch.ops import gemm
    except ImportError:     # a checkout from before the wgmma engine
        gemm = None
    # the int8 weights as [in, out] views of K-major tensors (what the
    # model passes); a checkout from before the int8 engine takes them
    # row-major
    kmajor = gemm is not None and hasattr(gemm, "q8_gemm")
    q8v = harness._q8_case_weights(gen, 768, 3072, 768, dev)
    q8_tower = harness._q8_case_weights(gen, 768, 3072, 768, dev, layers=11)
    if not kmajor:
        q8v, q8_tower = (tuple(t.contiguous() for t in ws) for ws in (q8v, q8_tower))
    cases = {
        "layer_norm [64,197,768] bf16": (layer_norm, (x, scale, bias)),
        "F.layer_norm [64,197,768] bf16": (
            lambda t, *_: F.layer_norm(t, (768,), scale_bf, bias_bf), (x, scale, bias)),
        "layer_norm [64,197,768] fp32": (layer_norm, (x.float(), scale, bias)),
        "flash_attention [64,12,197,64]": (at.flash_attention, q197),
        "flash_attention [8,16,2048,64]": (at.flash_attention, q2048),
        "flash_attention [8,16,2048,64] causal": (
            lambda *a: at.flash_attention(*a, causal=True), q2048),
        "flash_attention [8,8,1024,128]": (at.flash_attention, q128),
        "sdpa [64,12,197,64]": (F.scaled_dot_product_attention, q197),
        "sdpa [8,16,2048,64]": (F.scaled_dot_product_attention, q2048),
        "row 1 attn_block": (lambda *a: fa.attn_block(*a, heads=12), (x, *attn_v)),
        "row 2 attn_block_cls": (lambda *a: fa.attn_block_cls(*a, heads=12),
                                 (x, *attn_v)),
        "row 1 causal, text widths": (
            lambda *a: fa.attn_block(*a, heads=8, causal=True), (xt, *attn_t)),
        "row 3 mlp_block": (lm.mlp_block, (x, *mlp_v)),
        "row 4 text_tower": (lambda *a: tt.text_tower(*a, heads=8), (xt, *tower)),
        "row 5 attn_block_stash": (lambda *a: fa.attn_block_stash(*a, heads=12),
                                   (x, *attn_v)),
        "row 6 attn_block_bwd": (row6, row6_in),
        "row 7 attn_block_bwd_recompute": (row7, row7_in),
        "row 7 causal, text widths": (
            lambda *a: fa.attn_block_bwd_recompute(*a, heads=8, causal=True),
            (xt, gt, wt["w_eff"], wt["b_eff"], wt["wo"])),
        "row 8 attn_block_cls_bwd": (lambda *a: fa.attn_block_cls_bwd(*a, heads=12),
                                     (x, g_cls, qkv_c, wv["w_eff"], wv["wo"])),
        "row 9 mlp_block_stash": (lm.mlp_block_stash, (x, *mlp_v)),
        "row 10 attn_block_q8": (
            lambda x_, wq, wsc, be, wo_, wosc, bo: q8.attn_block_q8(
                x_, wq, wsc, be, (wo_, wosc), bo, heads=12), (x, *q8v[:6])),
        "row 10 attn_block_q8 int8_qkv": (
            lambda x_, wq, wsc, be, wo_, bo: q8.attn_block_q8(
                x_, wq, wsc, be, (wo_,), bo, heads=12, q8_out=False),
            (x, *q8v[:3], wv["wo"], q8v[5])),
        "row 11 mlp_block_q8": (q8.mlp_block_q8, (x, *q8v[6:])),
        "row 12 tower_q8": (lambda *a: tq8.tower_q8(*a, heads=12), (x, *q8_tower)),
        "row 19 mlp_bwd": (lm.mlp_bwd, (x, dy, wv["b1"], wv["w1"])),
        "row 20 mlp_bwd_dw": (row20, row20_in),
    }
    if hasattr(fa, "qkv_attention"):
        cases["qkv_attention (the fused QKV + attention kernel)"] = (
            lambda *a: fa.qkv_attention(*a, heads=12), (x, *attn_v[:2]))
        cases["qkv_attention stash"] = (
            lambda *a: fa.qkv_attention(*a, heads=12, stash=True), (x, *attn_v[:2]))
        cases["qkv_attention_q8"] = (
            lambda x_, wq, wsc, be: q8.qkv_attention_q8(x_, wq, wsc, be, heads=12),
            (x, *q8v[:3]))
    # rows 14-17: the LN affine unfolded, a second residual operand
    delta = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    qkv_w, fc_w = (wv["w_eff"], wv["b_eff"]), (wv["w1"], wv["b1"])
    cases["row 15 ln_matmul 3-d QKV"] = (lm.ln_matmul, (x, scale, bias, *qkv_w))
    for act in ("quick_gelu", "gelu_exact"):
        cases[f"row 14 ln_matmul 2-d c_fc {act}"] = (
            lambda *a, act=act: lm.ln_matmul(*a, activation=act),
            (x.view(-1, 768), scale, bias, *fc_w))
    cases["row 16 add_ln_matmul c_fc quick_gelu"] = (
        lambda *a: lm.add_ln_matmul(*a, gelu=True), (x, delta, scale, bias, *fc_w))
    cases["row 17 ln_qkv_attention"] = (
        lambda *a: fa.ln_qkv_attention(*a, heads=12), (x, scale, bias, *qkv_w))
    cases["row 17 causal, text widths"] = (
        lambda *a: fa.ln_qkv_attention(*a, heads=8, causal=True),
        (xt, scale[:512], bias[:512], wt["w_eff"], wt["b_eff"]))
    if hasattr(fa, "attn_bwd"):
        dattn = torch.matmul(g, wv["wo"].t())
        _, stats = fa.attn_bwd_plain(qkv_v, dattn, heads=12)
        cases["attention backward dq pass"] = (
            lambda q_, d_: fa.attn_bwd(q_, d_, heads=12), (qkv_v, dattn))
        cases["attention backward dkv pass"] = (
            lambda q_, d_, s_: fa.attn_bwd(q_, d_, heads=12, stats=s_),
            (qkv_v, dattn, stats))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    out = {"card": card, "root": os.path.abspath(args.root)}
    for name, (fn, inputs) in cases.items():
        out[name] = harness._graph_time_ms(fn, harness._input_copies(inputs))
    if gemm is not None:
        for name, fn, inputs, flops, cublas in _products(gemm, dev, gen):
            copies = harness._input_copies(inputs)
            ms = harness._graph_time_ms(fn, copies)
            ref = harness._graph_time_ms(cublas, copies)
            del copies
            out[name] = ms
            out[f"cuBLAS {name}"] = ref
            print(f"[products] {name}: {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), cuBLAS {ref:.4f} ms ({flops / ref / 1e9:.1f}), "
                  f"ratio {ms / ref:.2f}")
    if gemm is not None and "splits" in inspect.signature(gemm.gemm_at).parameters:
        for (a, b_), tag in (((x.view(-1, 768), dy.view(-1, 3072)), "768x3072"),
                             ((dy.view(-1, 3072), g.view(-1, 768)), "3072x768")):
            for sp in range(1, gemm.MAX_SPLITS + 1):
                fn = lambda a, b, sp=sp: gemm.gemm_at(a, b, splits=sp)  # noqa: E731
                out[f"gemm_at {tag} splits={sp}"] = harness._graph_time_ms(
                    fn, harness._input_copies((a, b_)))
            out[f"gemm_at {tag} splits=auto"] = harness._graph_time_ms(
                gemm.gemm_at, harness._input_copies((a, b_)))
    for half, (share, worst) in (harness._int8_flips(x, q8v).items() if kmajor
                                 else ()):
        out[f"int8 {half}: share differing"] = share
        out[f"int8 {half}: largest difference"] = worst
    for side, err in harness._attention_witness(x, attn_v).items():
        out[f"attention vs fp32 witness, {side}"] = err
    # the LN operand of rows 14-16, bit for bit: with w = I and b = 0 the
    # product returns xn exactly (one nonzero term a column, in fp32)
    eye, zero = torch.eye(768, device=dev, dtype=bf), torch.zeros(768, device=dev)

    def digest(t):
        return hashlib.sha256(t.contiguous().view(torch.int16).cpu().numpy()
                              .tobytes()).hexdigest()

    out["sha256 xn, ln_matmul"] = digest(lm.ln_matmul(x, scale, bias, eye, zero))
    t_add, xn_add = lm.add_ln_matmul(x, delta, scale, bias, eye, zero)
    out["sha256 t, add_ln_matmul"] = digest(t_add)
    out["sha256 xn, add_ln_matmul"] = digest(xn_add)
    for name in ("row 1 attn_block", "row 2 attn_block_cls", "row 5 attn_block_stash",
                 "row 1 causal, text widths", "row 10 attn_block_q8",
                 "row 10 attn_block_q8 int8_qkv"):
        fn, inputs = cases[name]
        harness._profile(name, lambda fn=fn, inputs=inputs: fn(*inputs), top=12)
    harness._profile("row 6 attn_block_bwd", lambda: row6(*row6_in), top=12)
    harness._profile("row 7 attn_block_bwd_recompute", lambda: row7(*row7_in),
                     top=12)
    harness._profile("row 9 mlp_block_stash", lambda: lm.mlp_block_stash(x, *mlp_v),
                     top=12)
    harness._profile("row 20 mlp_bwd_dw", lambda: row20(*row20_in), top=12)
    harness._profile("row 19 mlp_bwd", lambda: lm.mlp_bwd(x, dy, wv["b1"], wv["w1"]),
                     top=12)
    harness._profile("row 11 mlp_block_q8", lambda: q8.mlp_block_q8(x, *q8v[6:]),
                     top=12)
    for name in ("row 15 ln_matmul 3-d QKV", "row 14 ln_matmul 2-d c_fc quick_gelu",
                 "row 16 add_ln_matmul c_fc quick_gelu", "row 17 ln_qkv_attention"):
        fn, inputs = cases[name]
        harness._profile(name, lambda fn=fn, inputs=inputs: fn(*inputs), top=12)

    encoder = ClipEncoder("ViT-B/16", allow_random_init=True)
    u8 = np.random.default_rng(0).integers(0, 256, (64, 224, 224, 3),
                                           dtype=np.uint8)
    staged, n = encoder.stage_images(u8)
    ms = harness._time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
    out["encoder img/s bs64 bf16"] = 64 / (ms / 1e3)
    harness._profile("image encoder", lambda: encoder.encode_staged(staged, n))
    prompts = [f"a photo of a class_{i}." for i in range(64)]
    ms = harness._time_ms(lambda: encoder.encode_texts(prompts), iters=10)
    out["text prompts/s bs64"] = 64 / (ms / 1e3)
    harness._profile("text encoder", lambda: encoder.encode_texts(prompts))
    del encoder
    encoder = ClipEncoder("ViT-B/16", allow_random_init=True, quant="int8")
    staged, n = encoder.stage_images(u8)
    ms = harness._time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
    out["encoder img/s bs64 int8"] = 64 / (ms / 1e3)
    harness._profile("int8 image encoder", lambda: encoder.encode_staged(staged, n))
    del encoder
    u8_dev = torch.from_numpy(u8.reshape(64, -1)).to(dev)
    for attn_impl in ("reference", "pallas"):
        model = build_clip("ViT-B/16", bf, attn_impl=attn_impl).init_random(
            torch.Generator().manual_seed(0)).to(dev).eval()
        with torch.no_grad():
            ms = harness._time_ms(lambda: model.encode_image_u8(u8_dev), iters=10)
            out[f"non-fused {attn_impl} encoder img/s bs64"] = 64 / (ms / 1e3)
            harness._profile(f"non-fused image encoder ({attn_impl})",
                             lambda: model.encode_image_u8(u8_dev))
        del model
    torch.cuda.empty_cache()
    out.update(harness._train_step_rates(64, [("stash", {}, None)]))
    out.update(harness._train_step_rates(256, [
        ("gate_default", {"UML_MLP_BWD": "unset"}, None)]))
    out.update(harness._train_step_rates(64, [("unfused_reference", {}, None)],
                                         clip_kw={"attn_impl": "reference"}))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
