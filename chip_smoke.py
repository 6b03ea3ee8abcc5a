#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (uml_tpu_torch) runs on a GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero; no phase is caught):

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``uml_tpu_torch/csrc`` (nvcc, sm_90a).
2. kernels: each port (attn_block non-causal, attn_block_cls, mlp_block at
   ViT-B/16 widths; causal attn_block and the 12-layer text_tower at the
   CLIP text widths, at B = 64 and at B = 1, the main path's shape (the
   one-launch tower), and at the ViT-L/14 text widths (K = 768, 12 heads:
   the chain's route); the training ports, the recompute backwards
   attn_block_bwd_recompute (also causal at the text widths), mlp_bwd and
   mlp_bwd_dw among them; the int8 attn_block_q8 with an int8 and a bf16
   out-projection, mlp_block_q8 and the 11-layer tower_q8 at ViT-B/16
   widths, causal attn_block_q8 at the text widths; the stand-alone ops
   of the non-fused branch: ln_matmul 3-d and 2-d with each activation,
   add_ln_matmul, both also at a ragged row count (12,545) and at the text
   tower's widths, ln_qkv_attention at both towers' widths, layer_norm in
   bf16 and fp32, flash_attention at S=197 and at [8,16,2048,64] causal
   and not, at head dim 128, and on the ViT layer's packed qkv [B, S, 3,
   H, D] read in place by the strided entry; the attention halves, the
   CLS half and the attention backwards at S = 257 (ViT-L/14 widths) and
   S = 785 (ViT-B/16 widths), past the old shared-memory gates; each
   product that the half-blocks (the MLP in with and without its stash,
   the MLP out and the out-projections with the residual) and rows 6, 7,
   8, 19 and 20 launch on the wgmma engine, and gemm_at, on its own
   through ops/gemm.py; the int8 products of rows 10-12 (QKV, c_fc,
   c_proj) on the engine's wgmma s8 instantiation, through
   ops/gemm.py::q8_gemm, equal to their plain versions bit for bit; the
   attention backward's dq and dkv passes on
   their own through ops/fused_attention.py::attn_bwd) against its plain PyTorch
   version on the same inputs, within the stated bounds, with its bound
   (the least time the card could take) and a cuBLAS GEMM yardstick at its
   largest product (layer_norm and flash_attention: the one PyTorch call
   that computes the same function, F.layer_norm and
   F.scaled_dot_product_attention, timed as library_ms and used nowhere in
   the port).  Kernel, plain, library and yardstick are timed alike, on
   the card alone (``_graph_time_ms``): up to 100 calls captured in one
   CUDA graph, rotating over copies of the inputs that together exceed
   the 50 MB L2, replayed between two CUDA events, the median of five
   replays per call; no host work lies inside the interval.  The
   end-to-end rates below are host-inclusive on purpose (``_time_ms``).
   The int8 halves
   also compare their activation integers with the plain version's, on
   phase 2's int8 weights and on 8 more draws of them, each from a
   generator of its own: no integer may differ by more than one step.  A
   profile of one row-11 call (the int8 MLP half) must show the LN
   quantize pass, c_fc's row-max and quantizing passes and c_proj, and no
   pass over an fp32 pre-activation.  A profile of one row-19
   call must show the engine and no wmma ln_gemm_kernel; profiles of one
   call of rows 14-17 must show the LN pre-pass, one engine product (and
   for row 17 the attention) and nothing else: the kernels line names
   them (``engine_kernels``).  A profile of one text_tower call at S = 77
   (B = 64 and B = 1) must show one device kernel, the tower's; one of
   attn_block_cls_bwd must show dattn on the engine and the three
   rank-2H passes of cls_bwd.cuh, and no dense dxn product or LN backward
   over an fp32 dxn (``profile_kernels`` on the kernels line).
3. main path: the PIL decode rate of data/loader.py on the fixture's
   JPEGs (one worker and one per core), then generate_fewshot and
   features on a synthetic caltech-layout
   fixture with a random-init ViT-B/16; the .pth caches must hold finite
   width-512 features, the encoder must live on the card, every port's
   launch counter must have moved by the expected count, and the card's
   features must agree with the same model run on the CPU (plain path);
   the image encoder's img/s, and the text encoder's prompts/s at 64
   prompts and at 1 (one class's prompts, as features calls it).
3b. int8 main path: features --quant int8 on the same fixture with the
   same checks (per image batch 11 attn_block_q8, 11 mlp_block_q8, 1
   attn_block_cls, 1 mlp_block; per prompt batch 12 causal attn_block_q8
   and 12 mlp_block_q8, no text_tower); then one encode under
   UML_TOWER_Q8=1 launches tower_q8 once and equals the per-layer int8
   output; the int8-vs-bf16 feature cosine (recorded) and the img/s of
   the bf16, int8 and int8-tower image encoders in the same run; a
   profile of one int8 batch must show the int8 products on the wgmma
   engine and no wmma s8 kernel, and, per layer and under UML_TOWER_Q8=1,
   each of the 11 int8 MLP halves the four kernels of row 11 (no
   act_quantize_rows pass); the peak device memory of one int8 encode,
   per layer and as the tower; and every int8 weight the layers hand
   the ops must be a view of the model's K-major cache, which the
   wrappers read in place (no per-batch transpose).
3c. non-fused path: build_clip("ViT-B/16", bf16, attn_impl=...) with the
   phase-3 model's weights; one batch of 64 images through
   encode_image_u8 under attn_impl="reference" (12 ln_matmul and 12
   add_ln_matmul, no fused port) and "pallas" (12 flash_attention more),
   64 prompts through encode_text under "reference" (12 and 12, no
   text_tower); per-row cosine against the fused path's features and
   against the same model on the CPU; the img/s of both modes beside the
   fused encoder's, and a profile of each showing 12 affine and 12 add LN
   pre-passes a batch and no wmma ln_gemm_kernel.  Then the public
   exports of uml_tpu_torch.ops on the card: layer_norm, ln_qkv_attention,
   multi_head_attention ("auto" at S=2048) and a 2-d ln_matmul; their
   counters must move.
4. training path: the finetune CLI on the phase-3 fixture and text cache,
   frozen (``--hyperparams smoke``) and full-model (``smoke_full``: the
   ViT-B/16 tower at full width, bs 8, 30 steps), then collect_results
   over the tree.  The artifacts must hold finite scalars, each path's
   launch counters must have moved by the expected count (per full-model
   step 11 attn_block_stash, 11 attn_block_bwd, 1 attn_block_cls_bwd and
   12 mlp_block_stash), and the tower must have moved.  Then smoke_full
   twice more with both stashes off (UML_BWD_STASH=0 UML_MLP_STASH=0),
   under UML_MLP_BWD=kernel and =dw: per step 11 attn_block, 11
   attn_block_bwd_recompute, 1 attn_block_cls, 1 attn_block_cls_bwd, 12
   mlp_block and 12 mlp_bwd (or mlp_bwd_dw), no stash launch, and the
   tower moved.  One bs-4 train step of a random-init ViT-B/16 head on
   the card against the same model and batch on the CPU (plain path):
   loss and per-tensor gradient cosines within the stated bounds, in the
   default mode and with both stashes off under UML_MLP_BWD unset (row 19
   on the card), kernel, dw and plain (the plain VJP, TF32 products on
   the card).  Then the steady-state full-model train step (forward,
   backward, adamw) in img/s with its peak memory, a profile and its
   library GEMMs by product format (TF32, bf16, fp32 SIMT): at bs 64 with
   the stashes and in the three recompute modes (plain MLP backward,
   kernel, dw); at bs 256 under the default gate (the MLP stash turns
   itself off; the mlp_bwd counter must move) with UML_MLP_BWD unset,
   plain and dw; and bs 256 as 2 x 128 through train/accum.py with both
   stashes on.  The non-fused branch
   (attn_impl="reference"): the bs-4 step against the CPU and the bs-64
   rate with its peak memory; one gradient of encode_text through
   TextTowerFn on the card against the CPU; and the bs-4 step of a
   ViT-L/14 at full width (S = 257), cut to 4 image layers, against the
   CPU, in the default mode and with both stashes off under
   UML_MLP_BWD=dw.
5. the products of the engine (bf16 beside torch.matmul, int8 beside
   torch._int_mm) and the attention backward's passes as one JSON line,
   the kernel table as one JSON line, the device line last.

The script needs nothing of JAX.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# (name, source, TPU kernel it replaces)
PORTS = [
    ("attn_block", "uml_tpu_torch/csrc/attn_block.cu",
     "uml_tpu/ops/fused_attention.py:313"),
    ("attn_block_cls", "uml_tpu_torch/csrc/attn_block.cu",
     "uml_tpu/ops/fused_attention.py:475"),
    ("mlp_block", "uml_tpu_torch/csrc/mlp_block.cu",
     "uml_tpu/ops/ln_matmul.py:90"),
    ("text_tower", "uml_tpu_torch/csrc/text_tower.cu",
     "uml_tpu/ops/text_tower.py:49"),
    ("attn_block_stash", "uml_tpu_torch/csrc/attn_block.cu",
     "uml_tpu/ops/fused_attention.py:394"),
    ("attn_block_bwd", "uml_tpu_torch/csrc/attn_block_bwd.cu",
     "uml_tpu/ops/fused_attention.py:1209"),
    ("attn_block_cls_bwd", "uml_tpu_torch/csrc/attn_block_bwd.cu",
     "uml_tpu/ops/fused_attention.py:1298"),
    ("mlp_block_stash", "uml_tpu_torch/csrc/mlp_block.cu",
     "uml_tpu/ops/ln_matmul.py:186"),
    ("attn_block_q8", "uml_tpu_torch/csrc/attn_block_q8.cu",
     "uml_tpu/ops/quant.py:168"),
    ("mlp_block_q8", "uml_tpu_torch/csrc/mlp_block_q8.cu",
     "uml_tpu/ops/quant.py:228"),
    ("tower_q8", "uml_tpu_torch/csrc/tower_q8.cu",
     "uml_tpu/ops/tower_q8.py:49"),
    ("attn_block_bwd_recompute", "uml_tpu_torch/csrc/attn_block_bwd.cu",
     "uml_tpu/ops/fused_attention.py:722"),
    ("mlp_bwd", "uml_tpu_torch/csrc/mlp_block_bwd.cu",
     "uml_tpu/ops/ln_matmul.py:310"),
    ("mlp_bwd_dw", "uml_tpu_torch/csrc/mlp_block_bwd.cu",
     "uml_tpu/ops/ln_matmul.py:417"),
    ("flash_attention", "uml_tpu_torch/csrc/flash_attention.cu",
     "uml_tpu/ops/attention.py:90"),
    # one C entry, uml_ln_matmul, for the TPU's 2-d and 3-d kernels
    ("ln_matmul_2d", "uml_tpu_torch/csrc/ln_matmul.cu",
     "uml_tpu/ops/ln_matmul.py:58"),
    ("ln_matmul", "uml_tpu_torch/csrc/ln_matmul.cu",
     "uml_tpu/ops/ln_matmul.py:74"),
    ("add_ln_matmul", "uml_tpu_torch/csrc/ln_matmul.cu",
     "uml_tpu/ops/ln_matmul.py:734"),
    ("ln_qkv_attention", "uml_tpu_torch/csrc/ln_qkv_attention.cu",
     "uml_tpu/ops/fused_attention.py:143"),
    ("layer_norm", "uml_tpu_torch/csrc/layer_norm.cu",
     "uml_tpu/ops/layer_norm.py:33"),
    # the QKV product and the attention of rows 1, 2, 4, 5 and 7 (bf16) and
    # of rows 10 and 12 (int8) as one kernel for S <= 256; the halves count
    # each launch here too
    ("qkv_attention", "uml_tpu_torch/csrc/qkv_attention.cu",
     "uml_tpu/ops/fused_attention.py:394"),
    ("qkv_attention_q8", "uml_tpu_torch/csrc/qkv_attention.cu",
     "uml_tpu/ops/quant.py:168"),
]
TRAIN_PORTS = ("attn_block_stash", "attn_block_bwd", "attn_block_cls_bwd",
               "mlp_block_stash")
Q8_PORTS = ("attn_block_q8", "mlp_block_q8", "tower_q8", "qkv_attention_q8")
RECOMPUTE_PORTS = ("attn_block_bwd_recompute", "mlp_bwd", "mlp_bwd_dw")
# the non-fused image encode launches the first three; the public ops
# called on the card the rest (the 2-d ln_matmul is the same wrapper)
UNFUSED_PORTS = ("flash_attention", "ln_matmul", "add_ln_matmul")
OPS_PORTS = ("ln_matmul_2d", "ln_qkv_attention", "layer_norm")
# the backward modes of the full-model train step: the environment of each
RECOMPUTE = {"UML_BWD_STASH": "0", "UML_MLP_STASH": "0"}
RECOMPUTE_MODES = {"kernel": {**RECOMPUTE, "UML_MLP_BWD": "kernel"},
                   "dw": {**RECOMPUTE, "UML_MLP_BWD": "dw"},
                   # the plain VJP (TF32 products on the card)
                   "plain": {**RECOMPUTE, "UML_MLP_BWD": "plain"}}

# Kernel vs plain version, bf16 on the card.  Both compute the same math
# with fp32 accumulation; they differ in summation order, so an
# intermediate (qkv, probabilities, hidden, residual) can round to the
# neighbouring bf16 value (2^-8 relative) and carry that into the output.
# The bound is on max|kernel - plain| / max|plain|: 1/64 (4 bf16 ulps of
# the largest output) for one half-block, 1/16 for the 12-layer tower,
# where such flips compound through 24 residual roundings.
# The training kernels are held to the same 1/64 on every output (out,
# qkv, attn; dx, dqkv, xn; out, pre), each against its own max.  The int8
# halves too: their integer products are exact on both sides, and the row
# statistics summed in another order move an activation at a .5 tie by one
# step (~1/254 of its row's range); 1/16 for the 11-layer int8 tower.
REL_BOUND = {"attn_block": 1 / 64, "attn_block_cls": 1 / 64,
             "mlp_block": 1 / 64, "attn_block_causal": 1 / 64,
             "text_tower": 1 / 16, "text_tower_b1": 1 / 16,
             "text_tower_l14": 1 / 16, "attn_block_stash": 1 / 64,
             "attn_block_bwd": 1 / 64, "attn_block_cls_bwd": 1 / 64,
             "mlp_block_stash": 1 / 64, "attn_block_q8": 1 / 64,
             "attn_block_q8_qkv": 1 / 64, "attn_block_q8_causal": 1 / 64,
             "mlp_block_q8": 1 / 64, "tower_q8": 1 / 16,
             "attn_block_bwd_recompute": 1 / 64,
             "attn_block_bwd_recompute_causal": 1 / 64, "mlp_bwd": 1 / 64,
             "mlp_bwd_dw": 1 / 64,
             # the stand-alone ops: 1/64 like the half-blocks; t of
             # add_ln_matmul is one rounding of the same fp32 sum, and the
             # fp32 layer_norm differs in summation order only: 1e-5
             "ln_matmul": 1 / 64, "ln_matmul_2d": 1 / 64,
             "ln_matmul_2d_gelu_exact": 1 / 64, "ln_matmul_gelu_exact": 1 / 64,
             "ln_matmul_ragged": 1 / 64, "ln_matmul_text": 1 / 64,
             "add_ln_matmul": (1e-5, 1 / 64),
             "add_ln_matmul_ragged": (1e-5, 1 / 64),
             "add_ln_matmul_text": (1e-5, 1 / 64), "ln_qkv_attention": 1 / 64,
             "ln_qkv_attention_causal": 1 / 64, "layer_norm": 1 / 64,
             "layer_norm_f32": 1e-5, "flash_attention": 1 / 64,
             "flash_attention_2048": 1 / 64,
             "flash_attention_2048_causal": 1 / 64,
             "flash_attention_d128": 1 / 64, "flash_attention_packed": 1 / 64,
             # past the old gates: the halves and backwards at long S
             "attn_block_s257": 1 / 64, "attn_block_cls_s257": 1 / 64,
             "attn_block_s785": 1 / 64, "attn_block_cls_s785": 1 / 64,
             "attn_block_bwd_recompute_s257": 1 / 64,
             "attn_block_bwd_recompute_s785": 1 / 64,
             "attn_block_bwd_s785": 1 / 64, "attn_block_cls_bwd_s785": 1 / 64,
             # the fused QKV + attention kernel on its own (attn; qkv and
             # attn with the stash), and the halves on both sides of its
             # route: S = 50 (ViT-B/32), 77 causal (text), 197, 256 fused,
             # 257 the chain
             "qkv_attention": 1 / 64, "qkv_attention_stash": (1 / 64, 1 / 64),
             "qkv_attention_cls": 1 / 64, "qkv_attention_q8": 1 / 64,
             "attn_block_stash_causal": (1 / 64, 1 / 64, 1 / 64),
             **{f"{row}_{tag}": 1 / 64 for tag in ("s50", "s256") for row in (
                 "attn_block", "attn_block_cls", "attn_block_q8",
                 "attn_block_bwd_recompute")},
             "attn_block_q8_s257": 1 / 64,
             **{f"attn_block_stash_{tag}": (1 / 64, 1 / 64, 1 / 64)
                for tag in ("s50", "s256", "s257")},
             # the engine's products against fp32 products of the same
             # bf16 operands: a bf16 output 1/64, an fp32 output 1e-3
             # (summation order, and an LN'd operand that may round to
             # the neighbouring bf16 value)
             "gemm_qkv": 1 / 64, "gemm_g_wo_t": 1 / 64,
             "gemm_dqkv_weff_t": 1e-3, "gemm_g_w2_t": 1e-3,
             "gemm_dpre_w1_t": 1e-3, "gemm_dact": (1 / 64, 1 / 64, 1e-3),
             "gemm_dact_bf16": (1 / 64, 1 / 64),
             "gemm_at_xn_dpre": 1e-3, "gemm_at_yact_g": 1e-3,
             "gemm_mlp_in": (1 / 64, 1 / 64), "gemm_mlp_out": 1 / 64,
             "gemm_out_proj": 1 / 64,
             # the int8 products: the integer sum is exact on both sides
             # and the epilogue rounds step by step alike: bit for bit
             "q8_gemm_qkv": 0.0, "q8_gemm_fc": 0.0, "q8_gemm_proj": 0.0,
             # c_fc's two passes: the row maxima bit for bit; the int8
             # hidden within one step (torch's quick_gelu on the card may
             # round an ulp off the kernel's) and its scales within 1e-6
             "q8_gemm_fc_rowmax": 0.0, "q8_gemm_fc_actq": (1 / 127, 1e-6),
             # the attention backward's passes on their own: dq, dk, dv
             # 1/64 like the half-blocks; the fp32 statistics (m, 1/l, D)
             # differ in summation order only
             "attn_bwd_dq": (1 / 64, 1e-3), "attn_bwd_dkv": (1 / 64, 1 / 64)}
# the kernels that rows 14-17 launch, by their names in a profile: the LN
# pre-pass (ln_rows_kernel<PRO_LN_AFFINE = 2 | PRO_ADD_LN_AFFINE = 3>) and
# the engine's product (epilogue WGG_OUT_BF16 = 0, OUT_GELU = 3,
# OUT_GELU_EXACT = 9)
ENGINE_ROUTES = {
    "affine": ("ln_rows_kernel<2>", "wgmma_gemm_kernel<false, true, 0>"),
    "affine_quick_gelu": ("ln_rows_kernel<2>", "wgmma_gemm_kernel<false, true, 3>"),
    "affine_gelu_exact": ("ln_rows_kernel<2>", "wgmma_gemm_kernel<false, true, 9>"),
    "add_quick_gelu": ("ln_rows_kernel<3>", "wgmma_gemm_kernel<false, true, 3>")}
# the kernels that one int8 MLP half launches (rows 11 and 12): the LN
# quantize pass, c_fc with the row-max epilogue (WGG_OUT_Q8_ROWMAX = 10)
# and with the quantizing one (WGG_OUT_Q8_ACTQ = 11), c_proj with the
# residual (WGG_OUT_Q8_RESIDUAL = 8)
Q8_MLP_KERNELS = ("ln_quantize_rows_kernel", "wgmma_gemm_kernel<false, false, 10>",
                  "wgmma_gemm_kernel<false, false, 11>",
                  "wgmma_gemm_kernel<false, false, 8>")
# F6: the int8 halves' integers are held on 8 more draws of the int8 case
# weights, each from a generator of its own
F6_DRAW_SEEDS = range(1000, 1008)
# the kernels that row 8 launches: dattn = g . wo^T on the engine
# (OUT_BF16, B_MN false), then cls_bwd.cuh's three passes
CLS_BWD_KERNELS = ("wgmma_gemm_kernel<false, false, 0>", "cls_attn_bwd_kernel",
                   "cls_proj_kernel", "cls_rows_kernel")
# the products of the wgmma engine and the attention backward's two
# passes, timed on their own (phase 2)
PRODUCTS = ("gemm_qkv", "gemm_g_wo_t", "gemm_dqkv_weff_t", "gemm_g_w2_t",
            "gemm_dpre_w1_t", "gemm_dact", "gemm_dact_bf16", "gemm_at_xn_dpre",
            "gemm_at_yact_g", "gemm_mlp_in", "gemm_mlp_out", "gemm_out_proj",
            "q8_gemm_qkv", "q8_gemm_fc", "q8_gemm_proj", "q8_gemm_fc_rowmax",
            "q8_gemm_fc_actq", "attn_bwd_dq",
            "attn_bwd_dkv")
# dense peaks of an H100 SXM at 700 W (NVIDIA's data sheet): the bound of a
# kernel is max(bytes / PEAK_BYTES, int8 ops / PEAK_INT8 + bf16 FLOPs /
# PEAK_BF16), bytes = every input read once and every output written once
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
L2_BYTES = 50 * 2 ** 20
# card vs CPU plain path on the same random-init ViT-B/16 (bf16 both):
# per-row cosine of the features
MIN_COSINE = 0.999
# one bs-4 train step, card vs CPU plain path (bf16 both): the loss within
# 1% relative, and per parameter tensor of the image tower and the head
# the cosine of the two gradients at least 0.99 (the attention k-biases
# aside: their exact gradient is zero, so both are rounding noise)
STEP_LOSS_RTOL = 1e-2
STEP_MIN_GRAD_COSINE = 0.99


def _vit_l14_cut():
    """CLIP ViT-L/14 at its published widths (image tower 1024 wide, 16
    heads, patch 14 at 224 px: S = 257), cut to 4 image layers and 1 text
    layer for the card-vs-CPU step."""
    import dataclasses

    from uml_tpu_torch.models.clip import CLIP_CONFIGS

    return dataclasses.replace(CLIP_CONFIGS["ViT-L/14"], vision_layers=4,
                               transformer_layers=1)


def _check(ok, what) -> None:
    """A failed check ends the run (not an ``assert``: it must hold under
    ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


@contextlib.contextmanager
def _env(changes):
    """Set the environment variables of ``changes`` for the block (the
    value "unset" removes the variable)."""
    old = {k: os.environ.get(k) for k in changes}
    for k, v in changes.items():
        if v == "unset":
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, iters=20, warmup=3) -> float:
    """Mean wall time of ``fn`` on the card's clock (CUDA events around
    ``iters`` calls from Python): host work included, as in the
    end-to-end rates."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _input_copies(inputs):
    """``inputs`` and clones of its tensors, enough sets that together they
    hold more than twice the 50 MB L2: a timed call rotating over them
    finds its inputs in device memory, as the main path does."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in inputs
                 if isinstance(t, torch.Tensor))
    n = min(64, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tuple(inputs)] + [
        tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in inputs)
        for _ in range(n - 1)]


@functools.cache
def _capture_stream():
    """The one stream of every timing warm-up and graph capture: cuBLAS
    keeps a workspace per stream it has run on, for the whole process."""
    import torch

    return torch.cuda.Stream()


def _graph_time_ms(fn, copies, reps=5) -> float:
    """Device time of one call ``fn(*inputs)``: N calls, rotating over the
    input ``copies``, captured in one CUDA graph and replayed between two
    CUDA events, the median of ``reps`` replays divided by N.  N is 100,
    or fewer calls that still hold 5 ms of work, never fewer than the
    copies.  No host work (argument checks, allocation, the ctypes launch)
    lies inside the interval."""
    import torch

    side = _capture_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in copies[:3]:
            fn(*c)
    torch.cuda.current_stream().wait_stream(side)
    est = _time_ms(lambda: fn(*copies[0]), iters=3, warmup=1)
    n = max(len(copies), min(100, math.ceil(5.0 / max(est, 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(n):
            fn(*copies[i % len(copies)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    return sorted(times)[reps // 2]


def phase_setup():
    from uml_tpu_torch.ops import _build

    print(_gpu_line())
    t0 = time.perf_counter()
    lib = _build.build()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    # each kernel's registers / shared memory / spills, once per kernel
    seen, name = set(), ""
    with open(os.path.join(os.path.dirname(lib), "build.log")) as f:
        for line in f:
            line = line.strip()
            if "Compiling entry" in line:
                name = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and name not in seen:
                print(f"[ptxas] {name[:60]}: {line}")
                if "registers" in line:
                    seen.add(name)


def _block_weights(gen, k, m, hd, dev):
    import torch

    def rnd(*shape, std):
        return torch.randn(*shape, generator=gen, device=dev) * std

    bf = torch.bfloat16
    return dict(
        w_eff=rnd(k, 3 * hd, std=k ** -0.5).to(bf),
        b_eff=rnd(3 * hd, std=0.02),
        wo=rnd(hd, k, std=hd ** -0.5).to(bf),
        bo=rnd(k, std=0.02),
        w1=rnd(k, m, std=k ** -0.5).to(bf),
        b1=rnd(m, std=0.02),
        w2=rnd(m, k, std=m ** -0.5).to(bf),
        b2=rnd(k, std=0.02),
    )


def _bound(inputs, outputs, int8_ops=0.0, bf16_flops=0.0):
    """-> (bound ms, "bytes" or "operations") for one call."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def _attn_flops(b, s, heads, causal=False, q_rows=None, d=64):
    """4 * D per (query, key) pair: the scores and P.V of every head."""
    pairs = (s * (s + 1) // 2 if causal else
             s * (s if q_rows is None else q_rows))
    return 4.0 * b * heads * pairs * d


def _yardstick(m, k, n, int8, dev):
    """One cuBLAS product at a kernel's largest shape, timed: torch.matmul
    in bf16 or torch._int_mm in int8 (never called by the port)."""
    import torch

    if m is None:
        return None, None
    if int8:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8, device=dev)
        w = torch.randint(-127, 128, (k, n), dtype=torch.int8, device=dev)
        ms = _graph_time_ms(torch._int_mm, _input_copies((a, w)))
        return f"torch._int_mm [{m},{k}]x[{k},{n}] int8", ms
    a = torch.randn(m, k, device=dev).to(torch.bfloat16)
    w = torch.randn(k, n, device=dev).to(torch.bfloat16)
    return (f"torch.matmul [{m},{k}]x[{k},{n}] bf16",
            _graph_time_ms(torch.matmul, _input_copies((a, w))))


def _q8_case_weights(gen, k, m, hd, dev, layers=None):
    """int8 weights as the model quantizes and hands them to the ops:
    quantize_weight of random fp32 weights, stored K-major ([out, in], as
    models/clip.py caches them) and passed as [in, out] views; fp32
    biases.  Stacked on a layer axis when ``layers``."""
    import torch

    from uml_tpu_torch.ops.quant import quantize_weight

    def one():
        out = []
        for shape in ((k, 3 * hd), (hd, k), (k, m), (m, k)):
            w = torch.randn(*shape, generator=gen, device=dev) * shape[0] ** -0.5
            wq, wsc = quantize_weight(w)
            out += [wq.t().contiguous(), wsc,
                    torch.randn(shape[1], generator=gen, device=dev) * 0.02]
        return tuple(out)   # wq, wsc, b_eff, woq, wosc, bo, w1q, ..., b2

    if layers is None:
        weights = one()
    else:
        per_layer = [one() for _ in range(layers)]
        weights = tuple(torch.stack(t) for t in zip(*per_layer))
    return tuple(t.transpose(-2, -1) if t.dtype == torch.int8 else t
                 for t in weights)


def _attention_fp32(qkv, heads):
    """The witness: attention of a packed qkv [B, S, 3*H*64] in fp32 with
    unrounded probabilities, the inputs' bf16 rounding the only one ->
    [B*S, H*64] fp32."""
    import torch

    from uml_tpu_torch.ops.fused_attention import _qkv_heads

    b, s, _ = qkv.shape
    q, k, v = (t.float() for t in _qkv_heads(qkv, heads))
    p = torch.softmax((q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5, -1)
    return (p @ v).transpose(1, 2).reshape(b * s, -1)


def _int8_flips(xv, q8v, eps=1e-5):
    """The activation integers of the int8 halves on the card against the
    plain version's on the same inputs: the attention output quantized for
    the int8 out-projection, and quick_gelu(pre) for c_proj.  -> {half:
    (share of integers that differ, largest difference)}; "attn_out vs
    fp32" and "plain vs fp32" hold the card's and the plain version's
    attention integers against those of the fp32 witness (unrounded
    probabilities, _attention_fp32)."""
    import torch

    from uml_tpu_torch.ops import quant as q8

    wq, wsc, b_eff, woq, wosc, bo, w1q, w1sc, b1, w2q, w2sc, b2 = q8v
    b, s, k = xv.shape
    xf = xv.float()
    xq, xs = q8.ln_quantize_rows(xf, eps)
    qkv = (q8.q8_dot(xq, xs, wq, wsc) + b_eff).to(torch.bfloat16)
    # the plain version quantizes the attention's fp32 output, as the card
    # does (qkv_attention_q8_plain: P rounded once against the row's max)
    attn = q8.qkv_attention_q8_plain(xv, wq, wsc, b_eff, heads=12, eps=eps)
    want_attn = q8.quantize_rows(attn.reshape(b * s, -1))[0]
    exact_attn = q8.quantize_rows(_attention_fp32(qkv, 12))[0]
    # the launchers take the K-major weights themselves
    got_attn = q8._launch_attn_block_q8(xv, wq.t(), wsc, b_eff, (woq.t(), wosc),
                                        bo, 12, False, True, eps)[1]
    pre = q8.q8_dot(xq, xs, w1q, w1sc) + b1
    want_act = q8.act_quantize_rows(pre.reshape(b * s, -1), "quick_gelu")[0]
    got_act = q8._launch_mlp_block_q8(xv, w1q.t(), w1sc, b1, w2q.t(), w2sc, b2,
                                      eps)[1]
    flips = {}
    for name, got, want in (("attn_out", got_attn, want_attn),
                            ("mlp_hidden", got_act, want_act),
                            ("attn_out vs fp32", got_attn, exact_attn),
                            ("plain vs fp32", want_attn, exact_attn)):
        diff = (got[:want.numel()].view_as(want).int() - want.int()).abs()
        flips[name] = ((diff > 0).float().mean().item(), diff.max().item())
    return flips


def _attention_witness(xv, attn_w, heads=12):
    """The bf16 attention output of the fused half on the card (its stash)
    and of attention_plain, each against the fp32 witness of the card's own
    qkv -> {"card": err, "plain": err}, err = max |a - w| / max |w|."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa

    b, s, _ = xv.shape
    _, qkv, attn = fa.attn_block_stash(xv, *attn_w, heads=heads)
    w = _attention_fp32(qkv, heads)
    plain = fa.attention_plain(*fa._qkv_heads(qkv, heads), causal=False)
    plain = plain.transpose(1, 2).reshape(b * s, -1)
    scale = w.abs().max()
    return {name: ((a.float().view_as(w) - w).abs().max() / scale).item()
            for name, a in (("card", attn), ("plain", plain))}


def phase_kernels():
    """-> {port name: {max_abs_err, ms, plain_ms, bound_ms, bound_by,
    yardstick, yardstick_ms}} at the main path's shapes."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import tower_q8 as tq8
    from uml_tpu_torch.ops.fused_attention import (attn_block, attn_block_cls,
                                                   attn_block_cls_plain,
                                                   attn_block_plain)
    from uml_tpu_torch.ops.ln_matmul import mlp_block, mlp_block_plain
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops.layer_norm import layer_norm, layer_norm_plain
    from uml_tpu_torch.ops.text_tower import text_tower, text_tower_plain

    F = torch.nn.functional
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    # ViT-B/16 image layer: B=64, S=197, K=768, 12 heads, M=3072
    b, s, k, m = 64, 197, 768, 3072
    rows = b * s
    xv = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
    wv = _block_weights(gen, 768, 3072, 768, dev)
    attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
    mlp_v = (wv["w1"], wv["b1"], wv["w2"], wv["b2"])
    # CLIP text tower: B=64, S=77, K=512, 8 heads, M=2048, 12 layers
    bt, st, kt = 64, 77, 512
    rows_t = bt * st
    xt = torch.randn(bt, st, kt, generator=gen, device=dev).to(bf)
    layers = [_block_weights(gen, 512, 2048, 512, dev) for _ in range(12)]
    tower = tuple(torch.stack([l[n] for l in layers]) for n in
                  ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
    attn_t = tower[0][0], tower[1][0], tower[2][0], tower[3][0]
    # the ViT-L/14 text tower's widths: K = 768, 12 heads, M = 3072 (drawn
    # from a generator of their own, so every other case's data is drawn
    # as before)
    gen_l = torch.Generator(device=dev).manual_seed(1)
    xt_l = torch.randn(bt, st, 768, generator=gen_l, device=dev).to(bf)
    layers_l = [_block_weights(gen_l, 768, 3072, 768, dev) for _ in range(12)]
    tower_l = tuple(torch.stack([l[n] for l in layers_l]) for n in
                    ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
    del layers_l
    # the training kernels at the same ViT-B/16 layer: the backward takes
    # the plain stash forward's qkv and a random cotangent
    _, qkv_v, _ = fa.attn_block_stash_plain(xv, *attn_v, heads=12)
    _, qkv_c, _ = fa.attn_block_stash_plain(xv, *attn_v, heads=12, q_rows=1)
    g_v = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    g_c = torch.randn(64, 1, 768, generator=gen, device=dev).to(bf)
    g_t = torch.randn(bt, st, kt, generator=gen, device=dev).to(bf)
    w_eff, wo = wv["w_eff"], wv["wo"]
    # the MLP backward kernels: dy = g . w2^T in bf16 (what mlp_bwd takes)
    dy_v = torch.matmul(g_v, wv["w2"].t())
    mlp_bwd_v = (wv["b1"], wv["w1"])
    # the int8 ports: one quantized ViT-B/16 layer, the 11 full layers of
    # the image tower, one quantized text layer
    q8v = _q8_case_weights(gen, k, m, k, dev)
    q8t = _q8_case_weights(gen, kt, 4 * kt, kt, dev)
    q8_tower = _q8_case_weights(gen, k, m, k, dev, layers=11)

    # the stand-alone ops: unfolded LN params, a second residual operand,
    # q, k, v in [B, H, S, D]
    def ln_params(width):
        return (1 + 0.1 * torch.randn(width, generator=gen, device=dev),
                0.1 * torch.randn(width, generator=gen, device=dev))

    ln_v, ln_t = ln_params(k), ln_params(kt)
    qkv_w = (wv["w_eff"], wv["b_eff"])      # used as plain [K, 3K] weights
    fc_w = (wv["w1"], wv["b1"])
    x2d = xv.reshape(rows, k)
    ragged = rows - 63
    delta_v = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
    x32 = xv.float()

    def heads_qkv(bb, hh, ss, dd):
        return tuple(torch.randn(bb, hh, ss, dd, generator=gen, device=dev).to(bf)
                     for _ in range(3))

    qkv_197 = heads_qkv(b, 12, s, 64)
    qkv_2048 = heads_qkv(8, 16, 2048, 64)
    qkv_d128 = heads_qkv(8, 8, 1024, 128)

    # GEMM work of one ViT-B/16 layer (FLOPs, or int8 ops)
    qkv_f, out_f, mlp_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k, 4.0 * rows * k * m
    attn_f = _attn_flops(b, s, 12)
    text_layer_f = (2.0 * rows_t * kt * 3 * kt + 2.0 * rows_t * kt * kt
                    + 4.0 * rows_t * kt * 4 * kt)
    text_attn_f = _attn_flops(bt, st, 8, causal=True)
    # the ViT layer's qkv as the fused blocks pack it, [B, S, 3, H, D]: the
    # strided flash entry reads q, k, v in place and writes [B, S, H, D]
    qkv_packed = torch.randn(b, s, 3, 12, 64, generator=gen, device=dev).to(bf)

    def packed_views(p):
        return [p[:, :, i].transpose(1, 2) for i in range(3)]

    def flash_packed(p):
        out = torch.empty(b, s, 12, 64, dtype=bf, device=dev)
        at._flash_attention_strided(*packed_views(p), out=out.transpose(1, 2))
        return out

    ln_bf = tuple(t.to(bf) for t in ln_v)   # F.layer_norm takes x's dtype

    # (name, kernel(*inputs), plain(*inputs), inputs, int8 ops, bf16 FLOPs,
    # yardstick shape[, library call(*inputs)])
    vit_qkv = (rows, k, 3 * k, False)
    vit_fc = (rows, k, m, False)

    def q8_attn_call(fn, **kw):
        # (x, wq, wsc, b_eff, woq, wosc, bo) or, with a bf16
        # out-projection, (x, wq, wsc, b_eff, wo, bo)
        return lambda x, wq, wsc, be, *rest: fn(x, wq, wsc, be, tuple(rest[:-1]),
                                                rest[-1], **kw)

    cases = [
        ("attn_block", lambda *a: attn_block(*a, heads=12),
         lambda *a: attn_block_plain(*a, heads=12),
         (xv, *attn_v), 0, qkv_f + out_f + attn_f, vit_qkv),
        # K and V of every row, q, attention and out-projection of the CLS row
        ("attn_block_cls", lambda *a: attn_block_cls(*a, heads=12),
         lambda *a: attn_block_cls_plain(*a, heads=12),
         (xv, *attn_v), 0,
         2.0 * rows * k * 2 * k + 4.0 * b * k * k + _attn_flops(b, s, 12, q_rows=1),
         vit_qkv),
        ("mlp_block", mlp_block, mlp_block_plain, (xv, *mlp_v), 0, mlp_f, vit_fc),
        ("attn_block_causal", lambda *a: attn_block(*a, heads=8, causal=True),
         lambda *a: attn_block_plain(*a, heads=8, causal=True),
         (xt, *attn_t), 0,
         2.0 * rows_t * kt * 4 * kt + text_attn_f, (rows_t, kt, 3 * kt, False)),
        ("text_tower", lambda *a: text_tower(*a, heads=8),
         lambda *a: text_tower_plain(*a, heads=8), (xt, *tower), 0,
         12 * (text_layer_f + text_attn_f), (rows_t, kt, 4 * kt, False)),
        # the main path's shape: features encodes one class's prompts a
        # call, one prompt under the default --text_augmentation
        ("text_tower_b1", lambda *a: text_tower(*a, heads=8),
         lambda *a: text_tower_plain(*a, heads=8), (xt[:1].contiguous(), *tower), 0,
         12 * (text_layer_f + text_attn_f) / bt, (st, kt, 4 * kt, False)),
        # the ViT-L/14 text widths (K = 768, 12 heads): the chain's route
        ("text_tower_l14", lambda *a: text_tower(*a, heads=12),
         lambda *a: text_tower_plain(*a, heads=12), (xt_l, *tower_l), 0,
         12 * (text_layer_f * 9 / 4 + _attn_flops(bt, st, 12, causal=True)),
         (rows_t, 768, 3072, False)),
        ("attn_block_stash", lambda *a: fa.attn_block_stash(*a, heads=12),
         lambda *a: fa.attn_block_stash_plain(*a, heads=12),
         (xv, *attn_v), 0, qkv_f + out_f + attn_f, vit_qkv),
        ("attn_block_stash_causal",
         lambda *a: fa.attn_block_stash(*a, heads=8, causal=True),
         lambda *a: fa.attn_block_stash_plain(*a, heads=8, causal=True),
         (xt, *attn_t), 0, 2.0 * rows_t * kt * 4 * kt + text_attn_f,
         (rows_t, kt, 3 * kt, False)),
        # the fused QKV + attention kernel on its own (after the LN
        # pre-pass): the main path's inference form, the training stash,
        # the CLS form (q of the first 64 rows, K and V of all) and int8
        ("qkv_attention", lambda *a: fa.qkv_attention(*a, heads=12),
         lambda *a: fa.qkv_attention_plain(*a, heads=12),
         (xv, *attn_v[:2]), 0, qkv_f + attn_f, vit_qkv),
        ("qkv_attention_stash", lambda *a: fa.qkv_attention(*a, heads=12, stash=True),
         lambda *a: fa.qkv_attention_plain(*a, heads=12, stash=True),
         (xv, *attn_v[:2]), 0, qkv_f + attn_f, vit_qkv),
        ("qkv_attention_cls", lambda *a: fa.qkv_attention(*a, heads=12, q_rows=1),
         lambda *a: fa.qkv_attention_plain(*a, heads=12, q_rows=1),
         (xv, *attn_v[:2]), 0,
         2.0 * rows * k * 2 * k + 2.0 * b * k * k + _attn_flops(b, s, 12, q_rows=1),
         vit_qkv),
        ("qkv_attention_q8", lambda x, wq, wsc, be: q8.qkv_attention_q8(x, wq, wsc, be, heads=12),
         lambda x, wq, wsc, be: q8.qkv_attention_q8_plain(x, wq, wsc, be, heads=12),
         (xv, *q8v[:3]), qkv_f, attn_f, (rows, k, 3 * k, True)),
        # dattn = g . wo^T, the attention backward (the recomputed scores,
        # dP, dS . K, dS^T . Q and P^T . dO: 10 S^2 D per head), dxn
        ("attn_block_bwd", lambda *a: fa.attn_block_bwd(*a, heads=12),
         lambda *a: fa.attn_block_bwd_plain(*a, heads=12),
         (xv, g_v, qkv_v, w_eff, wo), 0, out_f + 2.5 * attn_f + qkv_f, vit_qkv),
        # one live query row: its bytes bound it (k and v and x read; dqkv,
        # dx and xn written).  The FLOP term counts dxn as the dense
        # [rows, 2K] x [2K, K] product over K and V, an upper bound of the
        # rank-2H form the kernel computes (~0.5 GFLOP), and stays below
        # the bytes
        ("attn_block_cls_bwd", lambda *a: fa.attn_block_cls_bwd(*a, heads=12),
         lambda *a: fa.attn_block_cls_bwd_plain(*a, heads=12),
         (xv, g_c, qkv_c, w_eff, wo), 0,
         2.0 * rows * 2 * k * k + 4.0 * b * k * k
         + 2.5 * _attn_flops(b, s, 12, q_rows=1), (rows, k, 2 * k, False)),
        ("mlp_block_stash", lm.mlp_block_stash, lm.mlp_block_stash_plain,
         (xv, *mlp_v), 0, mlp_f, vit_fc),
        # the recompute (the QKV product and the attention forward), then
        # the stash backward's work
        ("attn_block_bwd_recompute",
         lambda *a: fa.attn_block_bwd_recompute(*a, heads=12),
         lambda *a: fa.attn_block_bwd_recompute_plain(*a, heads=12),
         (xv, g_v, *attn_v[:3]), 0, 2 * qkv_f + out_f + 3.5 * attn_f, vit_qkv),
        ("attn_block_bwd_recompute_causal",
         lambda *a: fa.attn_block_bwd_recompute(*a, heads=8, causal=True),
         lambda *a: fa.attn_block_bwd_recompute_plain(*a, heads=8, causal=True),
         (xt, g_t, *attn_t[:3]), 0,
         4.0 * rows_t * kt * 3 * kt + 2.0 * rows_t * kt * kt + 3.5 * text_attn_f,
         (rows_t, kt, 3 * kt, False)),
        # pre = xn . w1 and dxn = dpre . w1^T
        ("mlp_bwd", lm.mlp_bwd, lm.mlp_bwd_plain, (xv, dy_v, *mlp_bwd_v),
         0, mlp_f, vit_fc),
        # dy, pre, dxn, dw1 and dw2: five [rows] x [K] x [M] products
        ("mlp_bwd_dw", lm.mlp_bwd_dw, lm.mlp_bwd_dw_plain,
         (xv, g_v, *mlp_bwd_v, wv["w2"]), 0, 2.5 * mlp_f, vit_fc),
        ("attn_block_q8", q8_attn_call(q8.attn_block_q8, heads=12),
         q8_attn_call(q8.attn_block_q8_plain, heads=12),
         (xv, *q8v[:6]), qkv_f + out_f, attn_f, (rows, k, 3 * k, True)),
        ("attn_block_q8_qkv",
         q8_attn_call(q8.attn_block_q8, heads=12, q8_out=False),
         q8_attn_call(q8.attn_block_q8_plain, heads=12, q8_out=False),
         (xv, *q8v[:3], wo, q8v[5]), qkv_f, out_f + attn_f,
         (rows, k, 3 * k, True)),
        ("attn_block_q8_causal",
         q8_attn_call(q8.attn_block_q8, heads=8, causal=True),
         q8_attn_call(q8.attn_block_q8_plain, heads=8, causal=True),
         (xt, *q8t[:6]), 2.0 * rows_t * kt * 4 * kt, text_attn_f,
         (rows_t, kt, 3 * kt, True)),
        ("mlp_block_q8", q8.mlp_block_q8, q8.mlp_block_q8_plain,
         (xv, *q8v[6:]), mlp_f, 0, (rows, k, m, True)),
        ("tower_q8", lambda *a: tq8.tower_q8(*a, heads=12),
         lambda *a: tq8.tower_q8_plain(*a, heads=12), (xv, *q8_tower),
         11 * (qkv_f + out_f + mlp_f), 11 * attn_f, (rows, k, m, True)),
        # the LN affine is applied in the kernel: nothing is folded per call
        ("ln_matmul", lm.ln_matmul, lm.ln_matmul_plain, (xv, *ln_v, *qkv_w), 0,
         qkv_f, vit_qkv),
        ("ln_matmul_2d", lambda *a: lm.ln_matmul(*a, activation="quick_gelu"),
         lambda *a: lm.ln_matmul_plain(*a, activation="quick_gelu"),
         (x2d, *ln_v, *fc_w), 0, mlp_f / 2, vit_fc),
        ("ln_matmul_2d_gelu_exact",
         lambda *a: lm.ln_matmul(*a, activation="gelu_exact"),
         lambda *a: lm.ln_matmul_plain(*a, activation="gelu_exact"),
         (x2d, *ln_v, *fc_w), 0, mlp_f / 2, vit_fc),
        ("add_ln_matmul", lambda *a: lm.add_ln_matmul(*a, gelu=True),
         lambda *a: lm.add_ln_matmul_plain(*a, activation="quick_gelu"),
         (xv, delta_v, *ln_v, *fc_w), 0, mlp_f / 2, vit_fc),
        # rows 14-16 on more of the shapes they take: gelu_exact on the 3-d
        # form, a row count that ends inside the engine's 128-row tile
        # (12,545 = 98 x 128 + 1), and the text tower's widths (QKV, c_fc)
        ("ln_matmul_gelu_exact",
         lambda *a: lm.ln_matmul(*a, activation="gelu_exact"),
         lambda *a: lm.ln_matmul_plain(*a, activation="gelu_exact"),
         (xv, *ln_v, *fc_w), 0, mlp_f / 2, vit_fc),
        ("ln_matmul_ragged", lambda *a: lm.ln_matmul(*a, activation="quick_gelu"),
         lambda *a: lm.ln_matmul_plain(*a, activation="quick_gelu"),
         (x2d[:ragged], *ln_v, *fc_w), 0, mlp_f / 2 * ragged / rows,
         (ragged, k, m, False)),
        ("add_ln_matmul_ragged", lambda *a: lm.add_ln_matmul(*a, gelu=True),
         lambda *a: lm.add_ln_matmul_plain(*a, activation="quick_gelu"),
         (x2d[:ragged], delta_v.view(rows, k)[:ragged], *ln_v, *fc_w), 0,
         mlp_f / 2 * ragged / rows, (ragged, k, m, False)),
        ("ln_matmul_text", lm.ln_matmul, lm.ln_matmul_plain,
         (xt, *ln_t, *attn_t[:2]), 0, 2.0 * rows_t * kt * 3 * kt,
         (rows_t, kt, 3 * kt, False)),
        ("add_ln_matmul_text", lambda *a: lm.add_ln_matmul(*a, gelu=True),
         lambda *a: lm.add_ln_matmul_plain(*a, activation="quick_gelu"),
         (xt, g_t, *ln_t, layers[0]["w1"], layers[0]["b1"]), 0,
         2.0 * rows_t * kt * 4 * kt, (rows_t, kt, 4 * kt, False)),
        ("ln_qkv_attention", lambda *a: fa.ln_qkv_attention(*a, heads=12),
         lambda *a: fa.ln_qkv_attention_plain(*a, heads=12),
         (xv, *ln_v, *qkv_w), 0, qkv_f + attn_f, vit_qkv),
        ("ln_qkv_attention_causal",
         lambda *a: fa.ln_qkv_attention(*a, heads=8, causal=True),
         lambda *a: fa.ln_qkv_attention_plain(*a, heads=8, causal=True),
         (xt, *ln_t, *attn_t[:2]), 0,
         2.0 * rows_t * kt * 3 * kt + text_attn_f, (rows_t, kt, 3 * kt, False)),
        ("layer_norm", layer_norm, layer_norm_plain, (xv, *ln_v), 0, 0,
         (None,) * 4, lambda x, *_: F.layer_norm(x, (k,), *ln_bf)),
        ("layer_norm_f32", layer_norm, layer_norm_plain, (x32, *ln_v), 0, 0,
         (None,) * 4, lambda x, sc, bi: F.layer_norm(x, (k,), sc, bi)),
        ("flash_attention", at.flash_attention, at.attention_plain, qkv_197, 0,
         _attn_flops(b, s, 12), (None,) * 4, F.scaled_dot_product_attention),
        ("flash_attention_2048", at.flash_attention, at.attention_plain,
         qkv_2048, 0, _attn_flops(8, 2048, 16), (None,) * 4,
         F.scaled_dot_product_attention),
        ("flash_attention_2048_causal",
         lambda *a: at.flash_attention(*a, causal=True),
         lambda *a: at.attention_plain(*a, causal=True), qkv_2048, 0,
         _attn_flops(8, 2048, 16, causal=True), (None,) * 4,
         lambda *a: F.scaled_dot_product_attention(*a, is_causal=True)),
        ("flash_attention_d128", at.flash_attention, at.attention_plain,
         qkv_d128, 0, _attn_flops(8, 1024, 8, d=128), (None,) * 4,
         F.scaled_dot_product_attention),
        ("flash_attention_packed", flash_packed,
         lambda p: at.attention_plain(*packed_views(p)).transpose(1, 2),
         (qkv_packed,), 0, _attn_flops(b, s, 12), (None,) * 4,
         lambda p: F.scaled_dot_product_attention(*packed_views(p))),
    ]
    cases += (_long_seq_cases(gen, dev, attn_v)
              + _route_cases(gen, dev, attn_v, q8v)
              + _product_cases(gen, dev, xv, g_v, wv, qkv_v))
    results = {}
    for name, kernel_fn, plain_fn, inputs, ops8, flops16, yard, *library in cases:
        got = kernel_fn(*inputs)
        want = plain_fn(*inputs)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rels = 0.0, []
        bounds = REL_BOUND[name]
        bounds = bounds if isinstance(bounds, tuple) else (bounds,) * len(got)
        for a, b_, bound in zip(got, want, bounds, strict=True):
            _check(a.shape == b_.shape, (name, a.shape, b_.shape))
            _check(bool(torch.isfinite(a.float()).all()), f"{name}: non-finite")
            e = (a.float() - b_.float()).abs().max().item()
            scale = b_.float().abs().max().item()
            _check(e <= bound * scale, f"{name}: {e} > {bound} of {scale}")
            err = max(err, e)
            rels.append(e / scale)
        del want
        rel = max(rels)
        copies = _input_copies(inputs)
        ms = _graph_time_ms(kernel_fn, copies)
        plain_ms = _graph_time_ms(plain_fn, copies)
        library_ms = _graph_time_ms(library[0], copies) if library else None
        del copies
        bound_ms, bound_by = _bound(inputs, got, ops8, flops16)
        yard_call, yard_ms = _yardstick(*yard[:3], yard[3], dev)
        print(f"[kernels] {name:20s} shapes {[tuple(a.shape) for a in got]} "
              f"max_abs_err {err:.5f} max_rel_err {rel:.5f} (bounds "
              f"{', '.join(f'{x:.1e}' for x in bounds)}; per output "
              f"{', '.join(f'{r:.2e}' for r in rels)}) kernel {ms:.4f} ms "
              f"plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by}) "
              + (f"yardstick {yard_call} {yard_ms:.4f} ms" if yard_call else
                 f"library call {library_ms:.4f} ms" if library else
                 "no yardstick"))
        results[name] = {"max_abs_err": err, "max_rel_err": rel, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "yardstick": yard_call,
                         "yardstick_ms": yard_ms, "library_ms": library_ms}
        del got
    # the streaming kernel against the dense twin that keeps its scores in
    # bf16 (mha_plain, the backward's function): recorded, not held
    for tag, qkv in (("S=197", qkv_197), ("S=2048", qkv_2048)):
        a, b_ = at.flash_attention(*qkv).float(), at.mha_plain(*qkv).float()
        print(f"[kernels] flash_attention vs mha_plain {tag}: max_rel_err "
              f"{((a - b_).abs().max() / b_.abs().max()).item():.5f}")
        del a, b_
    # the int8 halves' activation integers on phase 2's draw of the int8
    # weights and on F6's 8 draws, each from a generator of its own
    draws = [("phase 2", lambda: q8v)] + [
        (f"draw {seed}", lambda seed=seed: _q8_case_weights(
            torch.Generator(device=dev).manual_seed(seed), k, m, k, dev))
        for seed in F6_DRAW_SEEDS]
    for tag, weights in draws:
        flips = _int8_flips(xv, weights())
        for half in ("attn_out", "mlp_hidden"):
            share, worst = flips[half]
            print(f"[kernels] int8 integers ({tag}), {half}: {100 * share:.4f}% "
                  f"differ from the plain version's, largest difference {worst}")
            _check(worst <= 1, (tag, half, "integer differs by more than one step",
                                worst))
        # the second witness: both sides against fp32 attention with
        # unrounded probabilities (recorded, not held)
        for half in ("attn_out vs fp32", "plain vs fp32"):
            share, worst = flips[half]
            print(f"[kernels] int8 integers ({tag}), {half}: {100 * share:.4f}% "
                  f"differ, largest difference {worst}")
    wit = _attention_witness(xv, attn_v)
    print(f"[kernels] bf16 attention vs the fp32 witness, max |err| / max: "
          f"card {wit['card']:.6f}, attention_plain {wit['plain']:.6f}")
    # row 19 runs both products on the engine: no wmma ln_gemm launch
    names = _kernel_names(_profile("row 19 mlp_bwd",
                                   lambda: lm.mlp_bwd(xv, dy_v, *mlp_bwd_v)))
    _check(not any("ln_gemm_kernel" in n for n in names)
           and sum("wgmma_gemm_kernel" in n for n in names) == 2,
           ("row 19: the two products on the engine, no wmma", names))
    # rows 14-16 launch the LN pre-pass and one engine product and nothing
    # else, row 17 the attention besides (kept on the kernels line)
    for row, fn, route in (
            ("ln_matmul", lambda: lm.ln_matmul(xv, *ln_v, *qkv_w), ENGINE_ROUTES["affine"]),
            ("ln_matmul_2d",
             lambda: lm.ln_matmul(x2d, *ln_v, *fc_w, activation="quick_gelu"),
             ENGINE_ROUTES["affine_quick_gelu"]),
            ("ln_matmul_gelu_exact",
             lambda: lm.ln_matmul(xv, *ln_v, *fc_w, activation="gelu_exact"),
             ENGINE_ROUTES["affine_gelu_exact"]),
            ("add_ln_matmul", lambda: lm.add_ln_matmul(xv, delta_v, *ln_v, *fc_w, gelu=True),
             ENGINE_ROUTES["add_quick_gelu"]),
            ("ln_qkv_attention", lambda: fa.ln_qkv_attention(xv, *ln_v, *qkv_w, heads=12),
             ENGINE_ROUTES["affine"] + ("flash_attention_kernel",))):
        names = _kernel_names(_profile(f"{row} (the engine's route)", fn))
        _check(len(names) == len(route)
               and all(sum(part in n for n in names) == 1 for part in route)
               and not any("ln_gemm_kernel" in n for n in names),
               (f"{row}: the LN pre-pass and the engine only", route, names))
        results[row]["engine_kernels"] = list(route)
    # rows 5 and 10 at S = 197 run the fused QKV + attention kernel: no
    # flash_attention, and the out-projection is their one engine product
    for row, fn, out_proj in (
            ("row 5 attn_block_stash", lambda: fa.attn_block_stash(xv, *attn_v, heads=12),
             "wgmma_gemm_kernel<false, true, 4>"),
            ("row 10 attn_block_q8",
             lambda: q8.attn_block_q8(xv, *q8v[:3], q8v[3:5], q8v[5], heads=12),
             "wgmma_gemm_kernel<false, false, 8>")):
        names = _kernel_names(_profile(row, fn))
        _check(sum("qkv_attention_kernel" in n for n in names) == 1
               and not any("flash_attention_kernel" in n for n in names)
               and [n for n in names if "wgmma_gemm_kernel" in n] == [
                   n for n in names if out_proj in n] and len(
                   [n for n in names if out_proj in n]) == 1,
               (f"{row}: the fused kernel and the out-projection only", names))
    # row 11: the LN quantize pass, c_fc twice (the row maxima, then the
    # int8 hidden) and c_proj, and no pass over an fp32 pre-activation
    names = _kernel_names(_profile("row 11 mlp_block_q8",
                                   lambda: q8.mlp_block_q8(xv, *q8v[6:])))
    _check(len(names) == len(Q8_MLP_KERNELS)
           and all(sum(part in n for n in names) == 1 for part in Q8_MLP_KERNELS)
           and not any("act_quantize_rows" in n for n in names),
           ("row 11: ln_quantize_rows, ROWMAX, ACTQ and c_proj only", names))
    results["mlp_block_q8"]["profile_kernels"] = names
    # row 4 at S = 77: one launch of the tower kernel a call, nothing else
    # (no qkv_attention, no engine product); row 8: dattn on the engine,
    # then the three passes of cls_bwd.cuh, and no dense dxn product
    # (OUT_F32) and no LN backward over an fp32 dxn
    for row, fn in (("text_tower", lambda: text_tower(xt, *tower, heads=8)),
                    ("text_tower_b1", lambda: text_tower(xt[:1], *tower, heads=8))):
        rows_p = _profile(f"row 4 {row} (one launch a call)", fn)
        _check(len(rows_p) == 1 and "text_tower_kernel" in rows_p[0][0]
               and rows_p[0][2] == 3, (f"{row}: one tower kernel a call", rows_p))
        results[row]["profile_kernels"] = _kernel_names(rows_p)
    names = _kernel_names(_profile(
        "row 8 attn_block_cls_bwd",
        lambda: fa.attn_block_cls_bwd(xv, g_c, qkv_c, w_eff, wo, heads=12)))
    _check(len(names) == len(CLS_BWD_KERNELS)
           and all(sum(part in n for n in names) == 1 for part in CLS_BWD_KERNELS)
           and not any("wgmma_gemm_kernel<false, false, 1>" in n or "ln_bwd_kernel" in n
                       for n in names),
           ("row 8: dattn and the three rank-2H passes only", names))
    results["attn_block_cls_bwd"]["profile_kernels"] = names
    _check_routes(gen, dev)
    return results


def _kernel_names(rows):
    """The names of a ``_profile`` result: every kernel, memcpy and memset
    the card ran (the port's and PyTorch's), no ``record_function``
    range."""
    return [key for key, _, _ in rows]


def _long_seq_cases(gen, dev, attn_v):
    """Phase-2 cases past the old shared-memory gates: the attention
    halves, the CLS half and the backwards at S = 257 (ViT-L/14: K = 1024,
    16 heads, B = 48) and S = 785 (ViT-B/16 widths, B = 16), ~12,500 rows
    each like the ViT-B/16 layer at B = 64."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa

    bf = torch.bfloat16
    wl = _block_weights(gen, 1024, 4096, 1024, dev)
    attn_l = (wl["w_eff"], wl["b_eff"], wl["wo"], wl["bo"])
    cases = []
    for tag, b, s, k, heads, attn in (("s257", 48, 257, 1024, 16, attn_l),
                                      ("s785", 16, 785, 768, 12, attn_v)):
        x = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
        g = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
        g1 = torch.randn(b, 1, k, generator=gen, device=dev).to(bf)
        rows = b * s
        qkv_f, out_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k
        attn_f = _attn_flops(b, s, heads)
        yard = (rows, k, 3 * k, False)
        cases += [
            (f"attn_block_{tag}", lambda *a, h=heads: fa.attn_block(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_plain(*a, heads=h), (x, *attn), 0,
             qkv_f + out_f + attn_f, yard),
            (f"attn_block_cls_{tag}", lambda *a, h=heads: fa.attn_block_cls(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_cls_plain(*a, heads=h), (x, *attn), 0,
             2.0 * rows * k * 2 * k + 4.0 * b * k * k
             + _attn_flops(b, s, heads, q_rows=1), yard),
            (f"attn_block_bwd_recompute_{tag}",
             lambda *a, h=heads: fa.attn_block_bwd_recompute(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_bwd_recompute_plain(*a, heads=h),
             (x, g, *attn[:3]), 0, 2 * qkv_f + out_f + 3.5 * attn_f, yard),
        ]
        if tag == "s785":
            _, qkv, _ = fa.attn_block_stash_plain(x, *attn, heads=heads)
            _, qkv_c, _ = fa.attn_block_stash_plain(x, *attn, heads=heads, q_rows=1)
            cases += [
                ("attn_block_bwd_s785", lambda *a: fa.attn_block_bwd(*a, heads=12),
                 lambda *a: fa.attn_block_bwd_plain(*a, heads=12),
                 (x, g, qkv, attn[0], attn[2]), 0, out_f + 2.5 * attn_f + qkv_f, yard),
                ("attn_block_cls_bwd_s785", lambda *a: fa.attn_block_cls_bwd(*a, heads=12),
                 lambda *a: fa.attn_block_cls_bwd_plain(*a, heads=12),
                 (x, g1, qkv_c, attn[0], attn[2]), 0,
                 2.0 * rows * 2 * k * k + 4.0 * b * k * k
                 + 2.5 * _attn_flops(b, s, heads, q_rows=1), (rows, k, 2 * k, False)),
            ]
    return cases


def _route_cases(gen, dev, attn_v, q8v):
    """Phase-2 cases of the attention halves on both sides of the fused
    kernel's route (csrc/qkv_attention.cu for S <= 256): rows 1, 2, 5, 10
    and 7 at S = 50 (ViT-B/32: K = 768, 12 heads, B = 64) and S = 256
    (ViT-B/16 widths, B = 48) on the fused kernel, and rows 5 and 10 at
    S = 257 (ViT-L/14: K = 1024, 16 heads, B = 48) on the chain, beside
    rows 1, 2 and 7 at 257 (_long_seq_cases); S = 77 causal and 197 are
    phase 2's own cases."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import quant as q8

    bf = torch.bfloat16
    wl = _block_weights(gen, 1024, 4096, 1024, dev)
    attn_l = (wl["w_eff"], wl["b_eff"], wl["wo"], wl["bo"])
    q8l = _q8_case_weights(gen, 1024, 4096, 1024, dev)

    def q8_call(fn, heads):
        return lambda x, wq, wsc, be, wo, wosc, bo: fn(x, wq, wsc, be, (wo, wosc), bo,
                                                       heads=heads)

    cases = []
    for tag, b, s, k, heads, attn, qw in (("s50", 64, 50, 768, 12, attn_v, q8v),
                                          ("s256", 48, 256, 768, 12, attn_v, q8v),
                                          ("s257", 48, 257, 1024, 16, attn_l, q8l)):
        x = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
        g = torch.randn(b, s, k, generator=gen, device=dev).to(bf)
        rows = b * s
        qkv_f, out_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k
        attn_f = _attn_flops(b, s, heads)
        yard = (rows, k, 3 * k, False)
        cases += [
            (f"attn_block_stash_{tag}", lambda *a, h=heads: fa.attn_block_stash(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_stash_plain(*a, heads=h), (x, *attn), 0,
             qkv_f + out_f + attn_f, yard),
            (f"attn_block_q8_{tag}", q8_call(q8.attn_block_q8, heads),
             q8_call(q8.attn_block_q8_plain, heads), (x, *qw[:6]), qkv_f + out_f, attn_f,
             (rows, k, 3 * k, True)),
        ]
        if tag == "s257":
            continue
        cases += [
            (f"attn_block_{tag}", lambda *a, h=heads: fa.attn_block(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_plain(*a, heads=h), (x, *attn), 0,
             qkv_f + out_f + attn_f, yard),
            (f"attn_block_cls_{tag}", lambda *a, h=heads: fa.attn_block_cls(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_cls_plain(*a, heads=h), (x, *attn), 0,
             2.0 * rows * k * 2 * k + 4.0 * b * k * k
             + _attn_flops(b, s, heads, q_rows=1), yard),
            (f"attn_block_bwd_recompute_{tag}",
             lambda *a, h=heads: fa.attn_block_bwd_recompute(*a, heads=h),
             lambda *a, h=heads: fa.attn_block_bwd_recompute_plain(*a, heads=h),
             (x, g, *attn[:3]), 0, 2 * qkv_f + out_f + 3.5 * attn_f, yard),
        ]
    return cases


def _check_routes(gen, dev):
    """The route each S takes, by the launch counters: the bf16 halves
    (rows 1, 2, 5 and 7) and the int8 half (row 10) count one launch of
    the fused kernel each at S = 50, 77 (causal), 197 and 256, none at
    257."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import quant as q8

    bf = torch.bfloat16
    seen = []
    for s, k, heads, causal in ((50, 768, 12, False), (77, 512, 8, True),
                                (197, 768, 12, False), (256, 768, 12, False),
                                (257, 1024, 16, False)):
        x = torch.randn(2, s, k, generator=gen, device=dev).to(bf)
        w = _block_weights(gen, k, 4 * k, k, dev)
        attn = (w["w_eff"], w["b_eff"], w["wo"], w["bo"])
        qw = _q8_case_weights(gen, k, 4 * k, k, dev)
        n, n8 = fa.qkv_attention.launches, q8.qkv_attention_q8.launches
        fa.attn_block(x, *attn, heads=heads, causal=causal)
        fa.attn_block_stash(x, *attn, heads=heads, causal=causal)
        fa.attn_block_bwd_recompute(x, x, *attn[:3], heads=heads, causal=causal)
        halves = 3
        if not causal:
            fa.attn_block_cls(x, *attn, heads=heads)
            halves += 1
        q8.attn_block_q8(x, *qw[:3], qw[3:5], qw[5], heads=heads, causal=causal)
        torch.cuda.synchronize()
        fused = s <= 256
        got = (fa.qkv_attention.launches - n, q8.qkv_attention_q8.launches - n8)
        _check(got == (halves * fused, int(fused)), ("route", s, got, fused))
        seen.append(f"S={s} {'fused' if fused else 'chain'} {got}")
    print(f"[kernels] attention halves' route by the launch counters: {'; '.join(seen)}")


def _product_cases(gen, dev, xv, g_v, wv, qkv_v):
    """Phase-2 cases of the products that the half-blocks and the training
    rows launch on the wgmma engine, one by one through ops/gemm.py, at
    ViT-B/16 B=64 (12,608 rows, K = 768, M = 3072), each with cuBLAS at its
    shape as the yardstick: the QKV triple (with its LN pre-pass), g .
    wo^T, the three fp32 products with a transposed weight, the dW
    recompute (with its LN pre-pass, the fp32 dy read and two outputs
    written), both gemm_at, the MLP in with its pre-activation stash (with
    its LN pre-pass, two outputs written), the MLP out and the
    out-projection with the residual, row 19's recompute with a bf16 dy;
    the int8 products (QKV with the bf16 epilogue, c_fc with the fp32 one,
    c_proj with the residual, c_fc's row-max and quantizing passes) on
    random integers with torch._int_mm at their shape as the yardstick;
    then the attention backward's dq
    pass and dkv pass (ops/fused_attention.py::attn_bwd) on the plain
    stash's qkv, the dkv pass from the plain dq pass's statistics."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import gemm as gm

    bf = torch.bfloat16
    b, s, k = xv.shape
    rows, m = b * s, wv["w1"].shape[1]
    x2d, g2d = xv.reshape(rows, k), g_v.reshape(rows, k)
    dqkv = torch.randn(rows, 3 * k, generator=gen, device=dev).to(bf)
    dpre = torch.randn(rows, m, generator=gen, device=dev).to(bf)
    dy = torch.randn(rows, m, generator=gen, device=dev)
    dy16 = torch.randn(rows, m, generator=gen, device=dev).to(bf)
    hidden = torch.randn(rows, m, generator=gen, device=dev).to(bf)
    attn = torch.randn(rows, k, generator=gen, device=dev).to(bf)
    dattn = torch.matmul(g_v, wv["wo"].t())
    _, stats = fa.attn_bwd_plain(qkv_v, dattn, heads=12)

    def bwd_pass(fn):
        return lambda qkv, do, *st: fn(qkv, do, heads=12, stats=st[0] if st else None)

    attn_f = _attn_flops(b, s, 12)

    def triple(name):
        return (lambda *a: gm.ln_gemm(*a, triple=name),
                lambda *a: gm.ln_gemm_plain(*a, triple=name))

    def q8_product(n_in, n_out, epi):
        # row-quantized activations, a K-major weight, scales, bias (and
        # the residual): the operands of one int8 product of rows 10-12
        def ints(*shape):
            return torch.randint(-127, 128, shape, generator=gen, device=dev,
                                 dtype=torch.int8)

        def scales(n):
            return torch.rand(n, generator=gen, device=dev) * 0.02 + 1e-3

        ops = (ints(rows, n_in), ints(n_out, n_in), scales(rows), scales(n_out),
               0.02 * torch.randn(n_out, generator=gen, device=dev))
        if epi == "RESIDUAL":
            ops += (torch.randn(rows, n_out, generator=gen, device=dev).to(bf),)
        if epi == "ACTQ":
            # the row maxima of the ROWMAX pass over the same operands
            ops += (gm.q8_gemm_plain(*ops, epi="ROWMAX"),)
            return (lambda *a: gm.q8_gemm(*a[:5], epi=epi, rowmax=a[5]),
                    lambda *a: gm.q8_gemm_plain(*a[:5], epi=epi, rowmax=a[5]), ops,
                    2.0 * rows * n_in * n_out, 0, (rows, n_in, n_out, True))
        return (lambda *a: gm.q8_gemm(*a, epi=epi),
                lambda *a: gm.q8_gemm_plain(*a, epi=epi), ops, 2.0 * rows * n_in * n_out,
                0, (rows, n_in, n_out, True))

    qkv_f, out_f, fc_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k, 2.0 * rows * k * m
    return [
        ("gemm_qkv", *triple("QKV"), (x2d, wv["w_eff"], wv["b_eff"]), 0, qkv_f,
         (rows, k, 3 * k, False)),
        ("gemm_g_wo_t", *triple("TRANS_B"), (g2d, wv["wo"]), 0, out_f,
         (rows, k, k, False)),
        ("gemm_dqkv_weff_t", *triple("TRANS_B_F32"), (dqkv, wv["w_eff"]), 0, qkv_f,
         (rows, 3 * k, k, False)),
        ("gemm_g_w2_t", *triple("TRANS_B_F32"), (g2d, wv["w2"]), 0, fc_f,
         (rows, k, m, False)),
        ("gemm_dpre_w1_t", *triple("TRANS_B_F32"), (dpre, wv["w1"]), 0, fc_f,
         (rows, m, k, False)),
        ("gemm_dact", *triple("DACT_F32"), (x2d, wv["w1"], wv["b1"], dy), 0, fc_f,
         (rows, k, m, False)),
        ("gemm_at_xn_dpre", gm.gemm_at, gm.gemm_at_plain, (x2d, dpre), 0, fc_f,
         (k, rows, m, False)),
        ("gemm_at_yact_g", gm.gemm_at, gm.gemm_at_plain, (dpre, g2d), 0, fc_f,
         (m, rows, k, False)),
        ("gemm_mlp_in", *triple("GELU_STASH"), (x2d, wv["w1"], wv["b1"]), 0, fc_f,
         (rows, k, m, False)),
        ("gemm_mlp_out", *triple("RESIDUAL"), (hidden, wv["w2"], wv["b2"], x2d), 0,
         fc_f, (rows, m, k, False)),
        ("gemm_out_proj", *triple("RESIDUAL"), (attn, wv["wo"], wv["bo"], x2d), 0,
         out_f, (rows, k, k, False)),
        ("gemm_dact_bf16", *triple("DACT"), (x2d, wv["w1"], wv["b1"], dy16), 0, fc_f,
         (rows, k, m, False)),
        ("q8_gemm_qkv", *q8_product(k, 3 * k, "BF16")),
        ("q8_gemm_fc", *q8_product(k, m, "F32")),
        ("q8_gemm_proj", *q8_product(m, k, "RESIDUAL")),
        # the int8 MLP in's two passes: the row maxima, then the int8 hidden
        ("q8_gemm_fc_rowmax", *q8_product(k, m, "ROWMAX")),
        ("q8_gemm_fc_actq", *q8_product(k, m, "ACTQ")),
        # the least work of each pass: S, dP and dS . K (dq), S^T, dP^T,
        # P^T . dO and dS^T . Q (dkv), 2 S^2 D FLOPs each a head; the dq
        # pass walks the keys twice (S and dP again), which is not counted
        ("attn_bwd_dq", bwd_pass(fa.attn_bwd), bwd_pass(fa.attn_bwd_plain),
         (qkv_v, dattn), 0, 1.5 * attn_f, (None,) * 4),
        ("attn_bwd_dkv", bwd_pass(fa.attn_bwd), bwd_pass(fa.attn_bwd_plain),
         (qkv_v, dattn, stats), 0, 2.0 * attn_f, (None,) * 4),
    ]


def _wrappers():
    """Every port's wrapper by its name in PORTS: each counts its launches
    on ``.launches``."""
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import text_tower as tt
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import layer_norm
    from uml_tpu_torch.ops import tower_q8 as tq8

    return {"flash_attention": at.flash_attention, "ln_matmul": lm.ln_matmul,
            "add_ln_matmul": lm.add_ln_matmul,
            "ln_qkv_attention": fa.ln_qkv_attention, "layer_norm": layer_norm,
            "attn_block": fa.attn_block, "attn_block_cls": fa.attn_block_cls,
            "mlp_block": lm.mlp_block, "text_tower": tt.text_tower,
            "attn_block_stash": fa.attn_block_stash,
            "attn_block_bwd": fa.attn_block_bwd,
            "attn_block_cls_bwd": fa.attn_block_cls_bwd,
            "mlp_block_stash": lm.mlp_block_stash,
            "attn_block_q8": q8.attn_block_q8, "mlp_block_q8": q8.mlp_block_q8,
            "tower_q8": tq8.tower_q8,
            "attn_block_bwd_recompute": fa.attn_block_bwd_recompute,
            "mlp_bwd": lm.mlp_bwd, "mlp_bwd_dw": lm.mlp_bwd_dw,
            "qkv_attention": fa.qkv_attention,
            "qkv_attention_q8": q8.qkv_attention_q8}


def _with_fused(want):
    """``want`` with the fused QKV + attention kernel's launches: one for
    each bf16 attention half launched at S <= 256 (every ViT-B/16 and
    text half here)."""
    return {**want, "qkv_attention": sum(want.get(k, 0) for k in (
        "attn_block", "attn_block_cls", "attn_block_stash",
        "attn_block_bwd_recompute"))}


def _counted(fn):
    """Run ``fn`` with every launch counter set to 0 just before it ->
    (its result, {port: launches} read just after)."""
    import torch

    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: w.launches for name, w in wrappers.items()}


def make_fixture(root, n_classes=8, per_class=(16, 4, 8)):
    """A caltech-101 tree (the layout of tests' make_caltech_fixture) with
    random-noise JPEGs, plus its split_zhou_Caltech101.json."""
    import numpy as np
    from PIL import Image

    from uml_tpu_torch.utils.io import save_as_json

    rng = np.random.default_rng(0)
    img_dir = os.path.join(root, "caltech-101", "101_ObjectCategories")
    split = {"train": [], "val": [], "test": []}
    for label in range(n_classes):
        cname = f"class_{label}"
        os.makedirs(os.path.join(img_dir, cname), exist_ok=True)
        counter = 0
        for part, n in zip(("train", "val", "test"), per_class):
            for _ in range(n):
                rel = f"{cname}/img_{counter:03d}.jpg"
                pixels = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
                Image.fromarray(pixels).save(os.path.join(img_dir, rel))
                split[part].append((rel, label, cname))
                counter += 1
    save_as_json(split, os.path.join(root, "caltech-101",
                                     "split_zhou_Caltech101.json"))
    return {part: len(v) for part, v in split.items()}


def _decode_rates(root, passes=3):
    """The host's decode rate: data/loader.py's ImageBatchLoader (threaded
    PIL decode, resize and center crop to 224 x 224 uint8) over every JPEG
    of the fixture (240 x 320 noise), ``passes`` times, batches of 64, with
    one worker and with one per core -> {key: img/s}."""
    import glob

    from uml_tpu_torch.data.loader import ImageBatchLoader

    items = [{"impath": p, "label": 0} for p in sorted(glob.glob(
        os.path.join(root, "caltech-101", "101_ObjectCategories", "*", "*.jpg")))]
    _check(len(items) > 0, "fixture JPEGs")
    out = {}
    for workers in (1, os.cpu_count() or 1):
        t0 = time.perf_counter()
        n = 0
        for _ in range(passes):
            for imgs, _, _ in ImageBatchLoader(items, "crop", 64, num_workers=workers):
                n += len(imgs)
        rate = n / (time.perf_counter() - t0)
        out[f"pil_decode_img_per_s_{workers}w"] = rate
        print(f"[main] PIL decode (data/loader.py ImageBatchLoader, 240x320 JPEG "
              f"-> 224x224 crop, batches of 64), {workers} worker(s): {n} images, "
              f"{rate:.1f} img/s")
    return out


def _features_args(root, batch, feature_dir, quant="none"):
    from uml_tpu_torch.cli import features as feat

    args = feat.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", feature_dir, "--dataset", "caltech101",
        "--clip-encoder", "ViT-B/16", "--allow-random-init",
        "--train-shot", "16", "--seed", "1",
        "--text-augmentation", "hand_crafted", "--batch-size", str(batch),
        "--quant", quant])
    args.overwrite = False
    args.force_rerun = False
    return args


def _check_caches(feature_dir, sizes, n_classes):
    """The image caches of the three splits and the text cache hold finite
    width-512 features -> (train, test, text) caches."""
    import numpy as np

    from uml_tpu_torch.data.feature_cache import img_outdir, load_cache, text_outdir

    img_path = img_outdir(feature_dir, "ViT-B/16", "caltech101", "crop",
                          16, 1, "train")
    test_path = img_outdir(feature_dir, "ViT-B/16", "caltech101", "crop",
                           16, 1, "test")
    txt_path = text_outdir(feature_dir, "ViT-B/16", "caltech101",
                           "hand_crafted")
    img, test, txt = load_cache(img_path), load_cache(test_path), load_cache(txt_path)
    for name, split, n in (("train", img["train"], sizes["train"]),
                           ("val", img["val"], sizes["val"]),
                           ("test", test, sizes["test"])):
        f = split["features"]
        _check(f.shape == (n, 512) and np.isfinite(f).all(), (name, f.shape))
    _check(txt["features"].shape == (n_classes, 512)
           and np.isfinite(txt["features"]).all(),
           ("text", txt["features"].shape))
    print(f"[caches] written: {img_path} {test_path} {txt_path}")
    return img, test, txt


def _cos_min(a, b):
    import numpy as np

    return float(((a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                      * np.linalg.norm(b, axis=-1))).min())


def _card_vs_cpu_features(encoder, test_paths, tag):
    """The card's features against the same model on the CPU (plain
    path): 4 images and 2 prompts -> (min cosine image, text)."""
    import numpy as np
    import torch

    from uml_tpu_torch.data.loader import ImageBatchLoader
    from uml_tpu_torch.models.tokenizer import tokenize

    cpu_model = copy.deepcopy(encoder.model).to("cpu")
    imgs, _, _ = next(iter(ImageBatchLoader(
        [{"impath": p, "label": 0} for p in test_paths[:4]], batch_size=4,
        num_workers=1)))
    gpu_f = encoder.encode_images(imgs)
    prompts = ["a photo of a class_0.", "a photo of a class_1."]
    gpu_t, _ = encoder.encode_texts(prompts)
    with torch.no_grad():
        cpu_f = cpu_model.encode_image_u8(
            torch.from_numpy(imgs.reshape(4, -1))).numpy()
        cpu_t = cpu_model.encode_text(
            torch.from_numpy(tokenize(prompts).astype(np.int64))).numpy()
    cos_img, cos_txt = _cos_min(gpu_f, cpu_f), _cos_min(gpu_t, cpu_t)
    print(f"[{tag}] card vs CPU plain path: min cosine image {cos_img:.6f} "
          f"text {cos_txt:.6f} (bound {MIN_COSINE})")
    _check(cos_img >= MIN_COSINE and cos_txt >= MIN_COSINE,
           f"{tag}: card vs CPU cosine {cos_img}, {cos_txt}")
    return cos_img, cos_txt


def phase_main_path():
    """-> ({port name: launches}, images/s numbers, fixture root, split
    sizes, the bf16 encoder)."""
    import numpy as np

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.cli import generate_fewshot as gf

    root = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sizes = make_fixture(root)
    decode = _decode_rates(root)
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "16", "--seed", "1"]))
    batch = 64
    args = _features_args(root, batch, f"{root}/features")
    t0 = time.perf_counter()
    encoder, launches = _counted(lambda: feat.main(args))
    wall = time.perf_counter() - t0
    print(f"[main] features CLI {wall:.2f} s (random init, decode, 3 splits, "
          f"text); launches {launches}")

    # expected counts: per image batch 11 full attention halves, 1 CLS
    # half and 12 MLP halves; one text_tower call per class prompt batch,
    # one launch of the tower kernel (S = 77), which launches no
    # qkv_attention; the fused QKV + attention kernel once in each
    # attention half (S = 197)
    n_batches = sum(-(-n // batch) for n in (sizes["train"], sizes["val"],
                                           sizes["test"]))
    n_classes = 8
    want = dict.fromkeys(launches, 0)
    want.update({"attn_block": 11 * n_batches, "attn_block_cls": n_batches,
                 "mlp_block": 12 * n_batches, "text_tower": n_classes,
                 "qkv_attention": 12 * n_batches})
    _check(launches == want, (launches, want))
    _check(all(p.device.type == "cuda" for p in encoder.model.parameters()),
           "encoder parameters on the card")
    _, test, _ = _check_caches(args.feature_dir, sizes, n_classes)
    _card_vs_cpu_features(encoder, test["paths"], "main")

    # steady-state encoder throughput on a staged batch (decode excluded)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    staged, n = encoder.stage_images(u8)
    ms = _time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
    rate = {"features_wall_s": wall,
            "features_images": sum(sizes.values()),
            "encoder_img_per_s_bs64": batch / (ms / 1e3), **decode}
    print(f"[main] image encoder forward {ms:.3f} ms per batch of {batch} "
          f"= {rate['encoder_img_per_s_bs64']:.1f} img/s")
    _profile("image encoder", lambda: encoder.encode_staged(staged, n))
    # the text encoder at 64 prompts and at 1 (the features CLI's call:
    # one class's prompts)
    for n_txt in (batch, 1):
        prompts = [f"a photo of a class_{i}." for i in range(n_txt)]
        ms_txt = _time_ms(lambda: encoder.encode_texts(prompts), iters=10)
        rate[f"text_prompts_per_s_bs{n_txt}"] = n_txt / (ms_txt / 1e3)
        print(f"[main] encode_texts {ms_txt:.3f} ms per {n_txt} prompts (tokenize, "
              f"H2D, tower, D2H) = {rate[f'text_prompts_per_s_bs{n_txt}']:.1f} prompts/s")
        _profile(f"text encoder, {n_txt} prompts", lambda: encoder.encode_texts(prompts))
    return launches, rate, root, sizes, encoder


def phase_int8_path(root, sizes, bf16_encoder):
    """The features CLI with --quant int8 on the phase-3 fixture, then the
    whole-tower path -> ({port name: launches}, numbers)."""
    import numpy as np
    import torch

    from uml_tpu_torch.cli import features as feat

    batch, n_classes = 64, 8
    args = _features_args(root, batch, f"{root}/features_int8", quant="int8")
    t0 = time.perf_counter()
    encoder, launches = _counted(lambda: feat.main(args))
    wall = time.perf_counter() - t0
    print(f"[int8] features --quant int8 CLI {wall:.2f} s; launches {launches}")
    # per image batch 11 int8 halves of each kind and the bf16 CLS layer;
    # per class prompt batch 12 causal int8 layers, no text_tower
    n_batches = sum(-(-n // batch) for n in (sizes["train"], sizes["val"],
                                           sizes["test"]))
    want = dict.fromkeys(launches, 0)
    want.update({"attn_block_q8": 11 * n_batches + 12 * n_classes,
                 "mlp_block_q8": 11 * n_batches + 12 * n_classes,
                 "qkv_attention_q8": 11 * n_batches + 12 * n_classes,
                 "attn_block_cls": n_batches, "qkv_attention": n_batches,
                 "mlp_block": n_batches})
    _check(launches == want, (launches, want))
    _check(all(p.device.type == "cuda" for p in encoder.model.parameters()),
           "int8 encoder parameters on the card")
    _, test, _ = _check_caches(args.feature_dir, sizes, n_classes)
    cos_img, cos_txt = _card_vs_cpu_features(encoder, test["paths"], "int8")

    rng = np.random.default_rng(1)
    staged, n = encoder.stage_images(
        rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8))
    with torch.no_grad():
        per_layer = encoder.encode_staged(staged, n)[0].clone()
        bf16 = bf16_encoder.encode_staged(staged, n)[0]
    # the whole-tower path: one encode under UML_TOWER_Q8=1
    os.environ["UML_TOWER_Q8"] = "1"
    try:
        (towered, _), tower_launches = _counted(
            lambda: encoder.encode_staged(staged, n))
    finally:
        os.environ.pop("UML_TOWER_Q8")
    want_tower = dict.fromkeys(tower_launches, 0)
    want_tower.update({"tower_q8": 1, "qkv_attention_q8": 11, "attn_block_cls": 1,
                       "qkv_attention": 1, "mlp_block": 1})
    _check(tower_launches == want_tower, (tower_launches, want_tower))
    _check(torch.equal(towered, per_layer), "tower_q8 equals the per-layer path")
    launches["tower_q8"] = tower_launches["tower_q8"]
    cos_q8 = _cos_min(per_layer.float().cpu().numpy(), bf16.float().cpu().numpy())
    print(f"[int8] UML_TOWER_Q8=1: tower_q8 launched once, features equal "
          f"the per-layer int8 path's; int8 vs bf16 features of the same "
          f"model, min cosine {cos_q8:.6f} (recorded, not checked)")

    # steady state at bs 64: bf16, int8 per layer, int8 tower, in turns
    def rate(enc, tower):
        os.environ["UML_TOWER_Q8"] = "1" if tower else "0"
        try:
            ms = _time_ms(lambda: enc.encode_staged(staged, n), iters=10)
        finally:
            os.environ.pop("UML_TOWER_Q8")
        return ms, batch / (ms / 1e3)

    numbers = {"int8_features_wall_s": wall, "int8_card_vs_cpu_cos_image": cos_img,
               "int8_card_vs_cpu_cos_text": cos_txt,
               "int8_vs_bf16_cos_image": cos_q8}
    # the device memory of one int8 encode, per layer and as the tower:
    # held before the call, and the peak during it (the int8 MLP half
    # allocates no fp32 [rows, M] pre-activation)
    for key, tower in (("int8", False), ("int8_tower", True)):
        os.environ["UML_TOWER_Q8"] = "1" if tower else "0"
        try:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            encoder.encode_staged(staged, n)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            os.environ.pop("UML_TOWER_Q8")
        numbers[f"encoder_peak_mib_bs64_{key}"] = peak / 2 ** 20
        print(f"[int8] image encoder {key}: torch.cuda.max_memory_allocated "
              f"{peak / 2 ** 20:.1f} MiB during one encode of {batch}, "
              f"{held / 2 ** 20:.1f} MiB before it")
    for key, enc, tower in (("bf16", bf16_encoder, False),
                            ("int8", encoder, False),
                            ("int8_tower", encoder, True)):
        ms, r = rate(enc, tower)
        numbers[f"encoder_img_per_s_bs64_{key}"] = r
        print(f"[int8] image encoder {key}: {ms:.3f} ms per batch of {batch} "
              f"= {r:.1f} img/s")
    rows_p = _profile("int8 image encoder", lambda: encoder.encode_staged(staged, n))
    names = _kernel_names(rows_p)
    # the int8 products on the engine (wgmma s8), none on the old wmma kernel
    _check(not any("q8_gemm_kernel" in k for k in names)
           and any("wgmma_gemm_kernel" in k for k in names),
           ("int8 encoder kernels", names))
    # each of the 11 int8 MLP halves launches the LN quantize pass, c_fc's
    # two passes and c_proj (the attention halves the LN quantize pass and
    # the out-projection too), and nothing reads an fp32 pre-activation:
    # per layer and as the tower
    os.environ["UML_TOWER_Q8"] = "1"
    try:
        rows_t = _profile("int8 image encoder, UML_TOWER_Q8=1",
                          lambda: encoder.encode_staged(staged, n))
    finally:
        os.environ.pop("UML_TOWER_Q8")
    want_calls = dict(zip(Q8_MLP_KERNELS, (22, 11, 11, 22)))
    for what, prof in (("per layer", rows_p), ("UML_TOWER_Q8=1", rows_t)):
        calls = {part: sum(c for key, _, c in prof if part in key) // 3
                 for part in Q8_MLP_KERNELS}
        _check(calls == want_calls
               and not any("act_quantize_rows" in key for key, _, _ in prof),
               (f"int8 encoder {what}: the MLP halves' kernels", calls, want_calls))
        print(f"[int8] int8 image encoder {what}: per batch {calls}, no "
              f"act_quantize_rows pass")
    # no per-batch weight transpose: every int8 weight a layer hands the
    # ops is a view of its K-major cache, so the wrappers' w.t().contiguous()
    # is that cache itself, read in place
    from uml_tpu_torch.models.clip import _in_out

    model = encoder.model
    blocks = [*model.visual.transformer.resblocks[:-1], *model.transformer.resblocks]
    with torch.no_grad():
        views = [w for b in blocks for w in _in_out(b.quantized(model.dtype))
                 if w.dtype == torch.int8]
    _check(len(views) == 4 * len(blocks)
           and all(w.t().contiguous().data_ptr() == w.data_ptr() for w in views),
           "an int8 weight would be transposed per batch")
    print(f"[int8] {len(views)} int8 weights of {len(blocks)} layers read in place "
          f"(K-major caches, no per-batch transpose)")
    return launches, numbers


def _rows_cos_min(a, b):
    """Smallest per-row cosine of two feature tensors (any device)."""
    return _cos_min(a.float().cpu().numpy(), b.float().cpu().numpy())


def phase_unfused(fused_encoder):
    """The non-fused CLIP branch and the public ops on the card ->
    ({port name: launches}, numbers)."""
    import numpy as np
    import torch

    from uml_tpu_torch import ops
    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.models.tokenizer import tokenize
    from uml_tpu_torch.ops import ln_matmul as lm

    dev = torch.device("cuda")
    batch = 64
    state = fused_encoder.model.state_dict()
    models = {}
    for attn_impl in ("reference", "pallas"):
        models[attn_impl] = build_clip("ViT-B/16", torch.bfloat16,
                                       attn_impl=attn_impl)
        models[attn_impl].load_state_dict(state)
        models[attn_impl].to(dev).eval()
    rng = np.random.default_rng(2)
    u8 = torch.from_numpy(rng.integers(0, 256, (batch, 224 * 224 * 3),
                                       dtype=np.uint8)).to(dev)
    prompts = [f"a photo of a class_{i}." for i in range(batch)]
    tokens = torch.from_numpy(tokenize(prompts).astype(np.int64)).to(dev)
    cpu_model = copy.deepcopy(models["reference"]).to("cpu")
    numbers, launches = {}, {}
    with torch.no_grad():
        fused_img = fused_encoder.model.encode_image_u8(u8)
        fused_txt = fused_encoder.model.encode_text(tokens)
        cpu_img = cpu_model.encode_image_u8(u8[:4].cpu())
        cpu_txt = cpu_model.encode_text(tokens[:2].cpu())
        # per image batch 12 ln_matmul and 12 add_ln_matmul (and, with
        # attn_impl="pallas", 12 flash_attention), no fused port
        for attn_impl, model in models.items():
            feats, counts = _counted(lambda: model.encode_image_u8(u8))
            want = dict.fromkeys(counts, 0)
            want.update({"ln_matmul": 12, "add_ln_matmul": 12})
            if attn_impl == "pallas":
                want["flash_attention"] = 12
            _check(counts == want, (attn_impl, counts, want))
            _check(feats.shape == (batch, 512)
                   and bool(torch.isfinite(feats).all()), (attn_impl, feats.shape))
            cos_f, cos_c = _rows_cos_min(feats, fused_img), _rows_cos_min(feats[:4], cpu_img)
            print(f"[unfused] encode_image_u8 attn_impl={attn_impl}: launches "
                  f"{ {k: v for k, v in counts.items() if v} }; min cosine vs "
                  f"the fused path {cos_f:.6f}, vs the CPU {cos_c:.6f} (bound "
                  f"{MIN_COSINE})")
            _check(cos_f >= MIN_COSINE and cos_c >= MIN_COSINE,
                   (attn_impl, cos_f, cos_c))
            numbers[f"unfused_{attn_impl}_cos_vs_fused"] = cos_f
            numbers[f"unfused_{attn_impl}_cos_vs_cpu"] = cos_c
            launches[attn_impl] = counts
        # per prompt batch 12 and 12, no text_tower
        feats, counts = _counted(lambda: models["reference"].encode_text(tokens))
        want = dict.fromkeys(counts, 0)
        want.update({"ln_matmul": 12, "add_ln_matmul": 12})
        _check(counts == want, ("text", counts, want))
        cos_f, cos_c = _rows_cos_min(feats, fused_txt), _rows_cos_min(feats[:2], cpu_txt)
        print(f"[unfused] encode_text attn_impl=reference: launches "
              f"{ {k: v for k, v in counts.items() if v} }; min cosine vs the "
              f"fused path {cos_f:.6f}, vs the CPU {cos_c:.6f}")
        _check(cos_f >= MIN_COSINE and cos_c >= MIN_COSINE, ("text", cos_f, cos_c))
        numbers["unfused_text_cos_vs_fused"] = cos_f
        numbers["unfused_text_cos_vs_cpu"] = cos_c

        # steady state at bs 64 in turns: fused, reference, pallas
        for key, model in (("fused", fused_encoder.model), *models.items()):
            ms = _time_ms(lambda: model.encode_image_u8(u8), iters=10)
            numbers[f"unfused_phase_img_per_s_bs64_{key}"] = batch / (ms / 1e3)
            print(f"[unfused] image encoder {key}: {ms:.3f} ms per batch of "
                  f"{batch} = {batch / (ms / 1e3):.1f} img/s")
        # each batch: 12 affine and 12 add LN pre-passes, each before its
        # engine product; no wmma ln_gemm_kernel
        for attn_impl, model in models.items():
            rows = _profile(f"non-fused image encoder ({attn_impl})",
                            lambda: model.encode_image_u8(u8), reps=3)
            prepasses = [sum(c for key, _, c in rows if f"ln_rows_kernel<{pro}>" in key) // 3
                         for pro in (2, 3)]
            _check(prepasses == [12, 12]
                   and not any("ln_gemm_kernel" in key for key, _, _ in rows),
                   (attn_impl, "the LN pre-passes on the engine's route", prepasses))

        # the public exports on the card
        gen = torch.Generator(device=dev).manual_seed(3)

        def rnd(*shape, std=1.0, dtype=torch.bfloat16):
            return (torch.randn(*shape, generator=gen, device=dev) * std).to(dtype)

        x = rnd(batch, 197, 768)
        scale, bias = 1 + rnd(768, std=0.1, dtype=torch.float32), rnd(
            768, std=0.1, dtype=torch.float32)
        w, wb = rnd(768, 2304, std=768 ** -0.5), rnd(2304, std=0.02,
                                                     dtype=torch.float32)
        q, k, v = (rnd(2, 4, 2048, 64) for _ in range(3))

        def public_ops():
            return (ops.layer_norm(x, scale, bias),
                    ops.ln_qkv_attention(x, scale, bias, w, wb, heads=12),
                    ops.multi_head_attention(q, k, v, causal=True),
                    lm.ln_matmul(x.reshape(-1, 768), scale, bias, w, wb))

        outs, counts = _counted(public_ops)
        want = dict.fromkeys(counts, 0)
        want.update({"layer_norm": 1, "ln_qkv_attention": 1,
                     "flash_attention": 1, "ln_matmul": 1})
        _check(counts == want, ("public ops", counts, want))
        _check(all(bool(torch.isfinite(o.float()).all()) for o in outs),
               "public ops: non-finite")
        _check([tuple(o.shape) for o in outs] == [
            (batch, 197, 768), (batch, 197, 768), (2, 4, 2048, 64),
            (batch * 197, 2304)], [o.shape for o in outs])
        print(f"[unfused] public ops on the card (layer_norm, ln_qkv_attention, "
              f"multi_head_attention auto S=2048, 2-d ln_matmul): launches "
              f"{ {k: v for k, v in counts.items() if v} }")

        # on the card the default impl="auto" launches or raises: what the
        # kernels do not take (fp32, fp16, a width that is not a multiple
        # of 64) never runs the plain version unasked, neither in an op nor
        # in the fp32 non-fused model; any S is taken
        def refused(fn):
            try:
                fn()
            except (TypeError, ValueError):
                return True
            return False

        fp32_model = build_clip("ViT-B/16", attn_impl="reference").to(dev).eval()
        long_x = rnd(2, 401, 768)
        long_out, long_counts = _counted(
            lambda: ops.ln_qkv_attention(long_x, scale, bias, w, wb, heads=12))
        _check(tuple(long_out.shape) == (2, 401, 768)
               and bool(torch.isfinite(long_out.float()).all())
               and long_counts["ln_qkv_attention"] == 1, ("S=401", long_counts))
        narrow = rnd(2, 401, 96)
        refusals, stray = _counted(lambda: [refused(fn) for fn in (
            lambda: lm.ln_matmul(x.float(), scale, bias, w.float(), wb),
            lambda: lm.add_ln_matmul(x.float(), x.float(), scale, bias,
                                     w.float(), wb),
            lambda: ops.ln_qkv_attention(x.float(), scale, bias, w.float(), wb,
                                         heads=12),
            lambda: ops.ln_qkv_attention(narrow, scale[:96], bias[:96],
                                         w[:96, :384].contiguous(), wb[:384],
                                         heads=2),
            lambda: ops.layer_norm(x.half(), scale, bias),
            lambda: ops.multi_head_attention(q.float(), k.float(), v.float()),
            lambda: fp32_model.encode_image_u8(u8[:2]))])
        _check(all(refusals) and not any(stray.values()),
               ("auto on the card must raise where the kernel does not take "
                "the input", refusals, stray))
        del fp32_model
        print(f"[unfused] impl=auto on the card: {len(refusals)} inputs the "
              f"kernels do not take all raised, no launch, no plain version")
    path = {**{k: launches["pallas"][k] for k in UNFUSED_PORTS},
            "ln_matmul_2d": counts["ln_matmul"],
            "ln_qkv_attention": counts["ln_qkv_attention"],
            "layer_norm": counts["layer_norm"]}
    return path, numbers


def _text_grad_card_vs_cpu():
    """One gradient of encode_text through TextTowerFn on the card (the
    kernel forward, the backward through text_tower_plain) against the same
    model on the CPU: 4 prompts, per-tensor gradient cosines."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.models.tokenizer import tokenize
    from uml_tpu_torch.ops.text_tower import text_tower

    cpu_model = build_clip("ViT-B/16", torch.bfloat16).init_random(
        torch.Generator().manual_seed(0))
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    tokens = torch.from_numpy(tokenize(
        [f"a photo of a class_{i}." for i in range(4)]).astype(np.int64))
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 512)).astype(np.float32))
    grads = []
    text_tower.launches = 0
    for model, dev in ((gpu_model, "cuda"), (cpu_model, "cpu")):
        (model.encode_text(tokens.to(dev)) * cot.to(dev)).sum().backward()
        grads.append({k: p.grad.float().cpu() for k, p in model.named_parameters()
                      if p.grad is not None})
    torch.cuda.synchronize()
    _check(text_tower.launches == 1, ("text_tower under autograd",
                                      text_tower.launches))
    _check(grads[0].keys() == grads[1].keys() and len(grads[0]) > 12 * 12,
           "text gradients reach the same parameters")
    cosines = {}
    for key, b in grads[1].items():
        a = grads[0][key]
        if key.endswith("attn.in_proj_bias"):
            a, b = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (a, b))
        cosines[key] = float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
    worst = min(cosines, key=cosines.get)
    print(f"[train] encode_text gradient through TextTowerFn, card vs CPU: "
          f"{len(cosines)} tensors, min cosine {cosines[worst]:.6f} ({worst}), "
          f"bound {STEP_MIN_GRAD_COSINE}")
    _check(cosines[worst] >= STEP_MIN_GRAD_COSINE, ("text gradient", worst,
                                                     cosines[worst]))
    return {"text_tower_min_grad_cosine": cosines[worst]}


def _finetune(root, grid, wrappers, result_dir="experiments"):
    """One finetune CLI run into ``root/result_dir`` -> (launch counts,
    wall seconds, the combo's test_result)."""
    import torch

    from uml_tpu_torch.cli import finetune as ft
    from uml_tpu_torch.data.feature_cache import load_cache

    args = ft.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", f"{root}/features", "--result_dir",
        f"{root}/{result_dir}", "--dataset", "caltech101",
        "--clip-encoder", "ViT-B/16", "--allow-random-init",
        "--train-shot", "16", "--seed", "1", "--text_type", "hand_crafted",
        "--modality", "crossmodal", "--alpha", "1", "--hyperparams", grid])
    args.overwrite = False
    args.force_rerun = False
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    ft.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    h = ft.HYPER_DICT[grid]
    sub = ft.hparam_str(h["optim"], h["lr"][0], h["weight_decay"][0],
                        h["batch_size"][0], h["max_iter"][0], h["dropout"][0],
                        h["learnable_temp"][0])
    result = load_cache(os.path.join(args.savepath, sub, "test_result.pth"))
    results = load_cache(os.path.join(args.savepath, "results.pth"))
    for r in (result, results):
        _check(all(math.isfinite(float(v)) for v in
                   np_flat(r["test_acc"]) + np_flat(r["val_acc"])),
               (grid, r["test_acc"], r["val_acc"]))
    print(f"[train] finetune --hyperparams {grid}: {wall:.2f} s, test acc "
          f"{float(result['test_acc']):.4f}, val acc "
          f"{float(result['val_acc']):.4f} at iter {result['iter']}; "
          f"launches {launches}")
    return launches, wall, result


def np_flat(v):
    import numpy as np

    return [float(x) for x in np.asarray(v, np.float64).reshape(-1)]


def _check_tower_moved(result, what):
    """The saved best model is the iter-0 snapshot: one adamw step from the
    encoder's random init (generator seed 0); every image-tower tensor
    must differ from the init."""
    import torch

    from uml_tpu_torch.models.clip import build_clip

    init = build_clip("ViT-B/16").init_random(
        torch.Generator().manual_seed(0)).state_dict()
    trained = result["model"]["backbone"]
    visual = [k for k in init if k.startswith("visual.")]
    moved = [k for k in visual
             if (torch.as_tensor(trained[k]) - init[k]).abs().max().item() > 0]
    _check(len(moved) == len(visual), (what, "tower tensors moved", len(moved),
                                       len(visual)))
    print(f"[train] {what}: every one of the {len(visual)} image-tower "
          f"tensors moved")


def phase_train(root, sizes):
    """-> ({port name: launches} of the stash full-model run, {port name:
    launches} of the recompute runs, numbers)."""
    from uml_tpu_torch.cli import collect_results as cr
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm

    wrappers = {"attn_block": fa.attn_block, "attn_block_cls": fa.attn_block_cls,
                "mlp_block": lm.mlp_block,
                "attn_block_stash": fa.attn_block_stash,
                "attn_block_bwd": fa.attn_block_bwd,
                "attn_block_cls_bwd": fa.attn_block_cls_bwd,
                "mlp_block_stash": lm.mlp_block_stash,
                "attn_block_bwd_recompute": fa.attn_block_bwd_recompute,
                "mlp_bwd": lm.mlp_bwd, "mlp_bwd_dw": lm.mlp_bwd_dw,
                "qkv_attention": fa.qkv_attention}
    none = dict.fromkeys(wrappers, 0)
    # frozen path: the three splits encoded once in batches of 128, then
    # head-only steps on the features
    frozen, frozen_wall, _ = _finetune(root, "smoke", wrappers)
    n_enc = sum(-(-sizes[p] // 128) for p in ("train", "val", "test"))
    _check(frozen == _with_fused({**none, "attn_block": 11 * n_enc,
                                  "attn_block_cls": n_enc, "mlp_block": 12 * n_enc}),
           ("smoke launches", frozen))

    # full path: 30 steps at bs 8 through the training kernels; the forward
    # kernels validate (val at iter 0 and for the best model, test at the
    # end) in batches of 8
    full, full_wall, result = _finetune(root, "smoke_full", wrappers)
    steps = 30
    n_eval = 2 * -(-sizes["val"] // 8) + -(-sizes["test"] // 8)
    evals = {"attn_block": 11 * n_eval, "attn_block_cls": steps + n_eval,
             "mlp_block": 12 * n_eval, "attn_block_cls_bwd": steps}
    want = _with_fused({**none, **evals, "attn_block_stash": 11 * steps,
                        "attn_block_bwd": 11 * steps, "mlp_block_stash": 12 * steps})
    _check(full == want, ("smoke_full launches", full, want))
    _check_tower_moved(result, "smoke_full")

    # the same run with both stashes off: the forward kernels train, the
    # recompute backwards run, and no stash kernel launches
    numbers = {"finetune_smoke_wall_s": frozen_wall,
               "finetune_smoke_full_wall_s": full_wall}
    recompute = {}
    for mode in ("kernel", "dw"):
        with _env(RECOMPUTE_MODES[mode]):
            launches, wall, result = _finetune(root, "smoke_full", wrappers,
                                               f"experiments_recompute_{mode}")
        mlp_port = "mlp_bwd" if mode == "kernel" else "mlp_bwd_dw"
        want = _with_fused({**none, **evals, "attn_block": 11 * (n_eval + steps),
                            "mlp_block": 12 * (n_eval + steps),
                            "attn_block_bwd_recompute": 11 * steps, mlp_port: 12 * steps})
        _check(launches == want, (f"smoke_full {mode} launches", launches, want))
        _check_tower_moved(result, f"smoke_full UML_MLP_BWD={mode}")
        recompute[mlp_port] = launches[mlp_port]
        recompute["attn_block_bwd_recompute"] = launches["attn_block_bwd_recompute"]
        numbers[f"finetune_smoke_full_{mode}_wall_s"] = wall

    summary = cr.collect_results(
        datasets="caltech101", seeds=1, encoders="ViT-B-16", train_shots=16,
        init_types="zeroshot",
        modality_types="finetune-text_hand_crafted-image_crop_-alpha_1.0",
        experiments_dir=f"{root}/experiments")
    _check(len(summary) == 1, ("collect_results rows", list(summary)))
    row = next(iter(summary.values()))
    _check(os.path.isfile(row["best_path"]) and math.isfinite(row["mean_test_acc"]),
           ("collect_results best row", row))
    print(f"[train] collect_results: best {row['best_hparams']['optim']} "
          f"lr {row['best_hparams']['lr']} iters "
          f"{row['best_hparams']['max_iter']}: test "
          f"{row['mean_test_acc']:.4f} val {row['mean_val_acc']:.4f}")

    numbers.update(_card_vs_cpu_step("default"))
    # with the stashes off: UML_MLP_BWD unset (row 19 on the card, the
    # plain VJP on the CPU), then each value
    with _env({**RECOMPUTE, "UML_MLP_BWD": "unset"}):
        numbers.update(_card_vs_cpu_step("recompute_unset"))
    for mode, env in RECOMPUTE_MODES.items():
        with _env(env):
            numbers.update(_card_vs_cpu_step(f"recompute_{mode}"))
    # (tag, environment, microbatch) at bs 64, then at bs 256; "unset"
    # drops UML_MLP_BWD from the environment
    numbers.update(_train_step_rates(64, [
        ("stash", {}, None),
        ("recompute_plain", RECOMPUTE_MODES["plain"], None),
        ("recompute_kernel", RECOMPUTE_MODES["kernel"], None),
        ("recompute_dw", RECOMPUTE_MODES["dw"], None)]))
    numbers.update(_train_step_rates(256, [
        ("gate_default", {"UML_MLP_BWD": "unset"}, None),
        ("gate_plain", {"UML_MLP_BWD": "plain"}, None),
        ("gate_dw", {"UML_MLP_BWD": "dw"}, None),
        ("accum_2x128", {}, 128)]))
    # the non-fused branch trains too (its ops' backwards differentiate
    # their plain versions): the configuration of uml_tpu's dry run
    unfused = {"attn_impl": "reference"}
    numbers.update(_card_vs_cpu_step("unfused_reference", unfused))
    numbers.update(_train_step_rates(64, [("unfused_reference", {}, None)],
                                     clip_kw=unfused))
    numbers.update(_text_grad_card_vs_cpu())
    # F2: ViT-L/14 at full width (S = 257) trains on the card, cut to 4
    # image layers (3 full, the CLS layer) and 1 text layer (unused)
    vit_l = {"config": _vit_l14_cut()}
    numbers.update(_card_vs_cpu_step("vit_l14", **vit_l))
    with _env(RECOMPUTE_MODES["dw"]):
        numbers.update(_card_vs_cpu_step("vit_l14_recompute_dw", **vit_l))
    return full, recompute, numbers


def _head_and_batch(bsz, gen_seed=0, clip_kw=None, config=None):
    """A random-init ViT-B/16 UML head (bf16 compute, every CLIP leaf
    trainable; ``clip_kw``: build_clip's attn_impl / ln_matmul_impl;
    ``config``: a ClipConfig in place of ViT-B/16's) and one crossmodal
    batch of ``bsz`` on the CPU."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.clip import CLIP, build_clip
    from uml_tpu_torch.models.uml_head import make_uml_clip_head

    clip = (build_clip("ViT-B/16", dtype=torch.bfloat16, **(clip_kw or {}))
            if config is None else
            CLIP(config, dtype=torch.bfloat16, **(clip_kw or {}))).init_random(
        torch.Generator().manual_seed(gen_seed))
    res, width = clip.config.image_resolution, clip.config.embed_dim
    model = make_uml_clip_head(clip, 8, freeze_backbone=False,
                               generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(gen_seed)
    batch = (torch.from_numpy(rng.integers(0, 256, (bsz, res * res * 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 8, bsz)),
             torch.ones(bsz),
             torch.from_numpy(rng.standard_normal((bsz, width)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 8, bsz)),
             torch.ones(bsz))
    return model, batch


def _loss(model, batch):
    """The crossmodal UML loss of train/supervised.py (alpha 1)."""
    from uml_tpu_torch.train.supervised import weighted_ce

    img, lab, w, txt, tlab, tw = batch
    s_img, s_txt = model.scales()
    return (weighted_ce(model.image_features(img) @ model.head_w * s_img, lab, w)
            + weighted_ce(txt @ model.head_w * s_txt, tlab, tw))


def _card_vs_cpu_step(mode, clip_kw=None, config=None):
    """One bs-4 forward + backward on the card and on the CPU plain path,
    same weights and batch, in the backward mode the environment sets."""
    import torch

    cpu_model, cpu_batch = _head_and_batch(4, clip_kw=clip_kw, config=config)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gpu_batch = tuple(t.to("cuda") for t in cpu_batch)
    losses, grads = [], []
    for model, batch in ((gpu_model, gpu_batch), (cpu_model, cpu_batch)):
        loss = _loss(model, batch)
        loss.backward()
        losses.append(loss.item())
        grads.append({k: p.grad.detach().float().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
    _check(grads[0].keys() == grads[1].keys(), "same parameters reached")
    cosines = {}
    for key, g in grads[1].items():
        a, b = grads[0][key], g
        if key.endswith("attn.in_proj_bias"):
            a, b = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (a, b))
        cosines[key] = float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
    worst = min(cosines, key=cosines.get)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    print(f"[train] bs-4 step card vs CPU ({mode}): loss {losses[0]:.6f} vs "
          f"{losses[1]:.6f} (rel {rel:.2e}, bound {STEP_LOSS_RTOL}); "
          f"{len(cosines)} gradient tensors, min cosine "
          f"{cosines[worst]:.6f} ({worst}), bound {STEP_MIN_GRAD_COSINE}")
    _check(rel <= STEP_LOSS_RTOL, (mode, "bs-4 loss", losses))
    _check(cosines[worst] >= STEP_MIN_GRAD_COSINE, (mode, "gradient cosine",
                                                     worst, cosines[worst]))
    suffix = "" if mode == "default" else f"_{mode}"
    return {f"step_loss_rel_err{suffix}": rel,
            f"step_min_grad_cosine{suffix}": cosines[worst]}


def _train_step_rates(bsz, modes, iters=10, clip_kw=None):
    """Steady-state full-model train step (forward, backward, adamw) at
    ``bsz`` on a staged batch, in each mode of ``modes`` ((tag, environment,
    microbatch or None), run in turn on one model), with its peak memory,
    its phases and a profile."""
    import torch

    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.train.accum import microbatched_step
    from uml_tpu_torch.train.optim import build_optimizer, build_schedule

    model, batch = _head_and_batch(bsz, clip_kw=clip_kw)
    model.to("cuda")
    batch = tuple(t.to("cuda") for t in batch)
    opt = build_optimizer("adamw", build_schedule(5e-5, "cosine", 50, 12800),
                          0.01)
    params = [p for p in model.parameters() if p.requires_grad]
    opt.init(params)
    it = iter(range(10 ** 6))
    numbers = {}
    for tag, env, micro in modes:
        def step(marks=None):
            """One step; ``marks``: four CUDA events recorded before the
            forward, the backward and adamw, and after adamw (the
            backward's kernels run on the forward's stream, from
            autograd's thread).  With a microbatch the forward and the
            backward of each slice alternate: their sum is the second
            phase."""
            def mark(i):
                if marks is not None:
                    marks[i].record()

            mark(0)
            opt.zero_grad()
            if micro is None:
                loss = _loss(model, batch)
                mark(1)
                loss.backward()
            else:
                mark(1)
                _, grads = microbatched_step(lambda *b: _loss(model, b), params,
                                             *batch, microbatch=micro)
                for p, g in zip(params, grads):
                    p.grad.copy_(g)
            mark(2)
            opt.step(next(it))
            mark(3)

        with _env(env):
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
                     for _ in range(iters)]
            lm.mlp_bwd.launches = lm.mlp_bwd_dw.launches = 0
            t0 = time.perf_counter()
            for m in marks:
                step(m)
            torch.cuda.synchronize()
            mlp_launches = (lm.mlp_bwd.launches, lm.mlp_bwd_dw.launches)
            ms = (time.perf_counter() - t0) / iters * 1e3
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rate = bsz / (ms / 1e3)
            phases = [sum(m[i].elapsed_time(m[i + 1]) for m in marks) / iters
                      for i in range(3)]
            env_s = " ".join(f"{k}={v}" for k, v in env.items()) or "default env"
            how = f", {bsz // micro} x {micro} through train/accum.py" if micro else ""
            print(f"[train] full-model train step bs {bsz} {tag} ({env_s}"
                  f"{how}): {ms:.3f} ms = {rate:.1f} img/s (forward, backward, "
                  f"adamw; peak memory {peak:.2f} GiB)")
            print(f"[train] phases on the card's stream (CUDA events): forward "
                  f"{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, adamw "
                  f"{phases[2]:.3f} ms; launches over the {iters} steps: mlp_bwd "
                  f"{mlp_launches[0]}, mlp_bwd_dw {mlp_launches[1]}")
            if tag == "gate_default":
                # F1: above the gate the default MLP backward is row 19
                _check(mlp_launches[0] > 0 and mlp_launches[1] == 0,
                       ("bs-256 default gate: mlp_bwd", mlp_launches))
            first = tag == "stash"
            _gemm_classes(f"train step bs {bsz} {tag}",
                          _profile(f"train step bs {bsz} {tag}", step,
                                   top=16 if first else 10, by_op=first))
        # the bs-64 stash step keeps the keys of the earlier runs
        key = f"bs{bsz}" if first else f"bs{bsz}_{tag}"
        numbers.update({f"train_step_ms_{key}": ms, f"train_img_per_s_{key}": rate,
                        f"train_peak_gib_{key}": peak,
                        f"train_forward_ms_{key}": phases[0],
                        f"train_backward_ms_{key}": phases[1],
                        f"train_adamw_ms_{key}": phases[2]})
    return numbers


def _device_rows(events):
    """(name, self device time in us, count) of every event of a profile's
    ``key_averages()`` that ran on the card: kernels (PyTorch's elementwise
    lambdas, ``...{lambda(float)#1}``, among them), memcpys and memsets.
    Chosen by kind, never by name: only device-side rows count (an aten
    op's own row would count its kernels a second time), and a
    ``record_function`` range (``Optimizer.step#AdamW.step``), whose
    device-side row spans kernels counted in their own rows, is dropped:
    by ``is_user_annotation`` where the torch build sets it, else by the
    name its CPU-side event in the same profile carries."""
    from torch.autograd import DeviceType

    cpu_names = {e.key for e in events if e.device_type != DeviceType.CUDA}

    def annotation(e):
        flag = getattr(e, "is_user_annotation", None)
        return e.key in cpu_names if flag is None else flag

    return [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not annotation(e)]


def _profile(what, fn, reps=3, top=10, by_op=False):
    """Device time by kernel over ``reps`` calls (torch.profiler, CUPTI)
    and the device's busy share of the wall time of those calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _device_rows(prof.key_averages())
    busy = sum(t for _, t, _ in rows)
    print(f"[profile] {what}: device busy {busy / reps / 1e3:.3f} ms per call, "
          f"{100 * busy / wall_us:.1f}% of {wall_us / reps / 1e3:.3f} ms wall")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"[profile]   {100 * t / busy:5.1f}%  {t / reps / 1e3:8.3f} ms  "
              f"x{count // reps:<4d} {key[:120]}")
    if by_op:
        # the same device time by the aten op that launched it (the plain
        # PyTorch parts: products, elementwise passes, casts)
        ops = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
               and e.self_device_time_total > 0]
        for key, t, count in sorted(ops, key=lambda r: -r[1])[:top]:
            print(f"[profile]   op {100 * t / busy:5.1f}%  {t / reps / 1e3:8.3f} ms"
                  f"  x{count // reps:<4d} {key}")
    return rows


def _gemm_classes(what, rows):
    """The device time of a profile's library GEMM kernels (cuBLAS, CUTLASS;
    not the port's ln_gemm / gemm_at) by the number format of their
    products: TF32 and bf16 run on the tensor cores, fp32 as SIMT FMAs."""
    busy = sum(t for _, t, _ in rows) or 1.0
    shares = dict.fromkeys(("tf32", "bf16", "fp32 SIMT", "other"), 0.0)
    for key, t, _ in rows:
        name = key.lower()
        if "gemm" not in name or "ln_gemm" in name or "gemm_at" in name:
            continue
        if "tf32" in name:
            shares["tf32"] += t
        elif "bf16" in name or "s16816" in name:
            shares["bf16"] += t
        elif "sgemm" in name or "f32f32_f32f32" in name or "simt" in name:
            shares["fp32 SIMT"] += t
        else:
            shares["other"] += t
    print(f"[profile] {what}: library GEMMs by product format, share of device "
          f"time: " + ", ".join(f"{k} {100 * v / busy:.1f}%"
                                for k, v in shares.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import uml_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from a checkout of the repository "
              "(uml_tpu_torch not found)", file=sys.stderr)
        return 2
    phase_setup()
    kernels = phase_kernels()
    launches, rate, root, sizes, encoder = phase_main_path()
    int8_launches, int8_numbers = phase_int8_path(root, sizes, encoder)
    rate.update(int8_numbers)
    unfused_launches, unfused_numbers = phase_unfused(encoder)
    rate.update(unfused_numbers)
    del encoder
    train_launches, recompute_launches, train_numbers = phase_train(root, sizes)
    rate.update(train_numbers)
    # each port's launches come from the path it belongs to: the bf16
    # serving kernels from the features run, the int8 ones from the
    # features --quant int8 run and its tower encode, the training kernels
    # from the full-model finetune run, the recompute backwards from the
    # finetune runs with both stashes off, the stand-alone ops from the
    # non-fused image encode (attn_impl="pallas") and the public ops' calls
    launches = {**launches, **unfused_launches,
                **{k: int8_launches[k] for k in Q8_PORTS},
                **{k: train_launches[k] for k in TRAIN_PORTS},
                **{k: recompute_launches[k] for k in RECOMPUTE_PORTS}}
    _check(all(launches[name] > 0 for name, _, _ in PORTS), launches)
    table = []
    for name, source, replaces in PORTS:
        row = kernels[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": row["max_abs_err"],
                      "max_rel_err": row["max_rel_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                      "bound_by": row["bound_by"],
                      # F.layer_norm and scaled_dot_product_attention for
                      # layer_norm and flash_attention; no one PyTorch call
                      # computes a half-block, a tower, a backward or an
                      # LN -> matmul
                      "library_ms": row["library_ms"],
                      "gemm_yardstick": row["yardstick"],
                      "gemm_yardstick_ms": row["yardstick_ms"],
                      # rows 14-17: the kernels a profile of one call showed
                      **({"engine_kernels": row["engine_kernels"]}
                         if "engine_kernels" in row else {}),
                      # rows 4 and 8: the device kernels of one call
                      **({"profile_kernels": row["profile_kernels"]}
                         if "profile_kernels" in row else {})})
    products = [{"name": name, "max_abs_err": kernels[name]["max_abs_err"],
                 "max_rel_err": kernels[name]["max_rel_err"], "ms": kernels[name]["ms"],
                 "plain_ms": kernels[name]["plain_ms"],
                 "bound_ms": kernels[name]["bound_ms"],
                 "bound_by": kernels[name]["bound_by"],
                 "cublas": kernels[name]["yardstick"],
                 "cublas_ms": kernels[name]["yardstick_ms"]} for name in PRODUCTS]
    print(json.dumps({"throughput": rate}))
    print(json.dumps({"products": products}))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
