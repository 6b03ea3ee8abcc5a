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
   their own through ops/fused_attention.py::attn_bwd; the grouped expert
   kernel moe_gemm, both launches of one DeepSeek-V2-Lite MoE layer at
   the benchmark cell's 6,840 routed rows over 64 experts, uneven, four
   empty, in float32 against one cuBLAS product a projection an expert
   within 1e-5, its bound at float32's FMA rate, 67 TFLOP/s) against its plain PyTorch
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
3. main path: the host decoders of data/loader.py on two fixtures of
   JPEGs (the phase's 240 x 320 noise images and 128 500 x 375 photos,
   where libjpeg's IDCT scaling applies): the native decoder is built
   from uml_tpu_torch/native (a failed build where jpeglib.h exists ends
   the run; without the headers every native rate is "not measured"), its
   output must equal the reference source's built apart byte for byte on
   every fixture image, and PIL and native, each in threads and in the
   spawn pool, decode at one worker and at one per core
   (``pipeline_host_decode_img_per_s_*``).  Then generate_fewshot and
   features on a synthetic caltech-layout
   fixture with a random-init ViT-B/16; the .pth caches must hold finite
   width-512 features, the encoder must live on the card, every port's
   launch counter must have moved by the expected count, and the card's
   features must agree with the same model run on the CPU (plain path).
   JPEG to features over 2,048 images at batch 64 in bf16: the parent's
   per-batch synchronous loop (PIL threads) and the pipelined loop of
   cli/features.py in threads and in the spawn pool, the pool also with
   its outputs read at once and only at the end
   (``pipeline_img_per_s_*``, each with the device's busy share); the
   features CLI's pipelined caches must equal a batch-by-batch
   synchronous encode bit for bit, and a pool worker killed halfway
   through sending a batch must make that iterator raise
   BrokenProcessPool, and the next extraction rebuild the pool and
   finish.
   The image encoder's img/s, and the text encoder's prompts/s at 64
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
   step 11 attn_block_stash, 11 attn_block_bwd, 1 attn_block_cls_bwd, 12
   mlp_block_stash and 12 mlp_bwd_via_stash), and the tower must have
   moved.  Then smoke_full
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
5. DINO (``[dino]``): features --vision_model vit_base_patch14_dinov2.lvd142m
   (DINOv2-B/14: K 768, 12 heads, S 257, exact GELU, LN eps 1e-6) with a
   --language_model name (its files absent: hash-random text features)
   on the phase-3 fixture at batch 64, in bf16 and with --quant int8: the
   caches must hold finite width-768 features, the launch counters the
   layer plan (per image batch 11 attention halves on the chain and 1 CLS
   half, 12 exact-GELU MLP halves, 12 flash_attention launches inside
   them; in int8 11 int8 halves of each kind and the bf16 CLS layer), and
   the card's features must agree with the same model on the CPU (min
   cosine 0.999); the encoder's img/s and a profile in both modes; then a
   batch of 4 through DINOv2-L/14 (24 layers, K 1024) and DINO ViT-B/8
   (S 785), card against CPU.  Phase 2 holds the DINO path's kernels at
   DINOv2-B/14 B = 64 (rows 1, 2 and 10 on the chain, row 3 and row 11
   with exact GELU, row 13 at [64, 12, 257, 64] beside SDPA); the int8
   hidden of row 11 with exact GELU within one step of the plain
   version's on at most 0.1% of its integers, its scales within rtol
   1e-6; a profile of one such call shows the LN quantize pass, ROWMAX,
   the exact-GELU quantizing pass and c_proj.
5b. DINO training (``[dino-train]``): finetune --vision_model
   vit_base_patch14_dinov2.lvd142m --hyperparams smoke_full (the
   DINOv2-B/14 tower at full width, bs 8, 30 steps) on the phase-3
   fixture and the [dino] phase's text cache, with the stashes and then
   with both off under UML_MLP_BWD=kernel and =dw: per step 11
   attention halves (stash or recompute) and the CLS half with its
   backward, 12 exact-GELU MLP halves (rows 9, or 19 / 20), 12 (or 23)
   flash_attention launches on the chain; the saved model holds head_w,
   img_proj_w and the DINO backbone, every tensor of which moved.  A
   profile of one bs-4 step per mode shows the engine's exact-GELU
   instances (OUT_GELU_EXACT with its stash, OUT_DACT_BF16_EXACT,
   OUT_DACT_EXACT) and none of the quick_gelu ones.  A bs-4 step card vs
   CPU in every backward mode (loss within 1%, gradient cosines >= 0.99);
   the step at bs 64 (stashes on, and both off under UML_MLP_BWD=kernel)
   and bs 256 (the default gate: no MLP stash, row 19) with its phases,
   device-busy share and peak memory.
   Phase 2 holds rows 5-8 at S = 257 and rows 9, 19 and 20 with exact
   GELU at DINOv2-B/14 B = 64 (the ``*_dino`` entries of DINO_TRAIN_PORTS
   on the kernel line, their launches from these runs).
5c. CLIP RN (``[rn]``): features with no --clip-encoder (RN50, the CLI
   default), random init, on the phase-3 fixture: the caches hold finite
   width-1024 features and name the decoder that ran, the text tower
   launched once per class and no other port, and the card's image and
   text features agree with the same model on the CPU (min cosine
   0.999, a batch of 4); the same with --quant int8, which the RN models
   ignore (min cosine to the bf16 caches 0.99999: room for cuDNN to pick
   another algorithm, not for an int8 path); the frozen finetune
   (``smoke``) on those caches; RN101 card against CPU on a batch of 4;
   the RN50 and RN101 image encoders' img/s at batch 64 on a staged
   batch, with the device's busy share and the peak memory rise.
5d. RN training (``[rn-train]``): finetune --clip-encoder RN50
   --hyperparams smoke_full (the RN50 tower at full width, random init,
   BatchNorm in train form, bs 8, 30 steps) on the phase-3 fixture and the
   [rn] phase's text cache: no port launches (cuDNN convolutions, plain
   BatchNorm), the saved model holds the head and the tower, every tower
   tensor moved, every BatchNorm layer's running statistics moved, are
   finite and have variances > 0; one fp32 bs-4 step of RN50 card against
   CPU (loss within 1%, gradient cosines >= 0.99, the running statistics
   after the merge within 1e-4 relative); the staged bs-64 train step of
   RN50 and RN101 (bf16) with its phases, device-busy share and peak
   memory.
5e. LLaMA (``[llama]``): the native LlamaEncoder at OpenLLaMA-7B's
   published widths (hidden 4096, MLP 11008, 32 layers, 32 heads, vocab
   32000, eps 1e-6), full depth, seeded random weights drawn on the card,
   in fp32 (TextModel's default) and int8_w, on 8 right-padded prompts of
   up to 32 token ids: finite pooled features, int8_w's cosine to fp32,
   the time per call, peak memory and the projections' bytes (int8_w at
   most 0.27 of fp32's); card against CPU at 2 layers, fp32, at
   OpenLLaMA-7B's and Mistral-7B's grouped-query widths (MLP 14336, 8 kv
   heads, eps 1e-5): min cosine 0.9999; and at DeepSeek-V2-Lite's widths,
   its dense layer and one MoE layer, with moe_gemm's launches of one
   call counted (two a MoE layer: the kernel table's count).
5f. resume (``[resume]``): the finetune CLI on the frozen ViT-B/16 grid
   (``smoke``) twice uninterrupted (their spread), then with
   --ckpt_every 20 in a subprocess killed (SIGKILL) once its first
   checkpoint is on disk, then rerun: it must resume and save the
   uninterrupted run's test_result.pth, bit for bit when the two
   uninterrupted runs are, else within their spread; then train()
   on RN50 ``smoke_full`` (checkpoints every 15 steps) twice uninterrupted
   and once stopped at 15 and resumed: the parameters, the BatchNorm
   statistics and the adamw state at step 30 held the same way.
5g. MultiBench (``[multibench]``): no kernel of the port runs (uml_tpu's
   model is plain jnp), and no launch counter may move over the phase.
   A seeded fixture in the reference schema at MUStARD's published widths
   (vision 371, audio 81, text 300; T = 50; 414 / 138 / 138 rows, labels
   +-1) and a MIMIC pickle (static [N, 5], series [N, 24, 12]): the
   multibench CLI on sarcasm at zdim 300 (5 heads of 60, FF 2048, 5
   layers, bs 128; learnable positions, 3 epochs, step_k 0, eval every 2
   batches, --robust_test, --ckpt_every 1), again with --infoNCE_loss, on
   MIMIC at zdim 40 (2 epochs), then collect_results_mb: finite scores,
   model.pth with the converter's tree at a fresh model's shapes and every
   tensor moved; card against CPU in fp32 without dropout from the same
   weights and batch (bs 128), for both critics: one forward (losses,
   zx / zy), one gradient, one Adam step (the losses after it), the
   effective rank; the CLI killed by SIGKILL at its first checkpoint and
   rerun, held to an uninterrupted run (bit for bit when two uninterrupted
   runs are); the staged full-width train step with MSE and InfoNCE: ms,
   its phases (forward, backward, Adam, the metrics with the
   effective-rank SVD), the device's busy share and the peak memory rise.
5h. Gaussian (``[gaussian]``): no kernel of the port runs (uml_tpu's loop
   is plain jnp), and no launch counter may move over the gaussian CLI
   at the paper's setting (configs/gaussian.yaml's combo with seed 0 and
   mode xy: 10,000 steps of batch 512, every step's eval over 2,000
   rows, the step two CUDA graphs around Adam's eager step); its
   results.json has uml_tpu's keys and metrics.jsonl a row a step; a
   100-step call timed and profiled (ms a step, the device's busy share);
   peak memory; card against CPU over 200 steps from one init and one
   index stream: losses and CKA within 1e-4 relative, mutual kNN within
   1e-3.
5i. Data parallelism (``[parallel]``): features and finetune
   --hyperparams smoke with --mesh auto against --mesh off on the one
   card, no process group: the same outputs.  Then a process group of
   world size 1 over NCCL and create_mesh() over it, passed to each loop
   as the CLIs pass it: the ViT-B/16 full-model step at batch 64 in each
   backward mode bit-equal to the step without a mesh (loss, every
   gradient, every updated parameter), rows 5-9, 19 and 20 launched
   under the mesh; validate (a ragged batch), features' image_features
   (the round robin gathered over NCCL) and one selfsup step (InfoNCE,
   dropout) bit-equal to theirs without it; the step's ms with and
   without the mesh, the gradient average alone, and a profile of both
   steps with the device kernels the mesh adds.
5j. Tensor parallelism (``[tp]``): a process group of world size 1 over
   NCCL and create_mesh(1, 1); parallel.apply_tp_sharding of each model
   over it (DTensors gathered whole where the model reads them): the
   LlamaEncoder at OpenLLaMA-7B's published widths and depth, seeded
   random weights drawn on the card, fp32 and int8_w, built by
   ``TextModel.native`` and sharded by apply_tp_sharding (7 / 12 tensors
   a layer): pooled features bit-equal to those without the mesh, ms a
   call of both; ``TextModel.native(..., mesh=)`` over the same mesh
   shards nothing (its model axis is one wide) and is bit-equal too; the
   ViT-B/16 image encoder in
   bf16, int8 and int8 with UML_TOWER_Q8=1 (batch 64): features
   bit-equal, rows 1-3, 10-12 launched as without the mesh, img/s of
   both; the full-model ViT-B/16 step (batch 64) with TP-applied weights
   in each backward mode: loss, gradients and updated parameters
   bit-equal to the step without, rows 5-9, 19 and 20 launched; the
   step's ms with and without, and a profile of both.  The
   features CLI with --mesh auto on one card builds no mesh ([parallel]
   holds its outputs to --mesh off).
5k. The graft entry (``[graft]``): uml_tpu_torch.graft_entry.entry()'s
   ViT-B/16 bf16 forward on the card: [8, 512], finite, 11 + 1 attention
   and 12 MLP halves launched, within cosine 0.999 of the same model on
   the CPU; then dryrun_multichip(4) on four gloo processes on the CPU,
   every leg passing.
6. the products of the engine (bf16 beside torch.matmul, int8 beside
   torch._int_mm) and the attention backward's passes as one JSON line,
   the kernel table as one JSON line, the device line last.

The script needs nothing of JAX.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import itertools
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
    # row 11 without an activation (uml_tpu's identity, the default of
    # ln_mlp_block_q8): c_fc's ROWABSMAX and QUANT passes; no model path
    # calls it, so its launches come from one public ln_mlp_block_q8 call
    ("mlp_block_q8_identity", "uml_tpu_torch/csrc/mlp_block_q8.cu",
     "uml_tpu/ops/quant.py:228"),
    ("tower_q8", "uml_tpu_torch/csrc/tower_q8.cu",
     "uml_tpu/ops/tower_q8.py:49"),
    ("attn_block_bwd_recompute", "uml_tpu_torch/csrc/attn_block_bwd.cu",
     "uml_tpu/ops/fused_attention.py:722"),
    ("mlp_bwd", "uml_tpu_torch/csrc/mlp_block_bwd.cu",
     "uml_tpu/ops/ln_matmul.py:310"),
    ("mlp_bwd_dw", "uml_tpu_torch/csrc/mlp_block_bwd.cu",
     "uml_tpu/ops/ln_matmul.py:417"),
    # KS, the stash backward: uml_tpu's is plain jnp that XLA fuses
    # (_mlp_bwd_via_stash, no Pallas kernel); one C entry here
    ("mlp_bwd_via_stash", "uml_tpu_torch/csrc/mlp_block_bwd.cu",
     "uml_tpu/ops/ln_matmul.py:256"),
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
    # DeepSeek-V2's routed experts, two launches a MoE layer: uml_tpu has
    # no mixture of experts, so the kernel replaces none of its kernels
    ("moe_gemm", "uml_tpu_torch/csrc/moe_gemm.cu", "none"),
]
# the DINO slice's entries of the kernel table: (name, the wrapper whose
# launches the [dino] phase counts, source, TPU kernel it replaces), held
# and timed at DINOv2-B/14 B = 64 (S = 257: the chain)
DINO_PORTS = [
    ("attn_block_dino", "attn_block", "uml_tpu_torch/csrc/attn_block.cu",
     "uml_tpu/ops/fused_attention.py:313"),
    ("attn_block_cls_dino", "attn_block_cls", "uml_tpu_torch/csrc/attn_block.cu",
     "uml_tpu/ops/fused_attention.py:475"),
    ("mlp_block_dino", "mlp_block", "uml_tpu_torch/csrc/mlp_block.cu",
     "uml_tpu/ops/ln_matmul.py:90"),
    ("attn_block_q8_dino", "attn_block_q8", "uml_tpu_torch/csrc/attn_block_q8.cu",
     "uml_tpu/ops/quant.py:168"),
    ("mlp_block_q8_dino", "mlp_block_q8", "uml_tpu_torch/csrc/mlp_block_q8.cu",
     "uml_tpu/ops/quant.py:228"),
    ("flash_attention_dino", "flash_attention", "uml_tpu_torch/csrc/flash_attention.cu",
     "uml_tpu/ops/attention.py:90"),
]
# the DINO training slice's entries (the full-model finetune at DINOv2-B/14:
# rows 5-8 at S = 257, eps 1e-6; rows 9, 19 and 20 with exact GELU): (name,
# the wrapper whose launches the [dino-train] CLI runs count, the backward
# mode of that run, source, TPU kernel it replaces), held and timed at
# B = 64 (16,448 rows)
DINO_TRAIN_PORTS = [
    ("attn_block_stash_dino", "attn_block_stash", "default",
     "uml_tpu_torch/csrc/attn_block.cu", "uml_tpu/ops/fused_attention.py:394"),
    ("attn_block_bwd_dino", "attn_block_bwd", "default",
     "uml_tpu_torch/csrc/attn_block_bwd.cu", "uml_tpu/ops/fused_attention.py:1209"),
    ("attn_block_bwd_recompute_dino", "attn_block_bwd_recompute", "kernel",
     "uml_tpu_torch/csrc/attn_block_bwd.cu", "uml_tpu/ops/fused_attention.py:722"),
    ("attn_block_cls_bwd_dino", "attn_block_cls_bwd", "default",
     "uml_tpu_torch/csrc/attn_block_bwd.cu", "uml_tpu/ops/fused_attention.py:1298"),
    ("mlp_block_stash_dino", "mlp_block_stash", "default",
     "uml_tpu_torch/csrc/mlp_block.cu", "uml_tpu/ops/ln_matmul.py:186"),
    ("mlp_bwd_dino", "mlp_bwd", "kernel",
     "uml_tpu_torch/csrc/mlp_block_bwd.cu", "uml_tpu/ops/ln_matmul.py:310"),
    ("mlp_bwd_dw_dino", "mlp_bwd_dw", "dw",
     "uml_tpu_torch/csrc/mlp_block_bwd.cu", "uml_tpu/ops/ln_matmul.py:417"),
    ("mlp_bwd_via_stash_dino", "mlp_bwd_via_stash", "default",
     "uml_tpu_torch/csrc/mlp_block_bwd.cu", "uml_tpu/ops/ln_matmul.py:256"),
]
# the engine's MLP-in and recompute instances a DINO train step must show
# in each backward mode, and the quick_gelu instances it must not: the
# exact-GELU stash (WGG_OUT_GELU_EXACT = 9 with aux), OUT_DACT_BF16_EXACT =
# 14 (row 19), OUT_DACT_EXACT = 13 (row 20), against OUT_GELU = 3,
# OUT_DACT_BF16 = 5, OUT_DACT = 2
DINO_TRAIN_ENGINE = {
    "default": ("wgmma_gemm_kernel<false, true, 9>", "wgmma_gemm_kernel<false, true, 3>"),
    "kernel": ("wgmma_gemm_kernel<false, true, 14>", "wgmma_gemm_kernel<false, true, 5>"),
    "dw": ("wgmma_gemm_kernel<false, true, 13>", "wgmma_gemm_kernel<false, true, 2>")}
DINO = "vit_base_patch14_dinov2.lvd142m"
DINO_LM = "bert-base-uncased"
TRAIN_PORTS = ("attn_block_stash", "attn_block_bwd", "attn_block_cls_bwd",
               "mlp_block_stash", "mlp_bwd_via_stash")
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
             "mlp_block_q8": 1 / 64, "mlp_block_q8_identity": 1 / 64,
             "tower_q8": 1 / 16,
             "attn_block_bwd_recompute": 1 / 64,
             "attn_block_bwd_recompute_causal": 1 / 64, "mlp_bwd": 1 / 64,
             "mlp_bwd_dw": 1 / 64, "mlp_bwd_via_stash": 1 / 64,
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
             "attn_bwd_dq": (1 / 64, 1e-3), "attn_bwd_dkv": (1 / 64, 1 / 64),
             # the grouped expert products, float32 on both sides (FFMA
             # against cuBLAS SGEMM, TF32 off): they differ in summation
             # order only, as the fp32 layer_norm, for the SwiGLU's
             # activation and the down product of the kernel's own
             "moe_gemm": (1e-5, 1e-5),
             # the DINO path's kernels at DINOv2-B/14 B = 64: as above
             **{name: 1 / 64 for name, _, _, _ in DINO_PORTS},
             **{name: 1 / 64 for name, _, _, _, _ in DINO_TRAIN_PORTS}}
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
# the same with exact GELU (DINO): c_fc's quantizing pass WGG_OUT_Q8_ACTQ_GELU
Q8_MLP_GELU_KERNELS = (*Q8_MLP_KERNELS[:2], "wgmma_gemm_kernel<false, false, 12>",
                       Q8_MLP_KERNELS[3])
# and without an activation: WGG_OUT_Q8_ROWABSMAX = 15, WGG_OUT_Q8_QUANT = 16
Q8_MLP_IDENTITY_KERNELS = (Q8_MLP_KERNELS[0], "wgmma_gemm_kernel<false, false, 15>",
                           "wgmma_gemm_kernel<false, false, 16>", Q8_MLP_KERNELS[3])
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
# the float32 FMA rate off the tensor cores (the same data sheet): the
# grouped expert kernel's products are FFMA
PEAK_FP32 = 67e12
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
# an RN tower's running statistics after one fp32 step, card vs CPU
BN_STAT_RTOL = 1e-4


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


def _bound(inputs, outputs, int8_ops=0.0, bf16_flops=0.0, flops_peak=PEAK_BF16):
    """-> (bound ms, "bytes" or "operations") for one call; the FLOPs at
    ``flops_peak`` (bf16's unless the case runs at another rate)."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = int8_ops / PEAK_INT8 + bf16_flops / flops_peak
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


def _identity_flips(xv, q8v, eps=1e-5):
    """Row 11 without an activation: the int8 hidden of the card (read
    from the launch's scratch) against quantize_rows of the plain
    pre-activation -> (share of integers that differ, largest
    difference)."""
    from uml_tpu_torch.ops import quant as q8

    w1q, w1sc, b1, w2q, w2sc, b2 = q8v[6:]
    k = xv.shape[-1]
    xq, xs = q8.ln_quantize_rows(xv.float().reshape(-1, k), eps)
    want = q8.quantize_rows(q8.q8_dot(xq, xs, w1q, w1sc) + b1)[0]
    got = q8._launch_mlp_block_q8(xv, w1q.t(), w1sc, b1, w2q.t(), w2sc, b2, eps,
                                  None)[1]
    diff = (got[:want.numel()].view_as(want).int() - want.int()).abs()
    return (diff > 0).float().mean().item(), diff.max().item()


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
    # the MLP backward kernels: dy = g . w2^T in bf16 (what mlp_bwd takes),
    # and the plain stash forward's pre (what mlp_bwd_via_stash takes)
    dy_v = torch.matmul(g_v, wv["w2"].t())
    pre_v = lm.mlp_block_stash_plain(xv, *mlp_v)[1]
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
        # KS: dy, dxn, dw1 and dw2 from the stash, four such products
        ("mlp_bwd_via_stash", lm.mlp_bwd_via_stash, lm.mlp_bwd_via_stash_plain,
         (xv, g_v, pre_v, *mlp_v), 0, 2 * mlp_f, vit_fc),
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
        ("mlp_block_q8_identity", lambda *a: q8.mlp_block_q8(*a, activation=None),
         lambda *a: q8.mlp_block_q8_plain(*a, activation=None),
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
              + _product_cases(gen, dev, xv, g_v, wv, qkv_v)
              + _dino_cases(dev) + _dino_train_cases(dev))
    results = _hold_and_time(cases, dev)
    del cases
    results.update(_hold_and_time(_moe_gemm_cases(dev), dev, flops_peak=PEAK_FP32))
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
        share, worst = _identity_flips(xv, weights())
        print(f"[kernels] int8 integers ({tag}), mlp_hidden without an activation: "
              f"{100 * share:.4f}% differ from the plain version's, largest "
              f"difference {worst}")
        _check(worst <= 1, (tag, "identity hidden differs by more than one step", worst))
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
    # without an activation: c_fc's abs-max and quantizing passes in their
    # place
    names = _kernel_names(_profile(
        "row 11 mlp_block_q8, no activation",
        lambda: q8.mlp_block_q8(xv, *q8v[6:], activation=None)))
    _check(len(names) == len(Q8_MLP_IDENTITY_KERNELS)
           and all(sum(part in n for n in names) == 1 for part in Q8_MLP_IDENTITY_KERNELS),
           ("row 11 without an activation: ln_quantize_rows, ROWABSMAX, QUANT and "
            "c_proj only", names))
    results["mlp_block_q8_identity"]["profile_kernels"] = names
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
    results["mlp_block_q8_dino"]["profile_kernels"] = _dino_q8_checks(dev)
    return results


# one DeepSeek-V2-Lite MoE layer's routed rows at the benchmark cell's
# load (30 rows of ~38 padded tokens, top-6: ~6,840 rows over 64
# experts): uneven, four experts empty, partial tiles
MOE_SIZES = [0, 1, 63, 64, 65, 700, 0, 129, 0, 3, 0, 250] + [107] * 51 + [108]


def _moe_gemm_cases(dev):
    """The grouped expert kernel at DeepSeek-V2-Lite's widths and the
    cell's load (MOE_SIZES): both launches of one MoE layer, SwiGLU's gate
    and up products K 2048 -> N 1408, then the down product 1408 -> 2048,
    against moe_gemm_plain (one cuBLAS product a projection an expert).
    Its FLOPs count at float32's FMA rate; its bytes are every expert's
    weights read once and the rows in and out once -> cases of
    ``_hold_and_time``."""
    import torch

    from uml_tpu_torch.ops import moe_gemm as mg

    gen = torch.Generator(device=dev).manual_seed(26)
    k, m, g = 2048, 1408, len(MOE_SIZES)
    r = sum(MOE_SIZES)
    a = torch.randn(r, k, generator=gen, device=dev)
    w_gate, w_up = (torch.randn(g, m, k, generator=gen, device=dev) * k ** -0.5
                    for _ in range(2))
    w_down = torch.randn(g, k, m, generator=gen, device=dev) * m ** -0.5
    offsets = torch.tensor([0, *itertools.accumulate(MOE_SIZES)], dtype=torch.int32,
                           device=dev)
    # the pointer tables, made outside any graph capture (the weights take
    # more than twice the L2, so the timing has one copy of the inputs)
    tables = {w.data_ptr(): mg.expert_table(list(w)) for w in (w_gate, w_up, w_down)}

    def kernel(a, offsets, w_gate, w_up, w_down):
        act = mg.moe_gemm(a, offsets, tables[w_gate.data_ptr()], m, tables[w_up.data_ptr()])
        return act, mg.moe_gemm(act, offsets, tables[w_down.data_ptr()], k)

    def plain(a, offsets, w_gate, w_up, w_down):
        act = mg.moe_gemm_plain(a, MOE_SIZES, list(w_gate), list(w_up))
        return act, mg.moe_gemm_plain(act, MOE_SIZES, list(w_down))

    return [("moe_gemm", kernel, plain, (a, offsets, w_gate, w_up, w_down), 0,
             6.0 * r * k * m, (None,) * 4)]


def _hold_and_time(cases, dev, flops_peak=PEAK_BF16):
    """Each case's kernel against its plain version on the same inputs,
    within its REL_BOUND, then kernel, plain, library call and cuBLAS
    yardstick graph-timed on the card, with the case's bound (its FLOPs
    at ``flops_peak``) -> {name: numbers}."""
    import torch

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
        bound_ms, bound_by = _bound(inputs, got, ops8, flops16, flops_peak)
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


def _dino_inputs(dev):
    """The DINO path's layer at DINOv2-B/14 B = 64 (S = 257, K = 768, 12
    heads, M = 3072), from a generator of its own (every other case's data
    is drawn as before): x, the bf16 folded weights, the int8 weights as
    the model hands them to the ops."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(64, 257, 768, generator=gen, device=dev).to(torch.bfloat16)
    return (x, _block_weights(gen, 768, 3072, 768, dev),
            _q8_case_weights(gen, 768, 3072, 768, dev))


def _dino_cases(dev):
    """Phase-2 cases of the DINO path's kernels at DINOv2-B/14 B = 64 (the
    entries of DINO_PORTS): the attention halves and the int8 attention
    half on the chain (S = 257 > 256), the MLP halves with exact GELU and
    eps 1e-6, and row 13 at [64, 12, 257, 64] beside SDPA."""
    import torch

    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8

    x, wv, q8v = _dino_inputs(dev)
    b, s, k = x.shape
    rows, m, eps = b * s, 3072, 1e-6
    attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
    mlp_v = (wv["w1"], wv["b1"], wv["w2"], wv["b2"])
    qkv_f, out_f, mlp_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k, 4.0 * rows * k * m
    attn_f = _attn_flops(b, s, 12)
    qkv = fa.attn_block_stash_plain(x, *attn_v, heads=12, eps=eps)[1]
    heads = fa._qkv_heads(qkv, 12)
    gelu = dict(eps=eps, activation="gelu_exact")

    def q8_attn(fn):
        return lambda x, wq, wsc, be, wo, wosc, bo: fn(x, wq, wsc, be, (wo, wosc), bo,
                                                       heads=12, eps=eps)

    return [
        ("attn_block_dino", lambda *a: fa.attn_block(*a, heads=12, eps=eps),
         lambda *a: fa.attn_block_plain(*a, heads=12, eps=eps), (x, *attn_v), 0,
         qkv_f + out_f + attn_f, (rows, k, 3 * k, False)),
        ("attn_block_cls_dino", lambda *a: fa.attn_block_cls(*a, heads=12, eps=eps),
         lambda *a: fa.attn_block_cls_plain(*a, heads=12, eps=eps), (x, *attn_v), 0,
         2.0 * rows * k * 2 * k + 4.0 * b * k * k + _attn_flops(b, s, 12, q_rows=1),
         (rows, k, 3 * k, False)),
        ("mlp_block_dino", lambda *a: lm.mlp_block(*a, **gelu),
         lambda *a: lm.mlp_block_plain(*a, **gelu), (x, *mlp_v), 0, mlp_f,
         (rows, k, m, False)),
        ("attn_block_q8_dino", q8_attn(q8.attn_block_q8), q8_attn(q8.attn_block_q8_plain),
         (x, *q8v[:6]), qkv_f + out_f, attn_f, (rows, k, 3 * k, True)),
        ("mlp_block_q8_dino", lambda *a: q8.mlp_block_q8(*a, **gelu),
         lambda *a: q8.mlp_block_q8_plain(*a, **gelu), (x, *q8v[6:]), mlp_f, 0,
         (rows, k, m, True)),
        ("flash_attention_dino", at.flash_attention, at.attention_plain,
         tuple(t.contiguous() for t in heads), 0, attn_f, (None,) * 4,
         torch.nn.functional.scaled_dot_product_attention),
    ]


def _dino_train_cases(dev):
    """Phase-2 cases of the DINO full-model finetune's training rows at
    DINOv2-B/14 B = 64 (the entries of DINO_TRAIN_PORTS; the layer of
    ``_dino_inputs``, eps 1e-6): rows 5-8 on the chain (S = 257), rows 9,
    19 and 20 with exact GELU; the backwards take the plain stash forward's
    qkv and random cotangents."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm

    x, wv, _ = _dino_inputs(dev)
    b, s, k = x.shape
    rows, m, eps = b * s, 3072, 1e-6
    gen = torch.Generator(device=dev).manual_seed(3)
    g = torch.randn(b, s, k, generator=gen, device=dev).to(torch.bfloat16)
    g1 = torch.randn(b, 1, k, generator=gen, device=dev).to(torch.bfloat16)
    attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
    mlp_v = (wv["w1"], wv["b1"], wv["w2"], wv["b2"])
    qkv = fa.attn_block_stash_plain(x, *attn_v, heads=12, eps=eps)[1]
    qkv_c = fa.attn_block_stash_plain(x, *attn_v, heads=12, eps=eps, q_rows=1)[1]
    dy = torch.matmul(g, wv["w2"].t())           # row 19's bf16 dy = g . w2^T
    pre = lm.mlp_block_stash_plain(x, *mlp_v, eps=eps, activation="gelu_exact")[1]
    qkv_f, out_f, mlp_f = 2.0 * rows * k * 3 * k, 2.0 * rows * k * k, 4.0 * rows * k * m
    attn_f = _attn_flops(b, s, 12)
    yard_qkv, yard_fc = (rows, k, 3 * k, False), (rows, k, m, False)
    att = dict(heads=12, eps=eps)
    gelu = dict(eps=eps, activation="gelu_exact")
    return [
        ("attn_block_stash_dino", lambda *a: fa.attn_block_stash(*a, **att),
         lambda *a: fa.attn_block_stash_plain(*a, **att), (x, *attn_v), 0,
         qkv_f + out_f + attn_f, yard_qkv),
        # dattn = g . wo^T, the attention backward (10 S^2 D per head), dxn
        ("attn_block_bwd_dino", lambda *a: fa.attn_block_bwd(*a, **att),
         lambda *a: fa.attn_block_bwd_plain(*a, **att),
         (x, g, qkv, wv["w_eff"], wv["wo"]), 0, out_f + 2.5 * attn_f + qkv_f, yard_qkv),
        ("attn_block_bwd_recompute_dino",
         lambda *a: fa.attn_block_bwd_recompute(*a, **att),
         lambda *a: fa.attn_block_bwd_recompute_plain(*a, **att),
         (x, g, *attn_v[:3]), 0, 2 * qkv_f + out_f + 3.5 * attn_f, yard_qkv),
        # as the ViT-B/16 case: the dense dxn's FLOPs, an upper bound
        ("attn_block_cls_bwd_dino", lambda *a: fa.attn_block_cls_bwd(*a, **att),
         lambda *a: fa.attn_block_cls_bwd_plain(*a, **att),
         (x, g1, qkv_c, wv["w_eff"], wv["wo"]), 0,
         2.0 * rows * 2 * k * k + 4.0 * b * k * k
         + 2.5 * _attn_flops(b, s, 12, q_rows=1), (rows, k, 2 * k, False)),
        ("mlp_block_stash_dino", lambda *a: lm.mlp_block_stash(*a, **gelu),
         lambda *a: lm.mlp_block_stash_plain(*a, **gelu), (x, *mlp_v), 0, mlp_f,
         yard_fc),
        # pre = xn . w1 and dxn = dpre . w1^T
        ("mlp_bwd_dino", lambda *a: lm.mlp_bwd(*a, **gelu),
         lambda *a: lm.mlp_bwd_plain(*a, **gelu), (x, dy, wv["b1"], wv["w1"]), 0,
         mlp_f, yard_fc),
        # dy, pre, dxn, dw1 and dw2: five [rows] x [K] x [M] products
        ("mlp_bwd_dw_dino", lambda *a: lm.mlp_bwd_dw(*a, **gelu),
         lambda *a: lm.mlp_bwd_dw_plain(*a, **gelu),
         (x, g, wv["b1"], wv["w1"], wv["w2"]), 0, 2.5 * mlp_f, yard_fc),
        # KS: dy, dxn, dw1 and dw2 from the stash
        ("mlp_bwd_via_stash_dino", lambda *a: lm.mlp_bwd_via_stash(*a, **gelu),
         lambda *a: lm.mlp_bwd_via_stash_plain(*a, **gelu), (x, g, pre, *mlp_v), 0,
         2 * mlp_f, yard_fc),
    ]


def _dino_q8_checks(dev):
    """Row 11 with exact GELU at DINOv2-B/14 B = 64: the LN-quantized rows
    (c_fc's operand, left in the scratch) against the plain version's, then
    the int8 hidden and its row scales against the plain act quantization
    of the exact pre-activation of the card's own operand (integers within
    one step on at most 0.1% of them, scales rtol 1e-6: the plain operand
    can differ from the card's at a .5 tie, which moves a row's max), and
    a profile of one call: the LN quantize pass, ROWMAX, the exact-GELU
    quantizing pass and c_proj, nothing else -> the profile's kernel
    names."""
    import torch

    from uml_tpu_torch.ops import quant as q8

    x, _, q8v = _dino_inputs(dev)
    w1q, w1sc, b1, w2q, w2sc, b2 = q8v[6:]
    rows, k, m, eps = x.shape[0] * x.shape[1], x.shape[2], w1sc.shape[0], 1e-6
    _, hq, hs = q8._launch_mlp_block_q8(x, w1q.t(), w1sc, b1, w2q.t(), w2sc, b2, eps,
                                        "gelu_exact")
    xq, xs = hq[rows * m:rows * (m + k)].view(rows, k), hs[rows:2 * rows, None]
    want_xq = q8.ln_quantize_rows(x.float().reshape(rows, k), eps)[0]
    want_q, want_s = q8.act_quantize_rows(q8.q8_dot(xq, xs, w1q, w1sc) + b1,
                                          "gelu_exact")
    torch.cuda.synchronize()
    flips = {}
    for name, got, want in (("ln_quantize_rows", xq, want_xq),
                            ("mlp_hidden", hq[:rows * m].view(rows, m), want_q)):
        diff = (got.int() - want.int()).abs()
        flips[name] = ((diff > 0).float().mean().item(), diff.max().item())
    scale_err = ((hs[:rows] - want_s[:, 0]).abs() / want_s[:, 0]).max().item()
    print(f"[kernels] int8 integers (DINOv2-B/14, exact GELU): "
          + "; ".join(f"{name} {100 * share:.4f}% differ from the plain version's, "
                      f"largest difference {worst}" for name, (share, worst) in flips.items())
          + f"; hidden row scales max rel err {scale_err:.2e}")
    share, worst = flips["mlp_hidden"]
    _check(worst <= 1 and share <= 1e-3 and scale_err <= 1e-6
           and flips["ln_quantize_rows"][1] <= 1,
           ("row 11 exact GELU: integers or scales", flips, scale_err))
    names = _kernel_names(_profile(
        "row 11 mlp_block_q8, exact GELU (DINOv2-B/14)",
        lambda: q8.mlp_block_q8(x, *q8v[6:], eps=eps, activation="gelu_exact")))
    _check(len(names) == len(Q8_MLP_GELU_KERNELS)
           and all(sum(part in n for n in names) == 1 for part in Q8_MLP_GELU_KERNELS),
           ("row 11 exact GELU: ln_quantize_rows, ROWMAX, ACTQ_GELU, c_proj", names))
    return names


def _wrappers():
    """Every port's wrapper by its name in PORTS: each counts its launches
    on ``.launches``."""
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops import text_tower as tt
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import layer_norm
    from uml_tpu_torch.ops import moe_gemm as mg
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
            "mlp_bwd_via_stash": lm.mlp_bwd_via_stash,
            "qkv_attention": fa.qkv_attention,
            "qkv_attention_q8": q8.qkv_attention_q8, "moe_gemm": mg.moe_gemm}


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


def _photo_fixture(root, n=128, hw=(375, 500)):
    """``n`` JPEGs of ``hw`` (500 x 375, the ImageNet-typical size, where
    the native decoder's IDCT scaling applies): smooth synthetic photos
    with a little noise, quality 90 -> their paths."""
    import numpy as np
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    paths = []
    for i in range(n):
        f = rng.uniform(15, 60, 3)
        arr = np.stack([128 + 100 * np.sin(xx / f[0] + i) * np.cos(yy / f[1]),
                        128 + 80 * np.cos(xx / f[2] - i),
                        128 + 90 * np.sin(yy / f[0] + 2 * i)], -1)
        arr += rng.normal(0, 6, arr.shape)
        path = os.path.join(root, f"photo_{i:03d}.jpg")
        Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(path, quality=90)
        paths.append(path)
    return paths


def _native_decoder(root):
    """Build the native decoder from the checkout (uml_tpu_torch/native)
    and, apart, the reference source uml_tpu/native/jpeg_decoder.cpp ->
    (the port's decode function, the reference library) or (None, None)
    with a printed reason where the machine has no libjpeg headers.  A
    failed build where ``jpeglib.h`` exists ends the run."""
    from uml_tpu_torch import native

    if not native.native_available():
        reason = native.unavailable_reason()
        _check(not os.path.exists("/usr/include/jpeglib.h"),
               f"native decoder build failed with jpeglib.h present: {reason}")
        print(f"[main] native decoder: unavailable ({reason}); every native "
              f"rate below is not measured")
        return None, None
    ref = native.load(native.build(
        src=os.path.join(ROOT, "uml_tpu", "native", "jpeg_decoder.cpp"),
        lib_path=os.path.join(ROOT, "build", "chip_smoke_ref_native",
                              "libuml_jpeg.so")))
    print(f"[main] native decoder: built {native.library_path()}")
    return native.fast_decode_jpeg, ref


def _decode_rates(root, n_images=1024):
    """The host's decode rates, data/loader.py's ImageBatchLoader (decode,
    resize and center crop to 224 x 224 uint8, batches of 64) over two
    fixtures, each repeated to ``n_images`` (a quarter of them at one
    worker): the phase's 240 x 320 noise
    JPEGs and 128 500 x 375 photos.  PIL and the native decoder, each in
    threads and in the spawn pool (warmed first: the pool persists), at
    one worker and at one per core, with a prefetch window of twice the
    workers (a worker decodes a whole batch).  The native output must
    equal the reference source's, built apart, byte for byte on every
    fixture image -> {key: img/s}."""
    import glob

    import numpy as np

    from uml_tpu_torch import native
    from uml_tpu_torch.data.loader import ImageBatchLoader
    from uml_tpu_torch.data.transforms import load_uint8

    gpu = _gpu_line()
    fixtures = {
        "240x320": sorted(glob.glob(os.path.join(
            root, "caltech-101", "101_ObjectCategories", "*", "*.jpg"))),
        "500x375": _photo_fixture(os.path.join(root, "photos_500x375")),
    }
    _check(all(fixtures.values()), "fixture JPEGs")
    decode, ref = _native_decoder(root)
    out = {"native_decoder_available": decode is not None}
    if decode is not None:
        for name, paths in fixtures.items():
            gaps = []
            for p in paths:
                got = decode(p)
                _check(np.array_equal(got, native.decode_with(ref, p)),
                       f"native decode of {p} differs from the reference source's")
                gaps.append(np.abs(got.astype(int) - load_uint8(p).astype(int)).mean())
            out[f"native_vs_pil_mean_abs_{name}"] = float(np.mean(gaps))
            print(f"[main] native decode of the {name} fixture: bytes equal to the "
                  f"reference source's on {len(paths)} images; mean |native - PIL| "
                  f"{np.mean(gaps):.3f} / 255")
    cores = os.cpu_count() or 1
    kinds = [("pil_thread", False, "thread"), ("pil_process", False, "process")]
    if decode is not None:
        kinds += [("native_thread", True, "thread"), ("native_process", True, "process")]
    for name, paths in fixtures.items():
        items = [{"impath": paths[i % len(paths)], "label": 0}
                 for i in range(n_images)]
        for kind, fast, worker_kind in kinds:
            for workers in (1, cores):
                def run(batch_items):
                    n = 0
                    for imgs, _, _ in ImageBatchLoader(
                            batch_items, "crop", 64, num_workers=workers,
                            fast_decode=fast, worker_kind=worker_kind,
                            prefetch=2 * workers):
                        n += len(imgs)
                    return n
                if worker_kind == "process":
                    run(items[:64])   # the pool's start (spawn, imports) is set-up
                # one worker decodes a quarter of the images (its rate needs
                # no more batches to settle, and it runs ~5x longer a batch)
                t0 = time.perf_counter()
                n = run(items if workers > 1 else items[:n_images // 4])
                rate = n / (time.perf_counter() - t0)
                out[f"pipeline_host_decode_img_per_s_{kind}_{name}_{workers}w"] = rate
                print(f"[main] decode {kind} ({name} JPEG -> 224x224 crop), "
                      f"{workers} worker(s): {n} images, {rate:.1f} img/s  [{gpu}]")
        if decode is None:
            for kind in ("native_thread", "native_process"):
                print(f"[main] decode {kind} ({name}): not measured (no native "
                      f"decoder)")
    return out


def _pipeline_rates(encoder, root, sizes, n_images=2048, batch=64):
    """JPEG to features on the bf16 ViT-B/16 encoder over ``n_images`` (the
    fixture's JPEGs repeated), batch 64: the parent's loop (PIL threads,
    4 batches in flight, each batch encoded and read before the next) and
    the pipelined loop of cli/features.py::image_features in threads and
    in the spawn pool (UML_DECODE_WORKERS), one worker per core, the pool
    also with its outputs read at once (``FETCH_WINDOW`` 0) and only at
    the split's end (2048 / 64 = 32); each timed twice in turns (forward,
    then backward order); img/s and the device's busy share of each.
    Then the pipelined features CLI caches must equal a batch-by-batch
    synchronous encode of the same pixels bit for bit, and a pool worker
    killed halfway through sending a batch must break that iterator
    (BrokenProcessPool, no hang) and leave the next extraction to rebuild
    the pool and finish -> numbers."""
    import glob
    import signal
    from concurrent.futures.process import BrokenProcessPool

    import numpy as np

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.data import loader as ld
    from uml_tpu_torch.data.feature_cache import img_outdir, load_cache

    gpu = _gpu_line()
    cores = os.cpu_count() or 1
    paths = sorted(glob.glob(os.path.join(
        root, "caltech-101", "101_ObjectCategories", "*", "*.jpg")))
    items = [{"impath": paths[i % len(paths)], "label": 0} for i in range(n_images)]

    def parent_loop():
        for imgs, _, _ in ld.ImageBatchLoader(items, "crop", batch, num_workers=cores,
                                              fast_decode=False):
            encoder.encode_images(imgs)

    def pipelined(kind, window=1):
        def run():
            default, feat.FETCH_WINDOW = feat.FETCH_WINDOW, window
            try:
                with _env({"UML_DECODE_WORKERS": kind}):
                    return feat.image_features(encoder, items, "crop", batch, cores)
            finally:
                feat.FETCH_WINDOW = default
        return run

    _check(feat.FETCH_WINDOW == 1, "the features loop reads one dispatch late")
    out = {}
    results = {}
    loops = {"parent_sync_pil": parent_loop, "pipelined_thread": pipelined("thread"),
             "pipelined_process": pipelined("process"),
             "pipelined_process_window0": pipelined("process", 0),
             "pipelined_process_window32": pipelined("process", n_images // batch)}
    walls = {name: [] for name in loops}
    for fn in loops.values():
        fn()   # warm: the pool's start, the kernels' first calls
    # in turns, forward then backward, so host drift hits every loop alike
    for name in list(loops) + list(loops)[::-1]:
        t0 = time.perf_counter()
        results[name] = loops[name]()
        walls[name].append(time.perf_counter() - t0)
    for name, fn in loops.items():
        wall = sum(walls[name]) / len(walls[name])
        rows = _profile(f"JPEG to features, {name}", fn, reps=1)
        busy = _busy_share(rows, wall * 1e3, reps=1)
        out[f"pipeline_img_per_s_{name}"] = n_images / wall
        out[f"pipeline_device_busy_{name}"] = busy
        print(f"[main] JPEG to features ({name}, ViT-B/16 bf16, batch {batch}, "
              f"{cores} workers): {n_images} images in "
              f"{', '.join(f'{w:.3f}' for w in walls[name])} s = "
              f"{', '.join(f'{n_images / w:.1f}' for w in walls[name])} img/s, "
              f"mean {n_images / wall:.1f}, device busy {busy:.3f}  [{gpu}]")
    _check(all(np.array_equal(results["pipelined_thread"]["features"], r["features"])
               for name, r in results.items() if name.startswith("pipelined")),
           "thread and process pipelines, every window, give the same features")

    # the features CLI's caches (pipelined) against a batch-by-batch encode
    for mode, splits in (("train", ("train", "val")), ("test", (None,))):
        cache = load_cache(img_outdir(f"{root}/features", "ViT-B/16", "caltech101",
                                      "crop", 16, 1, mode))
        for split in splits:
            c = cache[split] if split else cache
            feats = [encoder.encode_images(imgs) for imgs, _, _ in ld.ImageBatchLoader(
                [{"impath": p, "label": 0} for p in c["paths"]], "crop", batch,
                num_workers=cores)]
            _check(np.array_equal(c["features"], np.concatenate(feats)),
                   f"pipelined {split or mode} cache equals the synchronous encode")
    print("[main] the pipelined caches equal a batch-by-batch synchronous encode "
          "bit for bit")

    # a pool worker killed halfway through sending a batch (9.6 MB, more
    # than a pipe holds: with nobody reading, a worker whose first bytes
    # have arrived sits in its send): that iterator raises, the next
    # extraction rebuilds the pool
    def wait_until(cond):
        for _ in range(600):
            if cond():
                return True
            time.sleep(0.1)
        return False

    small = items[:6 * batch]
    it = iter(ld.ImageBatchLoader(small, "crop", batch, num_workers=cores,
                                  worker_kind="process", prefetch=2))
    next(it)   # two batches now in flight, unread
    pool = ld._PROC_POOLS[cores]
    _check(wait_until(lambda: any(c.poll() for c in pool.conns)), "a worker sending")
    sending = next(i for i, c in enumerate(pool.conns) if c.poll())
    os.kill(pool.procs[sending].pid, signal.SIGKILL)
    t0 = time.perf_counter()
    try:
        for _ in it:
            pass
        broke = False
    except BrokenProcessPool:
        broke = True
    raised_s = time.perf_counter() - t0
    _check(broke and pool.broken, "the iterator of the broken pool raised BrokenProcessPool")
    again = pipelined("process")()
    _check(ld._PROC_POOLS[cores] is not pool, "the broken pool was rebuilt")
    _check(np.array_equal(again["features"], results["pipelined_process"]["features"]),
           "the rebuilt pool's extraction equals the first")
    print(f"[main] killed one decode worker halfway through sending a batch: "
          f"that iterator raised BrokenProcessPool after {raised_s:.3f} s; the "
          f"next extraction rebuilt the pool and finished, features equal")
    return out


def _features_args(root, batch, feature_dir, quant="none", encoder="ViT-B/16"):
    """The features CLI's flags on the phase-3 fixture; ``encoder`` None
    leaves out --clip-encoder (the default, RN50)."""
    from uml_tpu_torch.cli import features as feat

    args = feat.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", feature_dir, "--dataset", "caltech101",
        *(["--clip-encoder", encoder] if encoder else []), "--allow-random-init",
        "--train-shot", "16", "--seed", "1",
        "--text-augmentation", "hand_crafted", "--batch-size", str(batch),
        "--quant", quant])
    args.overwrite = False
    args.force_rerun = False
    return args


def _check_caches(feature_dir, sizes, n_classes, encoder="ViT-B/16", width=512):
    """The image caches of the three splits and the text cache hold finite
    features of ``width`` -> (train, test, text) caches."""
    import numpy as np

    from uml_tpu_torch.data.feature_cache import img_outdir, load_cache, text_outdir

    img_path = img_outdir(feature_dir, encoder, "caltech101", "crop",
                          16, 1, "train")
    test_path = img_outdir(feature_dir, encoder, "caltech101", "crop",
                           16, 1, "test")
    txt_path = text_outdir(feature_dir, encoder, "caltech101",
                           "hand_crafted")
    img, test, txt = load_cache(img_path), load_cache(test_path), load_cache(txt_path)
    for name, split, n in (("train", img["train"], sizes["train"]),
                           ("val", img["val"], sizes["val"]),
                           ("test", test, sizes["test"])):
        f = split["features"]
        _check(f.shape == (n, width) and np.isfinite(f).all(), (name, f.shape))
    _check(txt["features"].shape == (n_classes, width)
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
    pipeline = _pipeline_rates(encoder, root, sizes)

    # steady-state encoder throughput on a staged batch (decode excluded)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    staged, n = encoder.stage_images(u8)
    ms = _time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
    rate = {"features_wall_s": wall,
            "features_images": sum(sizes.values()),
            "encoder_img_per_s_bs64": batch / (ms / 1e3), **decode, **pipeline}
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
    launches["mlp_block_q8_identity"] = _identity_public_call(staged.pixels.device)
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


def _identity_public_call(dev):
    """Row 11 without an activation through uml_tpu's public signature,
    ``ln_mlp_block_q8`` with its default activation (None), at ViT-B/16
    widths, batch 64: one launch of the int8 MLP half, nothing else, and
    the output within 1/64 of the plain version on the same folded and
    quantized weights -> its launches."""
    import torch

    from uml_tpu_torch.ops import quant as q8
    from uml_tpu_torch.ops.fused_attention import fold_ln_into_matmul

    gen = torch.Generator(device=dev).manual_seed(20)
    k, m = 768, 3072
    x = torch.randn(64, 197, k, generator=gen, device=dev).to(torch.bfloat16)
    scale = 1 + 0.1 * torch.randn(k, generator=gen, device=dev)
    bias = 0.05 * torch.randn(k, generator=gen, device=dev)
    w1 = torch.randn(k, m, generator=gen, device=dev) * k ** -0.5
    b1 = 0.02 * torch.randn(m, generator=gen, device=dev)
    w2 = (torch.randn(m, k, generator=gen, device=dev) * m ** -0.5).to(torch.bfloat16)
    b2 = 0.02 * torch.randn(k, generator=gen, device=dev)
    with torch.no_grad():
        got, launches = _counted(lambda: q8.ln_mlp_block_q8(x, scale, bias, w1, b1, w2, b2))
        w1_eff, b1_eff = fold_ln_into_matmul(scale, bias, w1, b1)
        w1q, w1sc = q8.quantize_weight(w1_eff)
        w2q, w2sc = q8.quantize_weight(w2)
        want = q8.mlp_block_q8_plain(x, w1q, w1sc, b1_eff, w2q, w2sc, b2.float(),
                                     activation=None)
    want_launches = dict.fromkeys(launches, 0)
    want_launches["mlp_block_q8"] = 1
    _check(launches == want_launches, ("ln_mlp_block_q8's default", launches))
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    _check(err <= 1 / 64, ("ln_mlp_block_q8's default vs plain", err))
    print(f"[int8] ln_mlp_block_q8 with its default activation (None) at ViT-B/16 "
          f"widths, batch 64: one int8 MLP half launched, max |kernel - plain| / "
          f"max |plain| {err:.5f}")
    return launches["mlp_block_q8"]


def phase_rn(root, sizes):
    """[rn]: features with no --clip-encoder (RN50, the CLI default), random
    init, on the phase-3 fixture, in bf16 and with --quant int8 (which the
    RN models ignore); the frozen finetune on its caches; RN101 on a batch
    of 4; the RN50 and RN101 image encoders' img/s -> ({text_tower:
    launches}, numbers)."""
    import numpy as np
    import torch

    from uml_tpu_torch import native
    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.models.encoders import ClipEncoder

    gpu = _gpu_line()
    batch, n_classes = 64, 8
    decoder = "native-libjpeg" if native.native_available() else "pil"
    numbers, caches, counts = {}, {}, {}
    for quant in ("none", "int8"):
        fdir = f"{root}/features_rn_{quant}"
        args = _features_args(root, batch, fdir, quant, encoder=None)
        _check(args.clip_encoder == "RN50", args.clip_encoder)
        t0 = time.perf_counter()
        encoder, launches = _counted(lambda: feat.main(args))
        wall = time.perf_counter() - t0
        # the RN image tower runs cuDNN convolutions, no port; the text
        # tower is one text_tower launch per class
        want = dict.fromkeys(launches, 0)
        want["text_tower"] = n_classes
        print(f"[rn] features (no --clip-encoder: RN50) --quant {quant} CLI "
              f"{wall:.2f} s; launches { {k: v for k, v in launches.items() if v} }")
        _check(launches == want, (quant, launches, want))
        _check(all(p.device.type == "cuda" for p in encoder.model.parameters()),
               "RN50 encoder parameters on the card")
        caches[quant] = _check_caches(fdir, sizes, n_classes, "RN50", 1024)
        img, test, _ = caches[quant]
        used = {img["train"]["decoder"], img["val"]["decoder"], test["decoder"]}
        _check(used == {decoder}, (used, decoder))
        numbers[f"rn50_features_wall_s_{quant}"] = wall
        if quant == "none":
            counts = launches
            cos_img, cos_txt = _card_vs_cpu_features(encoder, test["paths"], "rn")
            numbers.update(rn50_card_vs_cpu_cos_img=cos_img,
                           rn50_card_vs_cpu_cos_txt=cos_txt)
            rn50 = encoder
        else:
            del encoder
    print(f"[rn] the caches say decoder {decoder!r}")
    (a_img, a_test, a_txt), (b_img, b_test, b_txt) = caches["none"], caches["int8"]
    cos_q = min(_cos_min(a["features"], b["features"]) for a, b in (
        (a_img["train"], b_img["train"]), (a_img["val"], b_img["val"]),
        (a_test, b_test), (a_txt, b_txt)))
    numbers["rn50_int8_vs_bf16_cos"] = cos_q
    print(f"[rn] --quant int8 against bf16 (RN ignores the mode): min cosine "
          f"{cos_q:.7f} (bound 0.99999)")
    _check(cos_q >= 0.99999, cos_q)

    launches, wall, _ = _finetune(root, "smoke", _wrappers(), "experiments_rn",
                                  encoder=["--clip-encoder", "RN50", "--feature_dir",
                                           f"{root}/features_rn_none"])
    _check(not any(launches.values()), ("frozen RN finetune", launches))
    numbers["rn50_finetune_smoke_wall_s"] = wall

    rn101 = ClipEncoder("RN101", allow_random_init=True)
    cos_img, cos_txt = _card_vs_cpu_features(rn101, a_test["paths"], "rn101")
    numbers.update(rn101_card_vs_cpu_cos_img=cos_img, rn101_card_vs_cpu_cos_txt=cos_txt)
    u8 = np.random.default_rng(5).integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    for name, enc in (("RN50", rn50), ("RN101", rn101)):
        staged, n = enc.stage_images(u8)
        enc.encode_staged(staged, n)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(lambda: enc.encode_staged(staged, n), iters=10)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        rows = _profile(f"{name} image encoder", lambda: enc.encode_staged(staged, n))
        busy = _busy_share(rows, ms)
        key = name.lower()
        numbers.update({f"{key}_img_per_s_bs64": batch / (ms / 1e3),
                        f"{key}_device_busy": busy, f"{key}_peak_rise_mib": peak})
        print(f"[rn] {name} image encoder {ms:.3f} ms per batch of {batch} = "
              f"{batch / (ms / 1e3):.1f} img/s, device busy {busy:.3f}, peak "
              f"memory rise {peak:.1f} MiB  [{gpu}]")
    return counts, numbers


def phase_rn_train(root):
    """[rn-train]: finetune --clip-encoder RN50 --hyperparams smoke_full (the
    RN50 tower at full width, random init, bs 8, 30 steps) on the phase-3
    fixture and the [rn] phase's text cache; the tower and every BatchNorm
    layer's running statistics moved; one fp32 bs-4 step card vs CPU; the
    bs-64 train step of RN50 and RN101 -> numbers."""
    import torch

    gpu = _gpu_line()
    encoder = ["--clip-encoder", "RN50", "--feature_dir", f"{root}/features_rn_none"]
    launches, wall, result = _finetune(root, "smoke_full", _wrappers(),
                                       "experiments_rn_train", encoder)
    # the RN tower runs cuDNN convolutions and plain BatchNorm; the text
    # features come from the cache: no port launches
    _check(not any(launches.values()), ("RN50 smoke_full launches", launches))
    _check(set(result["model"]) == {"head_w", "backbone"},
           ("RN50 smoke_full model leaves", sorted(result["model"])))
    _check_tower_moved(result, "RN50 smoke_full", clip="RN50")
    from uml_tpu_torch.models.clip import build_clip

    init = build_clip("RN50").init_random(torch.Generator().manual_seed(0)).state_dict()
    trained = result["model"]["backbone"]
    stats = [k for k in init if k.endswith(("running_mean", "running_var"))]
    for key in stats:
        t = torch.as_tensor(trained[key])
        _check(bool(torch.isfinite(t).all()) and not torch.equal(t, init[key])
               and (key.endswith("running_mean") or bool((t > 0).all())),
               ("RN50 BatchNorm statistic", key))
    print(f"[rn-train] finetune --clip-encoder RN50 --hyperparams smoke_full: "
          f"{wall:.2f} s; all {len(stats)} BatchNorm running statistics moved, "
          f"finite, every variance > 0  [{gpu}]")
    numbers = {"rn50_finetune_smoke_full_wall_s": wall}
    # fp32 on both sides: cuDNN's default rounds an fp32 convolution's
    # operands to TF32, which the 1e-4 bound on the statistics does not
    # allow, so the card's convolutions run in full fp32 for the check;
    # the TF32 step is recorded beside it
    numbers.update(_card_vs_cpu_step("rn50_fp32", clip_name="RN50",
                                     dtype=torch.float32, tf32_witness=True))
    for name in ("RN50", "RN101"):
        numbers.update(_train_step_rates(64, [("default", {}, None)], clip_name=name,
                                         prefix=f"{name.lower()}_train"))
    return numbers


# OpenLLaMA-7B's published widths (openlm-research/open_llama_7b,
# config.json) and Mistral-7B-v0.1's grouped-query widths
OPENLLAMA_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                    num_hidden_layers=32, num_attention_heads=32,
                    num_key_value_heads=32, rms_norm_eps=1e-6)
MISTRAL_7B = dict(vocab_size=32000, hidden_size=4096, intermediate_size=14336,
                  num_hidden_layers=32, num_attention_heads=32,
                  num_key_value_heads=8, rms_norm_eps=1e-5)
LLAMA_CARD_VS_CPU_COS = 0.9999


def _llama_prompts(vocab, n=8, length=32, seed=0):
    """``n`` rows of up to ``length`` token ids, right-padded, and their
    attention mask."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = rng.integers(length // 4, length + 1, n)
    lens[0] = length
    ids = rng.integers(1, vocab, (n, length))
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int64)
    return ids * mask, mask


def _rows_cos(a, b):
    import torch

    a, b = a.double().cpu(), b.double().cpu()
    return float(((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))).min())


def _proj_bytes(state_dict):
    return sum(v.numel() * v.element_size() for k, v in state_dict.items()
               if k.endswith(("proj.weight", "kernel_q8", "proj.scale")))


def _deepseek_cut(ids_np, mask_np):
    """DeepSeek-V2-Lite at its published widths cut to 2 layers (the dense
    first layer and one MoE layer of 64 experts, top-6), seeded random
    weights, through TextModel.native on the card and on the CPU: the
    moe_gemm launches of one call on the card, counted from 0 just before
    it (two a MoE layer), and the pooled features' min cosine to the CPU's
    -> (numbers, {port: launches})."""
    import dataclasses

    import torch

    from uml_tpu_torch.models.deepseek_v2 import DeepseekV2Config, DeepseekV2Encoder
    from uml_tpu_torch.models.languagemodel import TextModel

    cut = dataclasses.replace(DeepseekV2Config(), num_hidden_layers=2)
    with torch.device("meta"):
        shapes = DeepseekV2Encoder(cut).state_dict()
    gen = torch.Generator().manual_seed(2)
    cpu_sd = {name: (1.0 + 0.1 * torch.randn(t.shape, generator=gen)
                     if name.endswith("norm.weight") else
                     torch.randn(t.shape, generator=gen) * t.shape[-1] ** -0.5)
              for name, t in shapes.items()}
    want = TextModel.native(cut, cpu_sd, device="cpu").encode_ids(ids_np, mask_np)
    card = TextModel.native(cut, {k: v.cuda() for k, v in cpu_sd.items()}, device="cuda")
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    card.encode_ids(ids, mask)          # the expert tables are made at the first call
    got, launches = _counted(lambda: card.encode_ids(ids, mask))
    moe_layers = sum(cut.is_moe(i) for i in range(cut.num_hidden_layers))
    _check(launches["moe_gemm"] == 2 * moe_layers,
           ("DeepSeek-V2-Lite: two moe_gemm launches a MoE layer", launches["moe_gemm"]))
    cos = _rows_cos(got, want)
    print(f"[llama] DeepSeek-V2-Lite widths, 2 layers (dense, MoE of {cut.n_routed_experts} "
          f"experts, top-{cut.num_experts_per_tok}), fp32: {launches['moe_gemm']} moe_gemm "
          f"launches a call; card against CPU min cosine {cos:.7f} (bound "
          f"{LLAMA_CARD_VS_CPU_COS})")
    _check(cos >= LLAMA_CARD_VS_CPU_COS, ("DeepSeek-V2-Lite card vs CPU cosine", cos))
    del card, cpu_sd
    torch.cuda.empty_cache()
    return ({"deepseek_v2_lite_2layer_card_vs_cpu_cos": cos},
            {"moe_gemm": launches["moe_gemm"]})


def phase_llama():
    """[llama]: the native LlamaEncoder at OpenLLaMA-7B's published widths,
    full depth, seeded random weights drawn on the card, fp32 (TextModel's
    default) and int8_w on 8 padded prompts of up to 32 token ids: pooled
    features finite, int8_w's cosine to fp32, time per call, peak memory,
    the projections' bytes; card against CPU at 2 layers, at OpenLLaMA-7B's
    and Mistral-7B's widths, and at DeepSeek-V2-Lite's with moe_gemm's
    launches (``_deepseek_cut``) -> (numbers, {port: launches})."""
    import dataclasses

    import torch

    from uml_tpu_torch.models.languagemodel import MODEL_ALIASES, TextModel
    from uml_tpu_torch.models.llama import LlamaConfig, LlamaEncoder

    gpu = _gpu_line()
    _check(MODEL_ALIASES["openllama7b"] == "openlm-research/open_llama_7b",
           "openllama7b alias")
    cfg = LlamaConfig(**OPENLLAMA_7B)
    ids_np, mask_np = _llama_prompts(cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    numbers, pooled = {}, {}
    with torch.device("meta"):
        model = LlamaEncoder(cfg)
    model.to_empty(device="cuda")
    model.init_random(torch.Generator(device="cuda").manual_seed(0))
    state_dict = model.state_dict()
    del model
    for quant in ("none", "int8_w"):
        tm = TextModel.native(cfg, state_dict, quant=quant, device="cuda")
        if quant == "int8_w":
            del state_dict    # the fp32 weights go; int8_w runs alone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        weights = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = tm.encode_ids(ids, mask)
        ms = _time_ms(lambda: tm.encode_ids(ids, mask), iters=5, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        _check(out.shape == (8, cfg.hidden_size) and bool(torch.isfinite(out).all()),
               (quant, "LLaMA pooled features", tuple(out.shape)))
        pooled[quant] = out
        key = "fp32" if quant == "none" else quant
        proj = _proj_bytes(tm.model.state_dict())
        numbers.update({f"llama7b_{key}_ms_per_call": ms,
                        f"llama7b_{key}_peak_gib": peak / 2 ** 30,
                        f"llama7b_{key}_weights_gib": weights / 2 ** 30,
                        f"llama7b_{key}_proj_gib": proj / 2 ** 30})
        print(f"[llama] OpenLLaMA-7B widths, {cfg.num_hidden_layers} layers, {key}: "
              f"{ms:.3f} ms per call "
              f"of 8 prompts x 32 token ids ({8 * 32 / (ms / 1e3):.1f} tokens/s), "
              f"weights {weights / 2 ** 30:.2f} GiB (projections "
              f"{proj / 2 ** 30:.2f} GiB), peak {peak / 2 ** 30:.2f} GiB  [{gpu}]")
        del tm
    ratio = numbers["llama7b_int8_w_proj_gib"] / numbers["llama7b_fp32_proj_gib"]
    cos = _rows_cos(pooled["int8_w"], pooled["none"])
    numbers.update(llama7b_int8_w_proj_bytes_ratio=ratio, llama7b_int8_w_vs_fp32_cos=cos)
    print(f"[llama] int8_w against fp32: pooled min cosine {cos:.6f}, projection "
          f"bytes {ratio:.4f} of fp32's (bound 0.27)")
    _check(ratio <= 0.27, ("int8_w projection bytes", ratio))
    del pooled
    torch.cuda.empty_cache()

    for name, widths in (("openllama7b", OPENLLAMA_7B), ("mistral7b", MISTRAL_7B)):
        cut = dataclasses.replace(LlamaConfig(**widths), num_hidden_layers=2)
        model = LlamaEncoder(cut).init_random(torch.Generator().manual_seed(1))
        cpu_sd = model.state_dict()
        del model
        want = TextModel.native(cut, cpu_sd, device="cpu").encode_ids(ids_np, mask_np)
        card = TextModel.native(cut, {k: v.cuda() for k, v in cpu_sd.items()},
                                device="cuda")
        got = card.encode_ids(ids, mask)
        cos = _rows_cos(got, want)
        numbers[f"llama_{name}_2layer_card_vs_cpu_cos"] = cos
        print(f"[llama] {name} widths ({cut.num_attention_heads} heads over "
              f"{cut.num_key_value_heads} kv heads, eps {cut.rms_norm_eps}), 2 layers, "
              f"fp32: card against CPU min cosine {cos:.7f} (bound "
              f"{LLAMA_CARD_VS_CPU_COS})")
        _check(cos >= LLAMA_CARD_VS_CPU_COS, (name, "card vs CPU cosine", cos))
        del card, cpu_sd
        torch.cuda.empty_cache()
    deepseek_numbers, launches = _deepseek_cut(ids_np, mask_np)
    numbers.update(deepseek_numbers)
    return numbers, launches


def _tree_rel_diff(a, b):
    """The largest difference of two state trees over their tensors, each
    over its largest entry (0 if bit-equal)."""
    import torch

    worst = 0.0
    for key, x in a.items():
        if isinstance(x, dict):
            worst = max(worst, _tree_rel_diff(x, b[key]))
            continue
        x, y = torch.as_tensor(x).double(), torch.as_tensor(b[key]).double()
        if not torch.equal(x, y):
            worst = max(worst, float((x - y).abs().max() / max(y.abs().max(), 1e-30)))
    return worst


def _held_to_spread(what, resumed, spread):
    """A resumed run against an uninterrupted one: bit-equal when two
    uninterrupted runs are, else within their spread."""
    print(f"[resume] {what}: resumed vs uninterrupted max rel diff {resumed:.3e}; "
          f"two uninterrupted runs {spread:.3e} (the bound)")
    _check(resumed <= spread, (what, resumed, spread))


def _finetune_subprocess(root, result_dir, extra=(), kill_at_checkpoint=False):
    """The finetune CLI (frozen ViT-B/16 ``smoke``) in a process of its own
    -> the checkpoint files on disk when it was killed (SIGKILL) as soon as
    the first appeared, else its test_result.pth."""
    import glob

    from uml_tpu_torch.data.feature_cache import load_cache

    argv = _finetune_argv(root, "smoke", result_dir, extra=extra)
    base = f"{root}/{result_dir}"
    log_path = f"{base}.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "uml_tpu_torch.cli.finetune",
                                 "-d", *argv], cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            pattern = f"{base}/**/checkpoints/step_*.pt"
            while proc.poll() is None:
                if kill_at_checkpoint and glob.glob(pattern, recursive=True):
                    break
                _check(time.perf_counter() - t0 < 300, ("finetune subprocess stalled",
                                                         log_path))
                time.sleep(0.01)
        finally:
            proc.kill()
            proc.wait()
    results = glob.glob(f"{base}/**/test_result.pth", recursive=True)
    if kill_at_checkpoint:
        _check(not results, ("the killed run wrote a test_result.pth", log_path))
        return sorted(glob.glob(pattern, recursive=True))
    _check(proc.returncode == 0 and len(results) == 1,
           ("finetune subprocess", proc.returncode, log_path))
    return load_cache(results[0])


def phase_resume(root):
    """[resume]: the finetune CLI on the frozen ViT-B/16 grid: uninterrupted
    in a process of its own and in this one (their spread), then with
    --ckpt_every 20 in a process killed (SIGKILL) once its first checkpoint
    is on disk, rerun here: held to the first; then train() on the RN50
    smoke_full grid stopped at 15 of 30 steps and resumed -> numbers."""
    import glob

    import numpy as np
    import torch

    from uml_tpu_torch.cli import finetune as ft
    from uml_tpu_torch.core.checkpoint import TrainCheckpointer
    from uml_tpu_torch.data.feature_cache import load_cache, text_outdir
    from uml_tpu_torch.data.fewshot import get_few_shot_benchmark
    from uml_tpu_torch.data.loader import RawImageStream
    from uml_tpu_torch.models.encoders import load_clip
    from uml_tpu_torch.models.uml_head import make_uml_clip_head
    from uml_tpu_torch.train.optim import HYPER_DICT, build_optimizer, build_schedule
    from uml_tpu_torch.train.supervised import CyclicBatcher, eval_batches, train

    gpu = _gpu_line()
    numbers = {}
    t0 = time.perf_counter()
    want = _finetune_subprocess(root, "experiments_resume_a")
    _, _, here = _finetune(root, "smoke", {}, "experiments_resume_b")
    spread = _tree_rel_diff(here["model"], want["model"])
    kept = _finetune_subprocess(root, "experiments_resume_c", ["--ckpt_every", "20"],
                                kill_at_checkpoint=True)
    _, _, resumed = _finetune(root, "smoke", {}, "experiments_resume_c",
                              extra=["--ckpt_every", "20"])
    (log_txt,) = glob.glob(f"{root}/experiments_resume_c/**/log.txt", recursive=True)
    with open(log_txt) as f:
        line = [x for x in f if "Resuming from checkpoint" in x]
    _check(line, "the rerun resumed from a checkpoint")
    print(f"[resume] frozen ViT-B/16 smoke, --ckpt_every 20: killed with "
          f"{[os.path.basename(k) for k in kept]} on disk; {line[0].strip()}; "
          f"{time.perf_counter() - t0:.1f} s for the four runs")
    diff = _tree_rel_diff(resumed["model"], want["model"])
    if spread == 0:
        _check(all(resumed[k] == want[k] for k in ("test_acc", "val_acc", "iter")),
               ("resumed CLI result", resumed, want))
    numbers.update(resume_cli_spread=spread, resume_cli_rel_diff=diff)
    _held_to_spread("frozen ViT-B/16 CLI test_result.pth", diff, spread)

    # train() on the RN50 smoke_full grid: BatchNorm's running statistics,
    # the optimizer, the schedule and both streams across the resume
    h = {k: (v[0] if isinstance(v, list) else v) for k, v in HYPER_DICT["smoke_full"].items()}
    ds = get_few_shot_benchmark(root, f"{root}/indices", "caltech101", 16, 1)
    tf = load_cache(text_outdir(f"{root}/features_rn_none", "RN50", "caltech101",
                                "hand_crafted"))
    n_classes = len(ds["lab2cname"])
    img_val, lab_val = ft._decode_split(ds["val"], 1)
    val = eval_batches(img_val, lab_val, h["batch_size"])
    base = load_clip("RN50", allow_random_init=True)
    logit = ft.build_parser().parse_args([]).logit

    def run(ckdir, max_iters):
        model = make_uml_clip_head(copy.deepcopy(base), n_classes, logit_scale=logit,
                                   freeze_backbone=False,
                                   generator=torch.Generator().manual_seed(1)).to("cuda")
        model.zero_shot_init(tf["features"], tf["labels"])
        opt = build_optimizer(h["optim"], build_schedule(
            h["lr"], h["lr_scheduler"], h["warmup_iter"], h["max_iter"],
            h["warmup_type"], h["warmup_min_lr"]), h["weight_decay"])
        # a checkpoint of the whole CLIP and its adamw state is ~1.2 GB:
        # every 15 steps, at the stop and at the end
        train(model, RawImageStream(ds["train"], "crop", h["batch_size"], seed=1),
              CyclicBatcher(tf["features"].astype(np.float32),
                            tf["labels"].astype(np.int64), h["batch_size"], seed=2),
              val, optimizer=opt, max_iters=max_iters, patience=h["patience"],
              checkpointer=TrainCheckpointer(ckdir), ckpt_every=15)
        return TrainCheckpointer(ckdir).restore_latest()

    states = {}
    t0 = time.perf_counter()
    for tag in ("a", "b"):
        step, states[tag] = run(f"{root}/resume_rn_{tag}", h["max_iter"])
        _check(step == h["max_iter"], (tag, step))
    step, _ = run(f"{root}/resume_rn_c", 15)
    _check(step == 15, ("RN50 stopped run", step))
    step, states["c"] = run(f"{root}/resume_rn_c", h["max_iter"])
    _check(step == h["max_iter"], ("RN50 resumed run", step))
    print(f"[resume] RN50 smoke_full through train(): {time.perf_counter() - t0:.1f} s "
          f"for the four runs")

    def split(state):
        model = state["model"]
        stats = {k: v for k, v in model.items() if "running_" in k}
        return {k: v for k, v in model.items() if k not in stats}, stats

    (pa, sa), (pb, sb), (pc, sc) = (split(states[t]) for t in "abc")
    adamw = {t: states[t]["optimizer"]["state"] for t in "abc"}
    for key, what, c, a, b in (
            ("params", "parameters after 30 steps", pc, pa, pb),
            ("bn_stats", "BatchNorm statistics", sc, sa, sb),
            ("adamw", "adamw state", adamw["c"], adamw["a"], adamw["b"])):
        spread, diff = _tree_rel_diff(a, b), _tree_rel_diff(c, a)
        what = f"RN50 smoke_full {what}"
        numbers.update({f"resume_rn50_{key}_spread": spread,
                        f"resume_rn50_{key}_rel_diff": diff})
        _held_to_spread(what, diff, spread)
    print(f"[resume] RN50 smoke_full through train(): stopped at 15, resumed to "
          f"{h['max_iter']}  [{gpu}]")
    return numbers


# MUStARD (sarcasm) at its published widths (uml_tpu's DATASET_CONFIG,
# MultiBench/main.py:66-105): vision 371, audio 81, text 300, T = 50 steps,
# 690 rows split 414 / 138 / 138; MIMIC's static [N, 5] and series [N, 24, 12]
MB_SARCASM_WIDTHS = {"vision": 371, "audio": 81, "text": 300}
MB_SARCASM_ROWS = {"train": 414, "valid": 138, "test": 138}
MB_T = 50
MB_MIMIC_ROWS = 1280
MB_ZDIM = 300            # the sweep's widest (configs/multibench.yaml)
MB_MIMIC_ZDIM = 40
MB_LOSS_RTOL = 1e-4
MB_EMBED_MIN_COS = 0.9999
MB_GRAD_MIN_COS = 0.999
MB_RANK_RTOL = 1e-4
MB_FLAGS = ["--modality", "xy", "--pos_embd", "--pos_learnable", "--num_epochs", "3",
            "--step_k", "0", "--eval_freq", "2", "--n_seeds", "1", "--ckpt_every", "1"]


def _mb_fixture(root):
    """Seeded synthetic sarcasm.pkl and im.pk in the reference schema under
    ``root/data_files``: a shared 8-d latent per row drives every modality
    (so the probes have something to find), text with leading zero steps
    on a quarter of the rows (the trim), labels +-1 from the latent."""
    import pickle

    import numpy as np

    rng = np.random.default_rng(0)
    os.makedirs(f"{root}/data_files", exist_ok=True)

    def split(n):
        latent = rng.standard_normal((n, 8)).astype(np.float32)
        out = {}
        for name, width in MB_SARCASM_WIDTHS.items():
            mix = rng.standard_normal((8, width)).astype(np.float32)
            steps = rng.standard_normal((n, MB_T, width)).astype(np.float32)
            out[name] = (latent @ mix)[:, None, :] + 0.5 * steps
        lead = rng.integers(0, MB_T // 2, n) * (rng.random(n) < 0.25)
        for i in np.nonzero(lead)[0]:
            out["text"][i, : lead[i]] = 0.0
        out["labels"] = np.where(latent[:, :1] > 0, 1.0, -1.0).astype(np.float32)
        out["id"] = [f"row{i}" for i in range(n)]
        return out

    with open(f"{root}/data_files/sarcasm.pkl", "wb") as f:
        pickle.dump({k: split(n) for k, n in MB_SARCASM_ROWS.items()}, f, protocol=4)
    n = MB_MIMIC_ROWS
    latent = rng.standard_normal((n, 4))
    with open(f"{root}/data_files/im.pk", "wb") as f:
        pickle.dump({"ep_tdata": (latent @ rng.standard_normal((4, 12)))[:, None, :]
                     + rng.standard_normal((n, 24, 12)),
                     "adm_features_all": latent @ rng.standard_normal((4, 5))
                     + 0.5 * rng.standard_normal((n, 5)),
                     "adm_labels_all": np.zeros((n, 6)),
                     "y_icd9": (latent[:, :1] + 0.5 * rng.standard_normal((n, 20))
                                > 0).astype(np.int64)}, f, protocol=4)


def _mb_argv(root, results, ds="sarcasm", zdim=None, extra=()):
    return [*MB_FLAGS, "--ds_name", ds, "--zdim", str(zdim or MB_ZDIM),
            "--data_dir", root, "--results_dir", f"{root}/{results}", *extra]


def _mb_run(root, results, ds="sarcasm", zdim=None, extra=()):
    """The multibench CLI in this process -> (wall s, its outs mean, the
    seed-0 results.pth, model.pth tree)."""
    import glob

    from uml_tpu_torch.cli import multibench as mb
    from uml_tpu_torch.data.feature_cache import load_cache

    t0 = time.perf_counter()
    outs = mb.main(mb.build_parser().parse_args(_mb_argv(root, results, ds, zdim, extra)))
    wall = time.perf_counter() - t0
    (seed_dir,) = glob.glob(f"{root}/{results}/**/seed_0", recursive=True)
    return (wall, outs, load_cache(f"{seed_dir}/results.pth"),
            load_cache(f"{seed_dir}/model.pth"))


def _mb_check_model(tree, xdim, ydim, zdim, what):
    """model.pth holds the converter's {'params': ...} tree at the shapes of
    a fresh SeqUML, and every tensor moved from the init (the weights are
    drawn on the CPU from seed 0)."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.convert import seq_uml_state_dict_to_jax
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml

    init = make_seq_uml(xdim, ydim, zdim, pos_embd=True, pos_learnable=True)
    init = seq_uml_state_dict_to_jax(init.init_random(
        torch.Generator().manual_seed(0)).state_dict())

    def flat(t, prefix=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.asarray(v)

    want, got = dict(flat(init)), dict(flat(tree))
    _check({k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()},
           (what, "model.pth tree"))
    still = [k for k, v in got.items() if np.array_equal(v, want[k])]
    _check(not still and all(np.isfinite(v).all() for v in got.values()),
           (what, "parameters that did not move", still))
    return len(got)


def _mb_card_vs_cpu(root, gpu):
    """One forward with both critics, one gradient and one Adam step of the
    full-width sarcasm model (zdim 300, dropout 0, bs 128, T 50) on the card
    and on the CPU from the same weights and batch -> numbers."""
    import numpy as np
    import torch

    from uml_tpu_torch.data.affect import AffectBatchStream, load_affect
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
    from uml_tpu_torch.train.selfsup import SelfSupTrainer

    _check(not torch.backends.cuda.matmul.allow_tf32, "fp32 products without TF32")
    splits = load_affect(f"{root}/data_files/sarcasm.pkl", "sarcasm", vision_norm=True)
    data, lengths, _ = next(iter(AffectBatchStream(splits["train"], 128, seed=42).epoch()))
    batch = (data["vision"], data["text"], lengths["vision"], lengths["text"])
    numbers = {}
    for critic in ("mse", "infonce"):
        runs = {}
        for dev in ("cuda", "cpu"):
            model = make_seq_uml(371, 300, MB_ZDIM, pos_embd=True, pos_learnable=True,
                                 info_nce=critic == "infonce", dropout=0.0)
            trainer = SelfSupTrainer(model, lr=1e-4, seed=0, device=dev)
            trainer.init()
            b = trainer.to_device(*batch)
            trainer.optimizer.zero_grad(set_to_none=False)
            loss, out = trainer.forward_loss(*b, 1.0, 1.0, None)
            loss.backward()
            metrics = trainer.step_metrics(loss, out, *b)
            grads = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
            trainer.optimizer.step()
            with torch.no_grad():
                after = model(*b)
            losses = ("loss_x", "loss_y", "loss_private")
            runs[dev] = {"loss": {k: out[k].detach().item() for k in losses}
                         | {f"{k}_after_adam": after[k].item() for k in losses},
                         "z": {k: out[k].detach().double().cpu() for k in ("zx", "zy")},
                         "rank": float(metrics["train/pred_effective_rank_y"]),
                         "grads": grads}
        card, cpu = runs["cuda"], runs["cpu"]
        loss_rel = {k: abs(card["loss"][k] - v) / abs(v) for k, v in cpu["loss"].items()}
        z_cos = {k: _rows_cos(card["z"][k].reshape(-1, MB_ZDIM),
                              v.reshape(-1, MB_ZDIM)) for k, v in cpu["z"].items()}
        grad_cos = {}
        for k, g in cpu["grads"].items():
            a = card["grads"][k]
            if k.endswith("qkv.bias"):   # the key slice: the softmax cancels its gradient
                a, g = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (a, g))
            grad_cos[k] = float((a * g).sum() / (a.norm() * g.norm() + 1e-30))
        rank_rel = abs(card["rank"] - cpu["rank"]) / cpu["rank"]
        worst_loss = max(loss_rel, key=loss_rel.get)
        worst_grad = min(grad_cos, key=grad_cos.get)
        print(f"[multibench] card vs CPU, {critic}, bs 128 x T {MB_T} at zdim {MB_ZDIM}, fp32, "
              f"dropout 0: losses {card['loss']} vs {cpu['loss']}, max rel "
              f"{loss_rel[worst_loss]:.2e} ({worst_loss}, bound {MB_LOSS_RTOL}); zx / zy "
              f"min row cosine {min(z_cos.values()):.7f} (bound {MB_EMBED_MIN_COS}); "
              f"{len(grad_cos)} gradient tensors, min cosine {grad_cos[worst_grad]:.7f} "
              f"({worst_grad}, bound {MB_GRAD_MIN_COS}); effective rank "
              f"{card['rank']:.4f} vs {cpu['rank']:.4f} (rel {rank_rel:.2e}, bound "
              f"{MB_RANK_RTOL})  [{gpu}]")
        _check(loss_rel[worst_loss] <= MB_LOSS_RTOL, (critic, "losses", loss_rel))
        _check(min(z_cos.values()) >= MB_EMBED_MIN_COS, (critic, "zx / zy", z_cos))
        _check(grad_cos[worst_grad] >= MB_GRAD_MIN_COS, (critic, worst_grad,
                                                         grad_cos[worst_grad]))
        _check(rank_rel <= MB_RANK_RTOL, (critic, "effective rank", rank_rel))
        numbers.update({f"mb_{critic}_card_vs_cpu_loss_rel": loss_rel[worst_loss],
                        f"mb_{critic}_card_vs_cpu_z_min_cos": min(z_cos.values()),
                        f"mb_{critic}_card_vs_cpu_grad_min_cos": grad_cos[worst_grad],
                        f"mb_{critic}_card_vs_cpu_rank_rel": rank_rel})
    return numbers


def _mb_subprocess_killed(root, results):
    """The CLI in a process of its own, killed (SIGKILL) as soon as its first
    checkpoint is on disk -> the checkpoint files then."""
    import glob

    log_path = f"{root}/{results}.log"
    pattern = f"{root}/{results}/**/checkpoints/step_*.pt"
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "uml_tpu_torch.cli.multibench",
                                 "-d", *_mb_argv(root, results)], cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while proc.poll() is None and not glob.glob(pattern, recursive=True):
                _check(time.perf_counter() - t0 < 300, ("multibench subprocess stalled",
                                                         log_path))
                time.sleep(0.01)
        finally:
            proc.kill()
            proc.wait()
    kept = sorted(glob.glob(pattern, recursive=True))
    _check(kept and not glob.glob(f"{root}/{results}/**/results.pth", recursive=True),
           ("the killed multibench run", kept, log_path))
    return kept


def _mb_forward_flops(b, t, xdim, ydim, zdim, info_nce, layers=5, ff=2048):
    """The product FLOPs of one SeqUML forward, both branches: the
    projections in and out, and per layer QKV, the attention's two
    products, the out-projection and the MLP; InfoNCE's logit matrix."""
    n = b * t
    layer = 2 * n * zdim * (3 * zdim + zdim + 2 * ff) + 4 * b * t * t * zdim
    branch = 2 * n * zdim * zdim + layers * layer
    flops = 2 * branch + 2 * n * zdim * 2 * (xdim + ydim)
    if info_nce:
        flops += 2 * (b * (t - 1)) ** 2 * ydim
    return flops


def _mb_step_timing(root, gpu, iters=10):
    """The staged full-width sarcasm train step (bs 128, T 50, zdim 300,
    dropout 0.1 from the card's generator), MSE and InfoNCE: ms per step,
    the phases on the card's stream (forward, backward, Adam, the metrics
    with the effective-rank SVD), the device's busy share and the peak
    memory rise -> numbers."""
    import torch

    from uml_tpu_torch.data.affect import AffectBatchStream, load_affect
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
    from uml_tpu_torch.train.selfsup import SelfSupTrainer

    splits = load_affect(f"{root}/data_files/sarcasm.pkl", "sarcasm", vision_norm=True)
    data, lengths, _ = next(iter(AffectBatchStream(splits["train"], 128, seed=42).epoch()))
    numbers = {}
    for critic in ("mse", "infonce"):
        trainer = SelfSupTrainer(make_seq_uml(371, 300, MB_ZDIM, pos_embd=True,
                                              pos_learnable=True,
                                              info_nce=critic == "infonce"),
                                 lr=1e-4, seed=0, device="cuda")
        trainer.init()
        batch = trainer.to_device(data["vision"], data["text"], lengths["vision"],
                                  lengths["text"])
        gen = torch.Generator(device="cuda").manual_seed(1)

        def step(marks=None):
            def mark(i):
                if marks is not None:
                    marks[i].record()

            mark(0)
            trainer.optimizer.zero_grad(set_to_none=False)
            loss, out = trainer.forward_loss(*batch, 1.0, 1.0, gen)
            mark(1)
            loss.backward()
            mark(2)
            trainer.optimizer.step()
            mark(3)
            metrics = trainer.step_metrics(loss, out, *batch)
            mark(4)
            return torch.stack(list(metrics.values())).tolist()

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        marks = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
                 for _ in range(iters)]
        t0 = time.perf_counter()
        for m in marks:
            step(m)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        phases = [sum(m[i].elapsed_time(m[i + 1]) for m in marks) / iters
                  for i in range(4)]
        rows = _profile(f"multibench train step {critic}", step, top=8)
        busy = _busy_share(rows, ms)
        # the backward's products are twice the forward's
        gflop = _mb_forward_flops(128, MB_T, 371, 300, MB_ZDIM, critic == "infonce") / 1e9
        print(f"[multibench] {critic}: forward products {gflop:.1f} GFLOP, "
              f"{gflop / phases[0]:.2f} TFLOP/s in the forward phase, "
              f"{3 * gflop / (phases[0] + phases[1]):.2f} TFLOP/s over forward and "
              f"backward (the fp32 peak: 67 TFLOP/s)")
        print(f"[multibench] full-width sarcasm train step ({critic}, bs 128 x T 50, "
              f"zdim {MB_ZDIM}, 5 layers, FF 2048, fp32): {ms:.3f} ms (host clock, the "
              f"metrics' one transfer included); phases on the card's stream: forward "
              f"{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, Adam {phases[2]:.3f} "
              f"ms, metrics with the effective-rank SVD {phases[3]:.3f} ms; device busy "
              f"{100 * busy:.1f}%; peak memory rise {peak:.3f} GiB  [{gpu}]")
        numbers.update({f"mb_step_ms_{critic}": ms, f"mb_forward_ms_{critic}": phases[0],
                        f"mb_backward_ms_{critic}": phases[1],
                        f"mb_adam_ms_{critic}": phases[2],
                        f"mb_metrics_svd_ms_{critic}": phases[3],
                        f"mb_device_busy_{critic}": busy,
                        f"mb_forward_gflop_{critic}": gflop,
                        f"mb_peak_rise_gib_{critic}": peak})
        del trainer, batch
        torch.cuda.empty_cache()
    return numbers


def phase_multibench():
    """[multibench]: the MultiBench self-supervised path (no kernel of the
    port) at full width on a seeded MUStARD-schema fixture: the multibench
    CLI on sarcasm (MSE, then InfoNCE), on MIMIC at zdim 40, then
    collect_results_mb; card against CPU; a resume after SIGKILL; the
    staged train step; no port's launch counter may move -> numbers."""
    gpu = _gpu_line()
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "chip_smoke", "mb")
    shutil.rmtree(root, ignore_errors=True)
    _mb_fixture(root)
    numbers, launches = _counted(lambda: _mb_phase(root, gpu))
    _check(not any(launches.values()), ("multibench launches", launches))
    numbers["mb_phase_s"] = time.perf_counter() - t_phase
    print(f"[multibench] {numbers['mb_phase_s']:.1f} s; launches of every port over "
          f"the phase: 0")
    return numbers


def _mb_phase(root, gpu):
    from uml_tpu_torch.cli import collect_results_mb as crm

    numbers = {}
    runs = {"mse": _mb_run(root, "results_a", extra=["--robust_test"]),
            "infonce": _mb_run(root, "results_nce", extra=["--infoNCE_loss"]),
            "mimic": _mb_run(root, "results_mimic", "mimic", MB_MIMIC_ZDIM,
                             extra=["--num_epochs", "2", "--eval_freq", "4"])}
    for tag, (wall, outs, result, model) in runs.items():
        _check(len(outs) == 6 and all(math.isfinite(v) for v in outs.values())
               and all(math.isfinite(float(v)) for v in result.values()),
               (tag, "scores", outs, result))
        dims = (5, 12, MB_MIMIC_ZDIM) if tag == "mimic" else (371, 300, MB_ZDIM)
        n = _mb_check_model(model, *dims, tag)
        numbers[f"mb_cli_{tag}_wall_s"] = wall
        print(f"[multibench] multibench CLI {tag}: {wall:.2f} s; outs {outs}; "
              f"results.pth {len(result)} finite scores; model.pth {n} tensors, every "
              f"one moved  [{gpu}]")
    summary = crm.collect_results(root)
    _check(sorted(summary) == [("mimic", "xy"), ("sarcasm", "xy")],
           ("collect_results_mb groups", sorted(summary)))
    print(f"[multibench] collect_results_mb: groups {sorted(summary)}, "
          f"{summary[('sarcasm', 'xy')]['configs']} sarcasm configs")

    numbers.update(_mb_card_vs_cpu(root, gpu))

    # resume: a second uninterrupted run (the spread), then one killed at its
    # first checkpoint and rerun here
    t0 = time.perf_counter()
    _, _, result_b, model_b = _mb_run(root, "results_b")
    kept = _mb_subprocess_killed(root, "results_c")
    _, _, result_c, model_c = _mb_run(root, "results_c")
    _, _, result_a, model_a = runs["mse"]
    for what, a, b, c in (("results.pth", result_a, result_b, result_c),
                          ("model.pth", model_a, model_b, model_c)):
        spread, diff = _tree_rel_diff(b, a), _tree_rel_diff(c, a)
        numbers.update({f"mb_resume_{what[:-4]}_spread": spread,
                        f"mb_resume_{what[:-4]}_rel_diff": diff})
        print(f"[multibench] resume after SIGKILL with "
              f"{[os.path.basename(k) for k in kept]} on disk: {what} resumed vs "
              f"uninterrupted max rel diff {diff:.3e}; two uninterrupted runs "
              f"{spread:.3e} (the bound)")
        _check(diff <= spread, ("multibench resume", what, diff, spread))
    print(f"[multibench] resume: {time.perf_counter() - t0:.1f} s for the three runs")

    numbers.update(_mb_step_timing(root, gpu))
    return numbers


def _dino_features_args(root, batch, feature_dir, quant):
    from uml_tpu_torch.cli import features as feat

    args = feat.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", feature_dir, "--dataset", "caltech101",
        "--vision_model", DINO, "--language_model", DINO_LM,
        "--allow-random-init", "--train-shot", "16", "--seed", "1",
        "--text-augmentation", "hand_crafted", "--batch-size", str(batch),
        "--quant", quant])
    args.overwrite = False
    args.force_rerun = False
    return args


def _dino_card_vs_cpu(model, u8, tag):
    """A DinoViT on the card against a copy of it on the CPU (plain path) on
    the same uint8 batch -> the smallest per-row cosine of the features."""
    import torch

    cpu_model = copy.deepcopy(model).to("cpu")
    with torch.no_grad():
        got = model.encode_image_u8(u8.to(next(model.parameters()).device))
        want = cpu_model.encode_image_u8(u8)
    cos = _rows_cos_min(got, want)
    print(f"[dino] {tag}: card vs CPU plain path, batch {u8.shape[0]}: min "
          f"cosine {cos:.6f} (bound {MIN_COSINE})")
    _check(cos >= MIN_COSINE, (tag, "card vs CPU cosine", cos))
    return cos


def phase_dino(root, sizes):
    """The DINO slice's main path: features --vision_model DINOv2-B/14 in
    bf16 and --quant int8 on the phase-3 fixture, then the ViT-L/14 and
    ViT-B/8 batches -> ({DINO_PORTS name: launches}, numbers)."""
    import numpy as np
    import torch

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.data.feature_cache import img_outdir, load_cache, text_outdir
    from uml_tpu_torch.data.loader import ImageBatchLoader
    from uml_tpu_torch.models.dino import load_dino

    batch, n_classes, width = 64, 8, 768
    n_batches = sum(-(-n // batch) for n in (sizes["train"], sizes["val"],
                                           sizes["test"]))
    rng = np.random.default_rng(4)
    staged_u8 = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    numbers, counts = {}, {}
    for quant in ("none", "int8"):
        fdir = f"{root}/features_dino_{quant}"
        args = _dino_features_args(root, batch, fdir, quant)
        t0 = time.perf_counter()
        encoder, launches = _counted(lambda: feat.main(args))
        wall = time.perf_counter() - t0
        # per image batch: 11 full layers and the CLS layer, every attention
        # half on the chain (S = 257): the engine's QKV, then flash_attention
        # (12 a batch, none of the fused kernel); the text side launches
        # nothing (hash-random features)
        want = dict.fromkeys(launches, 0)
        want["flash_attention"] = 12 * n_batches
        want["attn_block_cls"] = n_batches
        if quant == "none":
            want.update({"attn_block": 11 * n_batches, "mlp_block": 12 * n_batches})
        else:
            want.update({"attn_block_q8": 11 * n_batches,
                         "mlp_block_q8": 11 * n_batches, "mlp_block": n_batches})
        print(f"[dino] features --vision_model {DINO} --quant {quant} CLI "
              f"{wall:.2f} s; launches { {k: v for k, v in launches.items() if v} }")
        _check(launches == want, (quant, launches, want))
        _check(all(p.device.type == "cuda" for p in encoder.model.parameters()),
               "DINO encoder parameters on the card")
        img = load_cache(img_outdir(fdir, DINO, "caltech101", "crop", 16, 1, "train"))
        test = load_cache(img_outdir(fdir, DINO, "caltech101", "crop", 16, 1, "test"))
        txt = load_cache(text_outdir(fdir, DINO_LM, "caltech101", "hand_crafted"))
        for name, split, n in (("train", img["train"], sizes["train"]),
                               ("val", img["val"], sizes["val"]),
                               ("test", test, sizes["test"])):
            f = split["features"]
            _check(f.shape == (n, width) and np.isfinite(f).all(), (name, f.shape))
        _check(txt["features"].shape == (n_classes, 768)
               and np.isfinite(txt["features"]).all(), ("text", txt["features"].shape))
        counts[quant] = launches
        imgs, _, _ = next(iter(ImageBatchLoader(
            [{"impath": p, "label": 0} for p in test["paths"][:4]], batch_size=4,
            num_workers=1)))
        test_u8 = torch.from_numpy(imgs.reshape(4, -1))
        numbers[f"dino_card_vs_cpu_cos_{quant}"] = _dino_card_vs_cpu(
            encoder.model, test_u8, f"DINOv2-B/14 --quant {quant}")
        staged, n = encoder.stage_images(staged_u8)
        ms = _time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
        numbers[f"dino_encoder_img_per_s_bs64_{quant}"] = batch / (ms / 1e3)
        print(f"[dino] DINOv2-B/14 image encoder --quant {quant}: {ms:.3f} ms per "
              f"batch of {batch} = {batch / (ms / 1e3):.1f} img/s")
        _profile(f"DINOv2-B/14 image encoder --quant {quant}",
                 lambda: encoder.encode_staged(staged, n))
        del encoder, staged
    # the other widths and lengths: DINOv2-L/14 (24 layers, K 1024) and
    # DINO ViT-B/8 (S 785), random weights from the seeded generator
    for name in ("vit_large_patch14_dinov2.lvd142m", "vit_base_patch8_224_dino"):
        model = load_dino(name, allow_random_init=True).to("cuda").eval()
        u8 = torch.from_numpy(rng.integers(0, 256, (4, 224 * 224 * 3), dtype=np.uint8))
        numbers[f"dino_card_vs_cpu_cos_{name}"] = _dino_card_vs_cpu(model, u8, name)
        del model
    # each entry's launches from the run of its mode: the bf16 halves from
    # the bf16 run, the int8 ones from the int8 run, row 13 from both
    entries = {}
    for name, wrapper, _, _ in DINO_PORTS:
        if wrapper == "flash_attention":
            entries[name] = sum(c[wrapper] for c in counts.values())
        else:
            entries[name] = counts["int8" if "q8" in wrapper else "none"][wrapper]
    return entries, numbers


def phase_dino_train(root, sizes):
    """The DINO training slice's main path: finetune --vision_model
    DINOv2-B/14 --hyperparams smoke_full on the phase-3 fixture and the
    [dino] phase's text cache, with the stashes (rows 5, 6, 8, 9) and with
    both off under UML_MLP_BWD=kernel (rows 7, 19) and =dw (rows 7, 20);
    the launch counters of each run, the tower moved, a profile of one
    step per mode showing the exact-GELU instances; a bs-4 step card vs
    CPU in every backward mode; the step at bs 64 (stashes on, and the
    recompute under UML_MLP_BWD=kernel) and bs 256 (the default gate: no
    MLP stash) -> ({DINO_TRAIN_PORTS name: launches}, numbers)."""
    from uml_tpu_torch.ops import attention as at
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm

    wrappers = {"attn_block": fa.attn_block, "attn_block_cls": fa.attn_block_cls,
                "mlp_block": lm.mlp_block, "attn_block_stash": fa.attn_block_stash,
                "attn_block_bwd": fa.attn_block_bwd,
                "attn_block_cls_bwd": fa.attn_block_cls_bwd,
                "mlp_block_stash": lm.mlp_block_stash,
                "attn_block_bwd_recompute": fa.attn_block_bwd_recompute,
                "mlp_bwd": lm.mlp_bwd, "mlp_bwd_dw": lm.mlp_bwd_dw,
                "mlp_bwd_via_stash": lm.mlp_bwd_via_stash,
                "qkv_attention": fa.qkv_attention,
                "flash_attention": at.flash_attention}
    none = dict.fromkeys(wrappers, 0)
    encoder = ["--vision_model", DINO, "--language_model", DINO_LM,
               "--feature_dir", f"{root}/features_dino_none"]
    # 30 steps at bs 8; the evals (val at iter 0 and for the best model,
    # test at the end) in batches of 8 through the inference halves; every
    # attention half at S = 257 runs the chain (no fused kernel): one
    # flash_attention launch each, the recompute backward's included
    steps = 30
    n_eval = 2 * -(-sizes["val"] // 8) + -(-sizes["test"] // 8)
    evals = {"attn_block": 11 * n_eval, "attn_block_cls": steps + n_eval,
             "mlp_block": 12 * n_eval, "attn_block_cls_bwd": steps,
             "flash_attention": 12 * (n_eval + steps)}
    plans = {
        "default": ({}, {"attn_block_stash": 11 * steps, "attn_block_bwd": 11 * steps,
                         "mlp_block_stash": 12 * steps,
                         "mlp_bwd_via_stash": 12 * steps}),
        **{mode: (RECOMPUTE_MODES[mode], {
            "attn_block": 11 * (n_eval + steps), "mlp_block": 12 * (n_eval + steps),
            "attn_block_bwd_recompute": 11 * steps,
            "flash_attention": 12 * (n_eval + steps) + 11 * steps,
            ("mlp_bwd" if mode == "kernel" else "mlp_bwd_dw"): 12 * steps})
           for mode in ("kernel", "dw")}}
    numbers, launches = {}, {}
    for mode, (env, plan) in plans.items():
        with _env(env):
            got, wall, result = _finetune(root, "smoke_full", wrappers,
                                          f"experiments_dino_{mode}", encoder)
            want = {**none, **evals, **plan}
            _check(got == want, (f"DINO smoke_full {mode} launches", got, want))
            _check_tower_moved(result, f"DINO smoke_full ({mode})", dino=DINO)
            _check(set(result["model"]) == {"head_w", "img_proj_w", "backbone"},
                   ("DINO smoke_full model leaves", sorted(result["model"])))
        launches[mode] = got
        numbers[f"dino_finetune_smoke_full_{mode}_wall_s"] = wall
        print(f"[dino-train] finetune --vision_model {DINO} --hyperparams smoke_full "
              f"({mode}): {wall:.2f} s; launches { {k: v for k, v in got.items() if v} }")
    # one bs-4 step per mode: the MLP halves ran the exact-GELU instances of
    # the engine, and no quick_gelu one
    model, batch = _head_and_batch(4, dino=DINO)
    model.to("cuda")
    batch = tuple(t.to("cuda") for t in batch)
    for mode, (want_kernel, not_kernel) in DINO_TRAIN_ENGINE.items():
        env = {} if mode == "default" else RECOMPUTE_MODES[mode]
        with _env(env):
            names = _kernel_names(_profile(
                f"DINOv2-B/14 bs-4 train step ({mode})",
                lambda: _loss(model, batch).backward(), top=6))
        _check(any(want_kernel in n for n in names)
               and not any(not_kernel in n for n in names),
               (f"DINO train step ({mode}): {want_kernel}, no {not_kernel}", names))
    del model, batch
    numbers.update(_card_vs_cpu_step("dino_default", dino=DINO))
    with _env({**RECOMPUTE, "UML_MLP_BWD": "unset"}):
        numbers.update(_card_vs_cpu_step("dino_recompute_unset", dino=DINO))
    for mode, env in RECOMPUTE_MODES.items():
        with _env(env):
            numbers.update(_card_vs_cpu_step(f"dino_recompute_{mode}", dino=DINO))
    numbers.update(_train_step_rates(64, [
        ("stash", {}, None), ("recompute_kernel", RECOMPUTE_MODES["kernel"], None)],
        dino=DINO, prefix="dino_train"))
    numbers.update(_train_step_rates(256, [("gate_default", {"UML_MLP_BWD": "unset"},
                                            None)], dino=DINO, prefix="dino_train"))
    entries = {name: launches[mode][wrapper]
               for name, wrapper, mode, _, _ in DINO_TRAIN_PORTS}
    return entries, numbers


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


def _finetune_argv(root, grid, result_dir, encoder=None, extra=()):
    """The finetune CLI's flags on the phase-3 fixture into
    ``root/result_dir``; ``encoder``: the encoder and text-cache flags
    (default: the ViT-B/16 CLIP and phase 3's caches)."""
    encoder = encoder or ["--clip-encoder", "ViT-B/16", "--feature_dir",
                          f"{root}/features"]
    return ["--data_dir", root, "--indices_dir", f"{root}/indices", *encoder,
            "--result_dir", f"{root}/{result_dir}", "--dataset", "caltech101",
            "--allow-random-init",
            "--train-shot", "16", "--seed", "1", "--text_type", "hand_crafted",
            "--modality", "crossmodal", "--alpha", "1", "--hyperparams", grid,
            *extra]


def _finetune(root, grid, wrappers, result_dir="experiments", encoder=None,
              extra=()):
    """One finetune CLI run into ``root/result_dir`` (``_finetune_argv``,
    ``extra`` flags appended) -> (launch counts, wall seconds, the combo's
    test_result)."""
    import torch

    from uml_tpu_torch.cli import finetune as ft
    from uml_tpu_torch.data.feature_cache import load_cache

    args = ft.build_parser().parse_args(
        _finetune_argv(root, grid, result_dir, encoder, extra))
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


def _check_tower_moved(result, what, dino=None, clip="ViT-B/16"):
    """The saved best model is the iter-0 snapshot: one adamw step from the
    encoder's random init (generator seed 0); every image-tower tensor
    must differ from the init (``dino``: the DinoViT of that name, every
    tensor; ``clip``: the CLIP's name, an RN's BatchNorm statistics
    included).  An RN attention pool's k_proj bias is left out: the
    softmax cancels its gradient, so only rounding noise moves it."""
    import torch

    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.models.dino import load_dino

    init = (build_clip(clip).init_random(torch.Generator().manual_seed(0))
            if dino is None else load_dino(dino, allow_random_init=True)).state_dict()
    trained = result["model"]["backbone"]
    _check(set(trained) == set(init), (what, "backbone keys"))
    visual = list(init) if dino else [k for k in init if k.startswith("visual.")
                                      and not k.endswith("attnpool.k_proj.bias")]
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
                "mlp_bwd_via_stash": lm.mlp_bwd_via_stash,
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
                        "attn_block_bwd": 11 * steps, "mlp_block_stash": 12 * steps,
                        "mlp_bwd_via_stash": 12 * steps})
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


def _head_and_batch(bsz, gen_seed=0, clip_kw=None, config=None, dino=None,
                    clip_name="ViT-B/16", dtype=None):
    """A random-init ViT-B/16 UML head (bf16 compute, every CLIP leaf
    trainable; ``clip_kw``: build_clip's attn_impl / ln_matmul_impl;
    ``config``: a ClipConfig in place of ViT-B/16's; ``clip_name``:
    another CLIP (RN50 / RN101: BatchNorm in train form); ``dtype``: the
    compute dtype in place of bf16; ``dino``: the named DinoViT's UML head
    instead, img_proj into a 768-wide text space, as the DINO finetune
    builds it) and one crossmodal batch of ``bsz`` on the CPU."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.clip import CLIP, build_clip
    from uml_tpu_torch.models.dino import load_dino
    from uml_tpu_torch.models.uml_head import make_uml_clip_head, make_uml_dino_head

    head_gen = torch.Generator().manual_seed(1)
    if dino is not None:
        backbone = load_dino(dino, allow_random_init=True)   # generator seed 0
        res, width = backbone.config.image_size, 768
        model = make_uml_dino_head(backbone, 8, text_indim=width,
                                   freeze_backbone=False, generator=head_gen)
    else:
        dtype = dtype or torch.bfloat16
        clip = (build_clip(clip_name, dtype=dtype, **(clip_kw or {}))
                if config is None else
                CLIP(config, dtype=dtype, **(clip_kw or {}))).init_random(
            torch.Generator().manual_seed(gen_seed))
        res, width = clip.config.image_resolution, clip.config.embed_dim
        model = make_uml_clip_head(clip, 8, freeze_backbone=False,
                                   generator=head_gen)
    rng = np.random.default_rng(gen_seed)
    batch = (torch.from_numpy(rng.integers(0, 256, (bsz, res * res * 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 8, bsz)),
             torch.ones(bsz),
             torch.from_numpy(rng.standard_normal((bsz, width)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 8, bsz)),
             torch.ones(bsz))
    return model, batch


def _loss(model, batch, bn_updates=None):
    """The crossmodal UML loss of train/supervised.py (alpha 1), through
    the training forward (``bn_updates``, for an RN tower: a list that
    BatchNorm's train form fills with the new running statistics)."""
    from uml_tpu_torch.train.supervised import weighted_ce

    img, lab, w, txt, tlab, tw = batch
    s_img, s_txt = model.scales()
    feats = model.image_features(img, bn_updates)
    return (weighted_ce(feats @ model.head_w * s_img, lab, w)
            + weighted_ce(txt @ model.head_w * s_txt, tlab, tw))


def _card_vs_cpu_step(mode, clip_kw=None, config=None, dino=None,
                      clip_name="ViT-B/16", dtype=None, tf32_witness=False):
    """One bs-4 forward + backward on the card and on the CPU plain path,
    same weights and batch, in the backward mode the environment sets; for
    an RN tower (``clip_name``) also BatchNorm's running statistics after
    the merge.  ``tf32_witness``: the card's step runs a second time with
    cuDNN's TF32 convolutions on, its statistics recorded, not held."""
    import torch

    cpu_model, cpu_batch = _head_and_batch(4, clip_kw=clip_kw, config=config,
                                           dino=dino, clip_name=clip_name,
                                           dtype=dtype)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    gpu_batch = tuple(t.to("cuda") for t in cpu_batch)
    runs = [(gpu_model, gpu_batch), (cpu_model, cpu_batch)]
    if tf32_witness:
        runs.append((copy.deepcopy(cpu_model).to("cuda"), gpu_batch))
    losses, grads, stats = [], [], []
    tf32 = torch.backends.cudnn.allow_tf32
    for i, (model, batch) in enumerate(runs):
        if tf32_witness:
            # the checked card step in full fp32, the witness (third) in TF32
            torch.backends.cudnn.allow_tf32 = i == 2
        upd = [] if clip_name.startswith("RN") else None
        try:
            loss = _loss(model, batch, upd)
            loss.backward()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        if upd is not None:
            model.merge_bn_updates(upd)
        losses.append(loss.item())
        grads.append({k: p.grad.detach().float().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None})
        stats.append({k: b.detach().float().cpu() for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))})
    _check(grads[0].keys() == grads[1].keys(), "same parameters reached")
    cosines = {}
    for key, g in grads[1].items():
        a, b = grads[0][key], g
        if key.endswith("attnpool.k_proj.bias"):
            continue   # an exact zero gradient (the softmax cancels it)
        if key.endswith(("attn.in_proj_bias", ".qkv.bias")):
            a, b = (torch.cat([t.chunk(3)[0], t.chunk(3)[2]]) for t in (a, b))
        cosines[key] = float((a * b).sum() / (a.norm() * b.norm() + 1e-30))
    worst = min(cosines, key=cosines.get)
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    tag = "dino-train" if dino else "rn-train" if clip_name.startswith("RN") else "train"
    suffix = "" if mode == "default" else f"_{mode}"
    numbers = {}
    if stats[1]:
        # the new running statistics (0.9 old + 0.1 batch) on the card
        # against the CPU, each tensor's largest difference over its
        # largest entry
        def stat_diffs(card):
            return {k: float((card[k] - v).abs().max() / v.abs().max())
                    for k, v in stats[1].items()}

        stat_rel = stat_diffs(stats[0])
        worst_stat = max(stat_rel, key=stat_rel.get)
        if tf32_witness:
            witness = max(stat_diffs(stats[2]).values())
            numbers[f"step_bn_stat_rel_err_tf32{suffix}"] = witness
            print(f"[{tag}] the same step with cuDNN's TF32 convolutions: "
                  f"BatchNorm statistics max rel diff {witness:.3e} (recorded)")
        print(f"[{tag}] bs-4 step card vs CPU ({mode}): {len(stat_rel)} BatchNorm "
              f"statistics after the merge, max rel diff "
              f"{stat_rel[worst_stat]:.3e} ({worst_stat}), bound {BN_STAT_RTOL}")
        _check(stat_rel[worst_stat] <= BN_STAT_RTOL,
               (mode, "BatchNorm statistics", worst_stat, stat_rel[worst_stat]))
        numbers[f"step_bn_stat_rel_err{suffix}"] = stat_rel[worst_stat]
    print(f"[{tag}] bs-4 step card vs CPU ({mode}): loss {losses[0]:.6f} vs "
          f"{losses[1]:.6f} (rel {rel:.2e}, bound {STEP_LOSS_RTOL}); "
          f"{len(cosines)} gradient tensors, min cosine "
          f"{cosines[worst]:.6f} ({worst}), bound {STEP_MIN_GRAD_COSINE}")
    _check(rel <= STEP_LOSS_RTOL, (mode, "bs-4 loss", losses))
    _check(cosines[worst] >= STEP_MIN_GRAD_COSINE, (mode, "gradient cosine",
                                                     worst, cosines[worst]))
    return {**numbers, f"step_loss_rel_err{suffix}": rel,
            f"step_min_grad_cosine{suffix}": cosines[worst]}


def _train_step_rates(bsz, modes, iters=10, clip_kw=None, dino=None,
                      prefix="train", clip_name="ViT-B/16"):
    """Steady-state full-model train step (forward, backward, adamw) at
    ``bsz`` on a staged batch, in each mode of ``modes`` ((tag, environment,
    microbatch or None), run in turn on one model), with its peak memory,
    its phases and a profile; ``dino``: the named DinoViT's head,
    ``clip_name``: another CLIP (an RN tower's step ends with the merge of
    its BatchNorm statistics, in the adamw phase), numbers under
    ``prefix``."""
    import torch

    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.train.accum import microbatched_step
    from uml_tpu_torch.train.optim import build_optimizer, build_schedule

    model, batch = _head_and_batch(bsz, clip_kw=clip_kw, dino=dino,
                                   clip_name=clip_name)
    tag_line = ("dino-train" if dino else "rn-train" if clip_name.startswith("RN")
                else "train")
    what = f"{dino} " if dino else f"{clip_name} " if clip_name != "ViT-B/16" else ""
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
            upd = [] if clip_name.startswith("RN") else None
            if micro is None:
                loss = _loss(model, batch, upd)
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
            if upd is not None:
                model.merge_bn_updates(upd)
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
            print(f"[{tag_line}] {what}full-model train step bs {bsz} {tag} ({env_s}"
                  f"{how}): {ms:.3f} ms = {rate:.1f} img/s (forward, backward, "
                  f"adamw; peak memory {peak:.2f} GiB)")
            print(f"[{tag_line}] phases on the card's stream (CUDA events): forward "
                  f"{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, adamw "
                  f"{phases[2]:.3f} ms; launches over the {iters} steps: mlp_bwd "
                  f"{mlp_launches[0]}, mlp_bwd_dw {mlp_launches[1]}")
            if tag == "gate_default":
                # F1: above the gate the default MLP backward is row 19
                _check(mlp_launches[0] > 0 and mlp_launches[1] == 0,
                       ("bs-256 default gate: mlp_bwd", mlp_launches))
            first = tag == "stash"
            rows = _profile(f"{what}train step bs {bsz} {tag}", step,
                            top=16 if first else 10, by_op=first)
            _gemm_classes(f"{what}train step bs {bsz} {tag}", rows)
        # the bs-64 stash step keeps the keys of the earlier runs
        key = f"bs{bsz}" if first else f"bs{bsz}_{tag}"
        numbers.update({f"{prefix}_step_ms_{key}": ms, f"{prefix}_img_per_s_{key}": rate,
                        f"{prefix}_peak_gib_{key}": peak,
                        f"{prefix}_forward_ms_{key}": phases[0],
                        f"{prefix}_backward_ms_{key}": phases[1],
                        f"{prefix}_adamw_ms_{key}": phases[2],
                        f"{prefix}_device_busy_{key}": _busy_share(rows, ms)})
    return numbers


GAUSSIAN_CONFIG = os.path.join("configs", "gaussian.yaml")
GAUSSIAN_KEYS = ["mode", "seed", "val_loss_x", "val_loss_y", "val_cka", "val_mknn",
                 "num_steps"]     # uml_tpu/cli/gaussian.py's results.json
GAUSSIAN_CPU_STEPS = 200
GAUSSIAN_RTOL = 1e-4
GAUSSIAN_MKNN_ATOL = 1e-3


def _gaussian_paper_args(outdir):
    """The gaussian CLI's args for configs/gaussian.yaml's combo with seed 0
    and mode xy (the paper's setting), unchanged."""
    from uml_tpu_torch.cli import gaussian as gcli
    from uml_tpu_torch.core.sweep import apply_combo, load_sweep

    combo = next(c for c in load_sweep(os.path.join(ROOT, GAUSSIAN_CONFIG))
                 if c["seed"] == 0 and c["mode"] == "xy")
    args = apply_combo(gcli.build_parser(), combo)
    args.outdir, args.overwrite, args.force_rerun = outdir, False, False
    return args


def _gaussian_history(args, device):
    """train_gaussian from the init of a generator seeded 0 over the
    paper's pools, GAUSSIAN_CPU_STEPS steps on ``device`` -> its history.
    (The CPU half runs after the card's timings: a process of its own
    beside them took the host the card's loop is bound by.)"""
    import torch

    from uml_tpu_torch.data.gaussian import UnpairedIndexStream, generate_data
    from uml_tpu_torch.train.gaussian import make_model, train_gaussian

    def dgp(seed, n, attenuate):
        return generate_data({
            "seed": seed, "num_samples": n, "dim_c": args.data_dim_common,
            "dim_x": args.data_dim_x, "dim_y": args.data_dim_y,
            "dim_obs": args.dim_obs, "noise_std": args.noise_std,
            "attenuate_x": attenuate, "attenuation": args.attenuation,
            "shared_latent_distribution_type": "gaussian"})

    n = args.train_num_samples
    data, val = dgp(42, n, True), dgp(43, args.val_num_samples, False)
    pools = {"x": data["x"][: n // 2], "y": data["y"][n - n // 2:]}
    init = make_model(args.dim_obs, args.dim_common, args.dim_latent).init_random(
        torch.Generator().manual_seed(0)).state_dict()
    return train_gaussian(
        make_model(args.dim_obs, args.dim_common, args.dim_latent), pools,
        val["x"], val["y"], lr=args.lr, batch_size=args.batch_size,
        num_steps=GAUSSIAN_CPU_STEPS, init_params=init, device=device,
        stream=UnpairedIndexStream(len(pools["x"]), len(pools["y"]),
                                   args.batch_size, seed=42)).history


def phase_gaussian():
    """[gaussian]: the gaussian CLI on the card at the paper's setting
    (configs/gaussian.yaml, seed 0, mode xy: 10,000 steps of batch 512 over
    10,000 train and 2,000 validation rows), its results.json keys, no
    port's launch counter moving; card against CPU over 200 steps from one
    init and one index stream; the steps/s, the device's busy share and
    the peak memory -> numbers."""
    import torch

    from uml_tpu_torch.cli import gaussian as gcli
    from uml_tpu_torch.data.gaussian import UnpairedIndexStream, generate_data
    from uml_tpu_torch.train.gaussian import make_model, train_gaussian

    import numpy as np

    gpu = _gpu_line()
    root = os.path.join(ROOT, "build", "chip_smoke", "gaussian")
    shutil.rmtree(root, ignore_errors=True)
    args = _gaussian_paper_args(root)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, launches = _counted(lambda: gcli.main(args))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    _check(not any(launches.values()), ("gaussian launches", launches))
    run_dir = os.path.join(root, f"mode_xy-seed_0-tag_{args.tag}")
    with open(os.path.join(run_dir, "results.json")) as f:
        saved = json.load(f)
    _check(list(saved) == GAUSSIAN_KEYS and saved["num_steps"] == 10_000
           and all(math.isfinite(saved[k]) for k in GAUSSIAN_KEYS[2:6]), saved)
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = sum(1 for _ in f)
    _check(rows == 10_000 + 1, ("metrics.jsonl rows", rows))
    print(f"[gaussian] {gpu}: gaussian CLI (configs/gaussian.yaml, seed 0, xy: "
          f"dim_obs {args.dim_obs}, dim_common {args.dim_common}, dim_latent "
          f"{args.dim_latent}, 10,000 steps of {args.batch_size}) {wall:.2f} s; "
          f"results {saved}; peak memory {peak / 2**20:.1f} MiB; launches 0")

    # the loop alone: one chunk of 100 steps, timed and profiled
    n = args.train_num_samples
    data = generate_data({
        "seed": 42, "num_samples": n, "dim_c": args.data_dim_common,
        "dim_x": args.data_dim_x, "dim_y": args.data_dim_y, "dim_obs": args.dim_obs,
        "noise_std": args.noise_std, "attenuate_x": True,
        "attenuation": args.attenuation, "shared_latent_distribution_type": "gaussian"})
    val = data["x"][: args.val_num_samples], data["y"][: args.val_num_samples]
    pools = {"x": data["x"][: n // 2], "y": data["y"][n - n // 2:]}

    def chunk():
        train_gaussian(make_model(args.dim_obs, args.dim_common, args.dim_latent),
                       pools, *val, batch_size=args.batch_size, num_steps=100,
                       chunk=100, stream=UnpairedIndexStream(
                           len(pools["x"]), len(pools["y"]), args.batch_size, seed=42))

    chunk()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 100
    busy = _busy_share(_profile("gaussian train_gaussian, 100 steps", chunk), 100 * step_ms)
    t0 = time.perf_counter()
    card = _gaussian_history(args, "cuda")
    t1 = time.perf_counter()
    cpu = _gaussian_history(args, "cpu")
    t2 = time.perf_counter()
    print(f"[gaussian] {GAUSSIAN_CPU_STEPS} steps from one init: card {t1 - t0:.2f} s, "
          f"CPU {t2 - t1:.2f} s ({torch.get_num_threads()} threads)")
    rel = max(float(np.max(np.abs(card[k] - cpu[k]) / np.abs(cpu[k])))
              for k in cpu if k != "val/mknn")
    mknn = float(np.max(np.abs(card["val/mknn"] - cpu["val/mknn"])))
    _check(rel <= GAUSSIAN_RTOL and mknn <= GAUSSIAN_MKNN_ATOL, ("card vs CPU", rel, mknn))
    print(f"[gaussian] {gpu}: {step_ms:.4f} ms a step ({1e3 / step_ms:.1f} steps/s, "
          f"a step with its eval: val losses, CKA and mutual kNN over "
          f"{args.val_num_samples} rows), device busy {100 * busy:.1f}%; the CLI "
          f"{10_000 / wall:.1f} steps/s end to end; card vs CPU over "
          f"{GAUSSIAN_CPU_STEPS} steps: losses and CKA max rel err {rel:.3e} "
          f"(<= {GAUSSIAN_RTOL}), mutual kNN max abs err {mknn:.3e} "
          f"(<= {GAUSSIAN_MKNN_ATOL})")
    return {"gaussian_cli_s": wall, "gaussian_step_ms": step_ms,
            "gaussian_cpu_half_s": t2 - t1,
            "gaussian_steps_per_s": 1e3 / step_ms, "gaussian_device_busy": busy,
            "gaussian_peak_mib": peak / 2**20, "gaussian_card_vs_cpu_rel": rel,
            "gaussian_card_vs_cpu_mknn": mknn}


# the full-model step's backward modes -> the rows their launches count
PARALLEL_MODES = {
    "default": ({}, ("attn_block_stash", "attn_block_bwd", "attn_block_cls_bwd",
                     "mlp_block_stash")),
    "recompute_kernel": (RECOMPUTE_MODES["kernel"],
                         ("attn_block_bwd_recompute", "mlp_bwd")),
    "recompute_dw": (RECOMPUTE_MODES["dw"], ("attn_block_bwd_recompute", "mlp_bwd_dw")),
}


def _same_step(plain, dp, what):
    """Two models after one step each: the parameters and their gradients
    bit-equal -> the number of tensors compared."""
    import torch

    n = 0
    for (name, a), b in zip(plain.named_parameters(), dp.parameters(), strict=True):
        _check(torch.equal(a, b), (what, "parameter", name))
        _check((a.grad is None) == (b.grad is None)
               and (a.grad is None or torch.equal(a.grad, b.grad)), (what, "grad", name))
        n += 1
    return n


def _kernel_diff(what, plain_rows, mesh_rows, reps=3, top=6, tag="parallel"):
    """The device kernels whose time per call grows most from the
    ``plain_rows`` profile to the ``mesh_rows`` one (``_profile`` rows)."""
    plain = {}
    for key, t, _ in plain_rows:
        plain[key] = plain.get(key, 0.0) + t
    mesh = {}
    for key, t, _ in mesh_rows:
        mesh[key] = mesh.get(key, 0.0) + t
    diff = sorted(((mesh.get(k, 0.0) - plain.get(k, 0.0)) / reps / 1e3, k)
                  for k in set(plain) | set(mesh))
    print(f"[{tag}] {what}: device time per call, the mesh's minus the plain "
          f"step's, {sum(d for d, _ in diff):+.3f} ms; the kernels that grow most:")
    for d, key in diff[::-1][:top]:
        print(f"[{tag}]   {d:+8.3f} ms  {key[:110]}")
    return sum(d for d, _ in diff)


def _selfsup_pair(mesh):
    """One Adam step of the full-width sarcasm model (zdim 300, InfoNCE,
    dropout 0.1 from a card generator seeded 0, bs 128) on the [multibench]
    fixture, without a mesh and over ``mesh``, from one init -> the number
    of tensors compared; the metrics and parameters bit-equal."""
    import torch

    from uml_tpu_torch.data.affect import AffectBatchStream, load_affect
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
    from uml_tpu_torch.train.selfsup import SelfSupTrainer

    root = os.path.join(ROOT, "build", "chip_smoke", "mb")
    splits = load_affect(f"{root}/data_files/sarcasm.pkl", "sarcasm", vision_norm=True)
    data, lengths, _ = next(iter(AffectBatchStream(splits["train"], 128, seed=42).epoch()))
    batch = (data["vision"], data["text"], lengths["vision"], lengths["text"])
    out = []
    for m in (None, mesh):
        model = make_seq_uml(371, 300, MB_ZDIM, pos_embd=True, pos_learnable=True,
                             info_nce=True, dropout=0.1)
        trainer = SelfSupTrainer(model, lr=1e-4, seed=0, device="cuda")
        trainer.init()
        gen = torch.Generator(device="cuda").manual_seed(0)
        metrics = trainer.train_step(*trainer.to_device(*batch), 1.0, 1.0, gen, mesh=m)
        out.append((metrics, dict(model.named_parameters())))
    (m_plain, p_plain), (m_dp, p_dp) = out
    _check(sorted(m_plain) == sorted(m_dp), (sorted(m_plain), sorted(m_dp)))
    for k in m_plain:
        _check(torch.equal(m_plain[k], m_dp[k]), ("selfsup metric", k, m_plain[k], m_dp[k]))
    for k, v in p_plain.items():
        _check(torch.equal(v, p_dp[k]), ("selfsup parameter", k))
    return len(m_plain), len(p_plain)


def phase_parallel(root):
    """[parallel]: a process group of world size 1 over NCCL on the card and
    create_mesh() over it, passed to each loop as the CLIs pass it: the
    ViT-B/16 full-model step (batch 64; train/supervised.py, the weights
    broadcast from rank 0 first) in every backward mode, loss, gradients
    and updated parameters bit-equal to the step without a mesh, the launch
    counters of rows 5-9, 19 and 20 moving under the mesh; validate,
    features' image_features (the round robin and its gather over NCCL)
    and one selfsup step (InfoNCE's gathered negatives, dropout's global
    mask) bit-equal to theirs without a mesh; the step's ms with and
    without it, and a profile of both.  Without the group, before and
    after it: features and finetune with --mesh auto against --mesh off on
    the one card, the same outputs -> numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.core import distributed as ud
    from uml_tpu_torch.core.meshes import create_mesh, data_size, replicate
    from uml_tpu_torch.data.feature_cache import load_cache
    from uml_tpu_torch.parallel.data_parallel import sync_gradients
    from uml_tpu_torch.train import optim
    from uml_tpu_torch.train.supervised import eval_batches, make_train_step, make_validate

    gpu = _gpu_line()
    # one card: --mesh auto starts no process group and runs as --mesh off
    caches = {}
    for flag in ("auto", "off"):
        args = _features_args(root, 64, f"{root}/features_mesh_{flag}")
        args.mesh = flag
        encoder = feat.main(args)
        _check(not dist.is_initialized(), ("a process group after --mesh", flag))
        caches[flag] = {os.path.relpath(p, f"{root}/features_mesh_{flag}"): load_cache(p)
                        for p in _pth_files(f"{root}/features_mesh_{flag}")}
    _check(sorted(caches["auto"]) == sorted(caches["off"]) and caches["off"],
           sorted(caches["auto"]))
    for rel in caches["off"]:
        _check(_tree_equal(caches["auto"][rel], caches["off"][rel]), ("features", rel))
    items = feat.get_few_shot_benchmark(root, f"{root}/indices", "caltech101", 16,
                                        1)["train"]

    store = os.path.join(root, "parallel_store")
    if os.path.exists(store):
        os.remove(store)
    with _env({"UML_COORDINATOR": f"file://{store}", "UML_NUM_PROCESSES": "1",
               "UML_PROCESS_ID": "0"}):
        _check(ud.maybe_initialize(), "maybe_initialize")
    mesh = create_mesh()
    _check(dist.get_backend() == "nccl" and data_size(mesh) == 1
           and tuple(mesh.mesh_dim_names) == ("data", "model"), mesh)
    numbers = {}
    try:
        feats = [feat.image_features(encoder, items, "crop", 64, 8, seed=1, mesh=m)
                 for m in (None, mesh)]
        _check(_tree_equal(feats[0], feats[1]), "image_features over the mesh")
        del encoder
        plain, batch = _head_and_batch(64)
        start = {k: v.clone() for k, v in plain.state_dict().items()}
        dp = copy.deepcopy(plain)
        plain.cuda()
        dp.cuda()
        host = [t.numpy() for t in batch]
        img_b, txt_b = host[:3], host[3:]

        def steps(env):
            out = []
            for model, m in ((plain, None), (dp, mesh)):
                model.load_state_dict(start)
                opt = optim.build_optimizer("adamw", optim.build_schedule(
                    1e-5, "cosine", 0, 10), 0.05)
                replicate(m, model)
                with _env(env):
                    out.append(make_train_step(model, opt, has_image=True, has_text=True,
                                               mesh=m))
            return out

        for mode, (env, rows) in PARALLEL_MODES.items():
            step_plain, step_dp = steps(env)
            with _env(env):
                loss_plain, _ = step_plain(0, img_b, txt_b)
                (loss_dp, _), launches = _counted(lambda: step_dp(0, img_b, txt_b))
            _check(torch.equal(loss_plain, loss_dp), (mode, loss_plain, loss_dp))
            n = _same_step(plain, dp, mode)
            _check(all(launches[r] > 0 for r in rows), (mode, launches))
            moved = {r: launches[r] for r in rows}
            numbers[f"parallel_launches_{mode}"] = moved
            print(f"[parallel] {mode}: the ViT-B/16 full-model step at batch 64 over "
                  f"the world-size-1 NCCL mesh: loss {float(loss_dp):.6f} and the "
                  f"{n} parameters and gradients bit-equal to the step without a "
                  f"mesh; launches under the mesh {moved}")
        # validate: a full batch and a ragged one (22 rows of 64 padding)
        val = eval_batches(np.concatenate([img_b[0], img_b[0][:42]]),
                           np.concatenate([img_b[1], img_b[1][:42]]), 64)
        scores = [make_validate(model, m)(None, val) for model, m in ((plain, None), (dp, mesh))]
        _check(scores[0] == scores[1], ("validate over the mesh", scores))
        n_metrics, n_params = _selfsup_pair(mesh)
        print(f"[parallel] over the mesh, bit-equal to the run without it: validate "
              f"(loss {scores[1][0]:.6f}, acc {scores[1][1]:.4f}, 2 batches of 64, "
              f"one ragged); image_features of {len(items)} images ({len(feats[1]['features'])} "
              f"rows, the round robin gathered over NCCL); one selfsup step (sarcasm, "
              f"zdim 300, InfoNCE, dropout 0.1, bs 128): {n_metrics} metrics and "
              f"{n_params} parameters")
        step_plain, step_dp = steps({})
        for name, fn in (("off", step_plain), ("mesh", step_dp)):
            ms = _time_ms(lambda: fn(0, img_b, txt_b), iters=5, warmup=2)
            numbers[f"parallel_step_ms_{name}"] = ms
        trainable = [p for p in dp.parameters() if p.grad is not None]
        numbers["parallel_sync_ms"] = _time_ms(
            lambda: sync_gradients(trainable, mesh), iters=10, warmup=2)
        print(f"[parallel] {gpu}: ViT-B/16 full-model step bs 64: "
              f"{numbers['parallel_step_ms_off']:.2f} ms without a mesh, "
              f"{numbers['parallel_step_ms_mesh']:.2f} ms over the world-size-1 "
              f"mesh; its gradient average alone (NCCL, "
              f"{sum(p.grad.numel() for p in trainable) * 4 / 2**20:.1f} MiB of "
              f"fp32 in 64 MB buckets) {numbers['parallel_sync_ms']:.3f} ms")
        numbers["parallel_device_ms_added"] = _kernel_diff(
            "ViT-B/16 full-model step bs 64",
            _profile("parallel step without a mesh", lambda: step_plain(0, img_b, txt_b),
                     top=5),
            _profile("parallel step over the mesh", lambda: step_dp(0, img_b, txt_b),
                     top=5))
        del plain, dp
    finally:
        dist.destroy_process_group()

    results = {}
    for flag in ("auto", "off"):
        _, _, results[flag] = _finetune(root, "smoke", _wrappers(),
                                        result_dir=f"experiments_mesh_{flag}",
                                        extra=("--mesh", flag))
    _check(_tree_equal(results["auto"], results["off"]), "finetune --mesh auto vs off")
    print(f"[parallel] one card: features --mesh auto wrote the {len(caches['off'])} "
          f"caches of --mesh off bit for bit; finetune --hyperparams smoke --mesh "
          f"auto the test_result of --mesh off (test acc "
          f"{float(results['off']['test_acc']):.4f}); no process group")
    return {k: v for k, v in numbers.items() if not isinstance(v, dict)}


def _tp_group(root):
    """A world-size-1 NCCL process group and create_mesh(1, 1) over it."""
    import torch.distributed as dist

    from uml_tpu_torch.core import distributed as ud
    from uml_tpu_torch.core.meshes import create_mesh

    store = os.path.join(root, "tp_store")
    if os.path.exists(store):
        os.remove(store)
    with _env({"UML_COORDINATOR": f"file://{store}", "UML_NUM_PROCESSES": "1",
               "UML_PROCESS_ID": "0"}):
        _check(ud.maybe_initialize(), "maybe_initialize")
    mesh = create_mesh(1, 1)
    _check(dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
           and tuple(mesh.mesh_dim_names) == ("data", "model"), mesh)
    return mesh


def _tp_llama(mesh, gpu):
    """LLaMA-7B's widths and depth through TextModel.native, without the
    mesh, with parallel.apply_tp_sharding over it, and with the mesh
    handed to TextModel.native (whose model axis is one wide, so it
    stays unsharded) -> numbers."""
    import torch

    from uml_tpu_torch.models.languagemodel import TextModel
    from uml_tpu_torch.models.llama import LLAMA_TP_RULES, LlamaConfig, LlamaEncoder
    from uml_tpu_torch.parallel import apply_tp_sharding

    cfg = LlamaConfig(**OPENLLAMA_7B)
    ids_np, mask_np = _llama_prompts(cfg.vocab_size)
    ids, mask = torch.from_numpy(ids_np).cuda(), torch.from_numpy(mask_np).cuda()
    with torch.device("meta"):
        model = LlamaEncoder(cfg)
    model.to_empty(device="cuda")
    model.init_random(torch.Generator(device="cuda").manual_seed(0))
    state_dict = model.state_dict()
    del model
    numbers = {}
    # fp32: the 7 projections' weights; int8_w: their kernel_q8 and the 5
    # column-parallel scales
    per_layer = {"none": 7, "int8_w": 12}
    for quant in ("none", "int8_w"):
        out, ms = {}, {}
        for tag in ("off", "tp", "native_mesh"):
            tm = TextModel.native(cfg, state_dict, quant=quant, device="cuda",
                                  mesh=mesh if tag == "native_mesh" else None)
            if tag == "tp":
                apply_tp_sharding(tm.model, mesh, rules=LLAMA_TP_RULES)
            out[tag] = tm.encode_ids(ids, mask)
            ms[tag] = _time_ms(lambda: tm.encode_ids(ids, mask), iters=5, warmup=1)
            n_dt = sum(1 for n, _ in [*tm.model.named_parameters(),
                                      *tm.model.named_buffers()] if "original" in n)
            want = per_layer[quant] * cfg.num_hidden_layers if tag == "tp" else 0
            _check(n_dt == want, ("sharded projections", quant, tag, n_dt, want))
            del tm
        key = "fp32" if quant == "none" else quant
        for tag in ("tp", "native_mesh"):
            _check(torch.equal(out["off"], out[tag]),
                   (f"LLaMA-7B {key} {tag}", (out["off"] - out[tag]).abs().max()))
        numbers.update({f"tp_llama7b_{key}_ms_off": ms["off"],
                        f"tp_llama7b_{key}_ms_tp": ms["tp"],
                        f"tp_llama7b_{key}_ms_native_mesh": ms["native_mesh"]})
        print(f"[tp] OpenLLaMA-7B widths, 32 layers, {key}: pooled features with "
              f"apply_tp_sharding over the (1, 1) mesh ({per_layer[quant]} sharded tensors "
              f"a layer) and through TextModel.native(..., mesh=) (unsharded: its model "
              f"axis is one wide) bit-equal to those without it; {ms['off']:.3f} ms a call "
              f"without, {ms['tp']:.3f} ms sharded, {ms['native_mesh']:.3f} ms through "
              f"TextModel.native with the mesh (8 prompts x 32 ids)  [{gpu}]")
    return numbers


def _tp_encoders(mesh, gpu):
    """The ViT-B/16 image encoder in bf16, int8 and int8 as the tower, with
    and without the mesh -> numbers."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.encoders import ClipEncoder
    from uml_tpu_torch.parallel import apply_tp_sharding

    batch = 64
    u8 = np.random.default_rng(3).integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    numbers = {}
    for quant, tower, rows in (("none", "0", ("attn_block", "attn_block_cls", "mlp_block")),
                               ("int8", "0", ("attn_block_q8", "mlp_block_q8")),
                               ("int8", "1", ("tower_q8",))):
        encoder = ClipEncoder("ViT-B/16", allow_random_init=True, quant=quant)
        staged, n = encoder.stage_images(u8)
        out, launches, rate = {}, {}, {}
        with _env({"UML_TOWER_Q8": tower}):
            for tag in ("off", "tp"):
                if tag == "tp":
                    apply_tp_sharding(encoder.model, mesh)
                (o, _), launches[tag] = _counted(lambda: encoder.encode_staged(staged, n))
                out[tag] = o.clone()
                ms = _time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
                rate[tag] = batch / (ms / 1e3)
        what = f"ViT-B/16 {quant}" + (" UML_TOWER_Q8=1" if tower == "1" else "")
        _check(torch.equal(out["off"], out["tp"]), (what, "features over the mesh"))
        _check(launches["off"] == launches["tp"] and all(launches["tp"][r] > 0 for r in rows),
               (what, launches))
        key = quant + ("_tower" if tower == "1" else "")
        numbers.update({f"tp_encoder_img_per_s_{key}_off": rate["off"],
                        f"tp_encoder_img_per_s_{key}_tp": rate["tp"]})
        print(f"[tp] {what} image encoder, batch {batch}: features over the mesh bit-equal; "
              f"launches {({r: launches['tp'][r] for r in rows})} as without it; "
              f"{rate['off']:.1f} img/s without, {rate['tp']:.1f} with  [{gpu}]")
        del encoder
    return numbers


def _tp_step(mesh, gpu):
    """The ViT-B/16 full-model step (batch 64) with TP-applied weights in
    each backward mode, bit-equal to the step without -> numbers."""
    import torch

    from uml_tpu_torch.core.meshes import replicate
    from uml_tpu_torch.parallel import apply_tp_sharding
    from uml_tpu_torch.parallel.tensor_parallel import declared_name, local, whole
    from uml_tpu_torch.train import optim
    from uml_tpu_torch.train.supervised import make_train_step

    bsz = 64
    plain, batch = _head_and_batch(bsz)
    tp = copy.deepcopy(plain)
    plain.cuda()
    tp.cuda()
    apply_tp_sharding(tp.backbone, mesh)
    host = [t.numpy() for t in batch]
    img_b, txt_b = host[:3], host[3:]

    def named(model):
        return [(declared_name(n), p) for n, p in model.named_parameters()]

    numbers = {}
    start_params = {name: p.detach().clone() for name, p in named(plain)}

    def reset():
        with torch.no_grad():
            for model in (plain, tp):
                for name, p in named(model):
                    local(p).copy_(start_params[name])
                    p.grad = None

    def make(model, m, env):
        opt = optim.build_optimizer("adamw", optim.build_schedule(1e-5, "cosine", 0, 10),
                                    0.05)
        replicate(m, model)
        with _env(env):
            return make_train_step(model, opt, has_image=True, has_text=True, mesh=m)

    for mode, (env, rows) in PARALLEL_MODES.items():
        reset()
        step_plain, step_tp = make(plain, None, env), make(tp, mesh, env)
        with _env(env):
            loss_plain, _ = step_plain(0, img_b, txt_b)
            (loss_tp, _), launches = _counted(lambda: step_tp(0, img_b, txt_b))
        _check(torch.equal(loss_plain, loss_tp), (mode, loss_plain, loss_tp))
        n, tp_params = 0, dict(named(tp))
        _check(sorted(tp_params) == sorted(dict(named(plain))), "the TP model's parameters")
        for name, a in named(plain):
            b = tp_params[name]
            _check(torch.equal(a, whole(b)), (mode, "parameter", name))
            _check((a.grad is None) == (b.grad is None)
                   and (a.grad is None or torch.equal(a.grad, whole(b.grad))),
                   (mode, "grad", name))
            n += 1
        _check(all(launches[r] > 0 for r in rows), (mode, launches))
        numbers[f"tp_step_launches_{mode}"] = {r: launches[r] for r in rows}
        print(f"[tp] {mode}: the ViT-B/16 full-model step at batch {bsz} with TP-applied "
              f"weights: loss {float(loss_tp):.6f}, the {n} parameters and gradients "
              f"bit-equal to the step without; launches {({r: launches[r] for r in rows})}")
    reset()
    step_plain, step_tp = make(plain, None, {}), make(tp, mesh, {})
    for tag, fn in (("off", step_plain), ("tp", step_tp)):
        numbers[f"tp_step_ms_{tag}"] = _time_ms(lambda: fn(0, img_b, txt_b), iters=5,
                                                warmup=2)
    print(f"[tp] {gpu}: ViT-B/16 full-model step bs {bsz}: {numbers['tp_step_ms_off']:.2f} ms "
          f"without, {numbers['tp_step_ms_tp']:.2f} ms with TP-applied weights")
    rows = {tag: _profile(f"tp step {tag}", lambda fn=fn: fn(0, img_b, txt_b), top=5)
            for tag, fn in (("without the mesh", step_plain), ("with TP-applied weights", step_tp))}
    numbers["tp_step_device_ms_added"] = _kernel_diff(
        "ViT-B/16 full-model step bs 64 with TP-applied weights", *rows.values(), tag="tp")
    for tag, prof in rows.items():
        numbers[f"tp_step_busy_{'tp' if 'TP' in tag else 'off'}"] = _busy_share(
            prof, numbers[f"tp_step_ms_{'tp' if 'TP' in tag else 'off'}"])
    return {k: v for k, v in numbers.items() if not isinstance(v, dict)}


def phase_tp(root):
    """[tp] (module docstring, 5j) -> numbers."""
    import torch.distributed as dist

    gpu = _gpu_line()
    mesh = _tp_group(root)
    numbers = {}
    try:
        numbers.update(_tp_llama(mesh, gpu))
        numbers.update(_tp_encoders(mesh, gpu))
        numbers.update(_tp_step(mesh, gpu))
    finally:
        dist.destroy_process_group()
    return numbers


def phase_graft():
    """[graft] (module docstring, 5k) -> numbers."""
    import torch

    from uml_tpu_torch import graft_entry

    gpu = _gpu_line()
    fn, (model, images) = graft_entry.entry()
    _check(images.is_cuda and next(model.parameters()).is_cuda, "entry() on the card")
    out, launches = _counted(lambda: fn(model, images))
    _check(tuple(out.shape) == (8, 512) and bool(torch.isfinite(out).all()),
           ("entry forward", tuple(out.shape)))
    want = _with_fused({**dict.fromkeys(launches, 0), "attn_block": 11,
                        "attn_block_cls": 1, "mlp_block": 12})
    _check(launches == want, ("entry forward launches", launches, want))
    ms = _time_ms(lambda: fn(model, images), iters=10)
    cpu = fn(model.cpu(), images.cpu())
    cos = _cos_min(out.float().cpu().numpy(), cpu.float().numpy())
    _check(cos >= MIN_COSINE, ("entry forward card vs CPU", cos))
    del model
    print(f"[graft] entry(): ViT-B/16 bf16 forward of 8 uint8 images on the card "
          f"{tuple(out.shape)}, finite, launches {({k: v for k, v in launches.items() if v})}, "
          f"{ms:.3f} ms a call; card vs CPU min cosine {cos:.6f}  [{gpu}]")
    t = time.perf_counter()
    graft_entry.dryrun_multichip(4)
    dry = time.perf_counter() - t
    print(f"[graft] dryrun_multichip(4): every leg ok on four gloo processes on the "
          f"CPU in {dry:.1f} s")
    return {"graft_entry_ms": ms, "graft_entry_card_vs_cpu_cos": cos,
            "graft_dryrun_multichip4_s": dry}


def _pth_files(root):
    return sorted(os.path.join(d, f) for d, _, files in os.walk(root)
                  for f in files if f.endswith(".pth"))


def _tree_equal(a, b) -> bool:
    import numpy as np
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def _device_rows(events):
    """(name, self device time in us, count) of the events of a profile's
    ``key_averages()`` that ran on the card, chosen by kind
    (uml_tpu_torch/utils/profiling.py::device_rows)."""
    from uml_tpu_torch.utils.profiling import device_rows

    return device_rows(events)


def _profile(what, fn, reps=3, top=10, by_op=False):
    """Device time by kernel over ``reps`` calls (torch.profiler, CUPTI)
    and the device's busy share of the wall time of those calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a capture that holds no device event at all is a failed measurement
    # (seen once on the card, between two full captures): profile again
    for attempt in range(2):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = _device_rows(prof.key_averages())
        busy = sum(t for _, t, _ in rows)
        if busy > 0:
            break
        print(f"[profile] {what}: the capture holds no device event; profiling again")
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


def _busy_share(rows, step_ms, reps=3):
    """The device's busy share of a step: the device time per call of a
    ``_profile`` of ``reps`` calls over the step's unprofiled time."""
    return sum(t for _, t, _ in rows) / reps / 1e3 / step_ms


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
    t_start = time.perf_counter()

    def timed(phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        print(f"[main] {phase.__name__}: {time.perf_counter() - t:.1f} s")
        return out

    timed(phase_setup)
    kernels = timed(phase_kernels)
    launches, rate, root, sizes, encoder = timed(phase_main_path)
    int8_launches, int8_numbers = timed(phase_int8_path, root, sizes, encoder)
    rate.update(int8_numbers)
    unfused_launches, unfused_numbers = timed(phase_unfused, encoder)
    rate.update(unfused_numbers)
    del encoder
    train_launches, recompute_launches, train_numbers = timed(phase_train, root, sizes)
    rate.update(train_numbers)
    dino_launches, dino_numbers = timed(phase_dino, root, sizes)
    rate.update(dino_numbers)
    dino_train_launches, dino_train_numbers = timed(phase_dino_train, root, sizes)
    rate.update(dino_train_numbers)
    _, rn_numbers = timed(phase_rn, root, sizes)
    rate.update(rn_numbers)
    rate.update(timed(phase_rn_train, root))
    llama_numbers, llama_launches = timed(phase_llama)
    rate.update(llama_numbers)
    rate.update(timed(phase_resume, root))
    rate.update(timed(phase_multibench))
    rate.update(timed(phase_gaussian))
    rate.update(timed(phase_parallel, root))
    rate.update(timed(phase_tp, root))
    rate.update(timed(phase_graft))
    # each port's launches come from the path it belongs to: the bf16
    # serving kernels from the features run, the int8 ones from the
    # features --quant int8 run and its tower encode, the training kernels
    # from the full-model finetune run, the recompute backwards from the
    # finetune runs with both stashes off, the stand-alone ops from the
    # non-fused image encode (attn_impl="pallas") and the public ops' calls,
    # the grouped expert kernel from DeepSeek-V2-Lite's text encode
    launches = {**launches, **unfused_launches, **llama_launches,
                **{k: int8_launches[k] for k in (*Q8_PORTS, "mlp_block_q8_identity")},
                **{k: train_launches[k] for k in TRAIN_PORTS},
                **{k: recompute_launches[k] for k in RECOMPUTE_PORTS}}
    launches.update(dino_launches)
    launches.update(dino_train_launches)
    _check(all(launches[name] > 0 for name, _, _ in PORTS)
           and all(dino_launches[name] > 0 for name, _, _, _ in DINO_PORTS)
           and all(dino_train_launches[name] > 0 for name, *_ in DINO_TRAIN_PORTS),
           launches)
    table = []
    for name, source, replaces in (PORTS + [(n, s, r) for n, _, s, r in DINO_PORTS]
                                   + [(n, s, r) for n, _, _, s, r in DINO_TRAIN_PORTS]):
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
    print(f"[main] every phase ran in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"throughput": rate}))
    print(json.dumps({"products": products}))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
