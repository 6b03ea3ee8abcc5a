#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (uml_tpu_torch) runs on a GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases (any failure exits non-zero; no phase is caught):

1. setup: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``uml_tpu_torch/csrc`` (nvcc, sm_90a).
2. kernels: each port (attn_block non-causal, attn_block_cls, mlp_block at
   ViT-B/16 widths; causal attn_block and the 12-layer text_tower at the
   CLIP text widths) against its plain PyTorch version on the same bf16
   inputs, within the stated bounds, timed with CUDA events.
3. main path: generate_fewshot and features on a synthetic caltech-layout
   fixture with a random-init ViT-B/16; the .pth caches must hold finite
   width-512 features, the encoder must live on the card, every port's
   launch counter must have moved by the expected count, and the card's
   features must agree with the same model run on the CPU (plain path).
4. training path: the finetune CLI on the phase-3 fixture and text cache,
   frozen (``--hyperparams smoke``) and full-model (``smoke_full``: the
   ViT-B/16 tower at full width, bs 8, 30 steps), then collect_results
   over the tree.  The artifacts must hold finite scalars, each path's
   launch counters must have moved by the expected count (per full-model
   step 11 attn_block_stash, 11 attn_block_bwd, 1 attn_block_cls_bwd and
   12 mlp_block_stash), and the tower must have moved.  One bs-4 train step
   of a random-init ViT-B/16 head on the card against the same model and
   batch on the CPU (plain path): loss and per-tensor gradient cosines
   within the stated bounds.  Then the steady-state full-model train step
   (forward, backward, adamw) at bs 64 in img/s, with a profile.
5. the kernel table as one JSON line, the device line last.

The script needs nothing of JAX.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
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
]
TRAIN_PORTS = ("attn_block_stash", "attn_block_bwd", "attn_block_cls_bwd",
               "mlp_block_stash")

# Kernel vs plain version, bf16 on the card.  Both compute the same math
# with fp32 accumulation; they differ in summation order, so an
# intermediate (qkv, probabilities, hidden, residual) can round to the
# neighbouring bf16 value (2^-8 relative) and carry that into the output.
# The bound is on max|kernel - plain| / max|plain|: 1/64 (4 bf16 ulps of
# the largest output) for one half-block, 1/16 for the 12-layer tower,
# where such flips compound through 24 residual roundings.
# The training kernels are held to the same 1/64 on every output (out,
# qkv, attn; dx, dqkv, xn; out, pre), each against its own max.
REL_BOUND = {"attn_block": 1 / 64, "attn_block_cls": 1 / 64,
             "mlp_block": 1 / 64, "attn_block_causal": 1 / 64,
             "text_tower": 1 / 16, "attn_block_stash": 1 / 64,
             "attn_block_bwd": 1 / 64, "attn_block_cls_bwd": 1 / 64,
             "mlp_block_stash": 1 / 64}
# card vs CPU plain path on the same random-init ViT-B/16 (bf16 both):
# per-row cosine of the features
MIN_COSINE = 0.999
# one bs-4 train step, card vs CPU plain path (bf16 both): the loss within
# 1% relative, and per parameter tensor of the image tower and the head
# the cosine of the two gradients at least 0.99 (the attention k-biases
# aside: their exact gradient is zero, so both are rounding noise)
STEP_LOSS_RTOL = 1e-2
STEP_MIN_GRAD_COSINE = 0.99


def _check(ok, what) -> None:
    """A failed check ends the run (not an ``assert``: it must hold under
    ``python -O`` too)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _time_ms(fn, iters=20, warmup=3) -> float:
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


def phase_kernels():
    """-> {port name: {max_abs_err, ms, plain_ms}} at the main path's shapes."""
    import torch

    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm
    from uml_tpu_torch.ops.fused_attention import (attn_block, attn_block_cls,
                                                   attn_block_cls_plain,
                                                   attn_block_plain)
    from uml_tpu_torch.ops.ln_matmul import mlp_block, mlp_block_plain
    from uml_tpu_torch.ops.text_tower import text_tower, text_tower_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    # ViT-B/16 image layer: B=64, S=197, K=768, 12 heads, M=3072
    xv = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    wv = _block_weights(gen, 768, 3072, 768, dev)
    attn_v = (wv["w_eff"], wv["b_eff"], wv["wo"], wv["bo"])
    mlp_v = (wv["w1"], wv["b1"], wv["w2"], wv["b2"])
    # CLIP text tower: B=64, S=77, K=512, 8 heads, M=2048, 12 layers
    xt = torch.randn(64, 77, 512, generator=gen, device=dev).to(bf)
    layers = [_block_weights(gen, 512, 2048, 512, dev) for _ in range(12)]
    tower = tuple(torch.stack([l[n] for l in layers]) for n in
                  ("w_eff", "b_eff", "wo", "bo", "w1", "b1", "w2", "b2"))
    attn_t = tower[0][0], tower[1][0], tower[2][0], tower[3][0]
    # the training kernels at the same ViT-B/16 layer: the backward takes
    # the plain stash forward's qkv and a random cotangent
    _, qkv_v, _ = fa.attn_block_stash_plain(xv, *attn_v, heads=12)
    _, qkv_c, _ = fa.attn_block_stash_plain(xv, *attn_v, heads=12, q_rows=1)
    g_v = torch.randn(64, 197, 768, generator=gen, device=dev).to(bf)
    g_c = torch.randn(64, 1, 768, generator=gen, device=dev).to(bf)
    w_eff, wo = wv["w_eff"], wv["wo"]

    cases = [
        ("attn_block", lambda: attn_block(xv, *attn_v, heads=12),
         lambda: attn_block_plain(xv, *attn_v, heads=12)),
        ("attn_block_cls", lambda: attn_block_cls(xv, *attn_v, heads=12),
         lambda: attn_block_cls_plain(xv, *attn_v, heads=12)),
        ("mlp_block", lambda: mlp_block(xv, *mlp_v),
         lambda: mlp_block_plain(xv, *mlp_v)),
        ("attn_block_causal",
         lambda: attn_block(xt, *attn_t, heads=8, causal=True),
         lambda: attn_block_plain(xt, *attn_t, heads=8, causal=True)),
        ("text_tower", lambda: text_tower(xt, *tower, heads=8),
         lambda: text_tower_plain(xt, *tower, heads=8)),
        ("attn_block_stash", lambda: fa.attn_block_stash(xv, *attn_v, heads=12),
         lambda: fa.attn_block_stash_plain(xv, *attn_v, heads=12)),
        ("attn_block_bwd",
         lambda: fa.attn_block_bwd(xv, g_v, qkv_v, w_eff, wo, heads=12),
         lambda: fa.attn_block_bwd_plain(xv, g_v, qkv_v, w_eff, wo, heads=12)),
        ("attn_block_cls_bwd",
         lambda: fa.attn_block_cls_bwd(xv, g_c, qkv_c, w_eff, wo, heads=12),
         lambda: fa.attn_block_cls_bwd_plain(xv, g_c, qkv_c, w_eff, wo,
                                             heads=12)),
        ("mlp_block_stash", lambda: lm.mlp_block_stash(xv, *mlp_v),
         lambda: lm.mlp_block_stash_plain(xv, *mlp_v)),
    ]
    results = {}
    for name, kernel_fn, plain_fn in cases:
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, rel = 0.0, 0.0
        for a, b in zip(got, want, strict=True):
            _check(a.shape == b.shape, (name, a.shape, b.shape))
            _check(bool(torch.isfinite(a.float()).all()), f"{name}: non-finite")
            e = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            _check(e <= REL_BOUND[name] * scale, f"{name}: {e} > bound of {scale}")
            err, rel = max(err, e), max(rel, e / scale)
        ms = _time_ms(kernel_fn)
        plain_ms = _time_ms(plain_fn)
        print(f"[kernels] {name:18s} shapes {[tuple(a.shape) for a in got]} "
              f"max_abs_err {err:.5f} max_rel_err {rel:.5f} (bound "
              f"{REL_BOUND[name]:.5f}) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return results


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


def phase_main_path():
    """-> ({port name: launches}, images/s numbers)."""
    import numpy as np
    import torch

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.cli import generate_fewshot as gf
    from uml_tpu_torch.data.feature_cache import img_outdir, load_cache, text_outdir
    from uml_tpu_torch.ops.fused_attention import attn_block, attn_block_cls
    from uml_tpu_torch.ops.ln_matmul import mlp_block
    from uml_tpu_torch.ops.text_tower import text_tower

    root = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sizes = make_fixture(root)
    gf.main(gf.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--dataset", "caltech101", "--train-shot", "16", "--seed", "1"]))
    batch = 64
    args = feat.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", f"{root}/features", "--dataset", "caltech101",
        "--clip-encoder", "ViT-B/16", "--allow-random-init",
        "--train-shot", "16", "--seed", "1",
        "--text-augmentation", "hand_crafted", "--batch-size", str(batch)])
    args.overwrite = False
    args.force_rerun = False

    wrappers = {"attn_block": attn_block, "attn_block_cls": attn_block_cls,
                "mlp_block": mlp_block, "text_tower": text_tower}
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    encoder = feat.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    print(f"[main] features CLI {wall:.2f} s (random init, decode, 3 splits, "
          f"text); launches {launches}")

    # expected counts: per image batch 11 full attention halves, 1 CLS
    # half and 12 MLP halves; one text_tower call per class prompt batch
    n_batches = sum(-(-n // batch) for n in (sizes["train"], sizes["val"],
                                           sizes["test"]))
    n_classes = 8
    want = {"attn_block": 11 * n_batches, "attn_block_cls": n_batches,
            "mlp_block": 12 * n_batches, "text_tower": n_classes}
    _check(launches == want, (launches, want))
    _check(all(p.device.type == "cuda" for p in encoder.model.parameters()),
           "encoder parameters on the card")

    img_path = img_outdir(args.feature_dir, "ViT-B/16", "caltech101", "crop",
                          16, 1, "train")
    test_path = img_outdir(args.feature_dir, "ViT-B/16", "caltech101", "crop",
                           16, 1, "test")
    txt_path = text_outdir(args.feature_dir, "ViT-B/16", "caltech101",
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
    print(f"[main] caches written: {img_path} {test_path} {txt_path}")

    # the card against the same model on the CPU (plain path), 4 images
    # and 2 prompts
    from uml_tpu_torch.data.loader import ImageBatchLoader

    cpu_model = copy.deepcopy(encoder.model).to("cpu")
    imgs, _, _ = next(iter(ImageBatchLoader(
        [{"impath": p, "label": 0} for p in test["paths"][:4]], batch_size=4,
        num_workers=1)))
    gpu_f = encoder.encode_images(imgs)
    with torch.no_grad():
        cpu_f = cpu_model.encode_image_u8(
            torch.from_numpy(imgs.reshape(4, -1))).numpy()
    prompts = ["a photo of a class_0.", "a photo of a class_1."]
    gpu_t, _ = encoder.encode_texts(prompts)
    from uml_tpu_torch.models.tokenizer import tokenize

    with torch.no_grad():
        cpu_t = cpu_model.encode_text(
            torch.from_numpy(tokenize(prompts).astype(np.int64))).numpy()

    def cos(a, b):
        return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                                  * np.linalg.norm(b, axis=-1))

    cos_img, cos_txt = cos(gpu_f, cpu_f).min(), cos(gpu_t, cpu_t).min()
    print(f"[main] card vs CPU plain path: min cosine image {cos_img:.6f} "
          f"text {cos_txt:.6f} (bound {MIN_COSINE})")
    _check(cos_img >= MIN_COSINE and cos_txt >= MIN_COSINE,
           f"card vs CPU cosine {cos_img}, {cos_txt}")

    # steady-state encoder throughput on a staged batch (decode excluded)
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    staged, n = encoder.stage_images(u8)
    ms = _time_ms(lambda: encoder.encode_staged(staged, n), iters=10)
    rate = {"features_wall_s": wall,
            "features_images": sum(sizes.values()),
            "encoder_img_per_s_bs64": batch / (ms / 1e3)}
    print(f"[main] image encoder forward {ms:.3f} ms per batch of {batch} "
          f"= {rate['encoder_img_per_s_bs64']:.1f} img/s")
    prompts = [f"a photo of a class_{i}." for i in range(batch)]
    ms_txt = _time_ms(lambda: encoder.encode_texts(prompts), iters=10)
    rate["text_prompts_per_s_bs64"] = batch / (ms_txt / 1e3)
    print(f"[main] encode_texts {ms_txt:.3f} ms per {batch} prompts (tokenize, "
          f"H2D, tower, D2H) = {rate['text_prompts_per_s_bs64']:.1f} prompts/s")
    _profile("image encoder", lambda: encoder.encode_staged(staged, n))
    _profile("text encoder", lambda: encoder.encode_texts(prompts))
    return launches, rate, root, sizes


def _finetune(root, grid, wrappers):
    """One finetune CLI run -> (launch counts, wall seconds, the combo's
    test_result, the sweep's results)."""
    import torch

    from uml_tpu_torch.cli import finetune as ft
    from uml_tpu_torch.data.feature_cache import load_cache

    args = ft.build_parser().parse_args([
        "--data_dir", root, "--indices_dir", f"{root}/indices",
        "--feature_dir", f"{root}/features", "--result_dir",
        f"{root}/experiments", "--dataset", "caltech101",
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


def phase_train(root, sizes):
    """-> ({port name: launches} of the full-model run, numbers)."""
    import torch

    from uml_tpu_torch.cli import collect_results as cr
    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.ops import fused_attention as fa
    from uml_tpu_torch.ops import ln_matmul as lm

    wrappers = {"attn_block": fa.attn_block, "attn_block_cls": fa.attn_block_cls,
                "mlp_block": lm.mlp_block,
                "attn_block_stash": fa.attn_block_stash,
                "attn_block_bwd": fa.attn_block_bwd,
                "attn_block_cls_bwd": fa.attn_block_cls_bwd,
                "mlp_block_stash": lm.mlp_block_stash}
    # frozen path: the three splits encoded once in batches of 128, then
    # head-only steps on the features
    frozen, frozen_wall, _ = _finetune(root, "smoke", wrappers)
    n_enc = sum(-(-sizes[p] // 128) for p in ("train", "val", "test"))
    _check(frozen == {"attn_block": 11 * n_enc, "attn_block_cls": n_enc,
                      "mlp_block": 12 * n_enc, "attn_block_stash": 0,
                      "attn_block_bwd": 0, "attn_block_cls_bwd": 0,
                      "mlp_block_stash": 0}, ("smoke launches", frozen))

    # full path: 30 steps at bs 8 through the training kernels; the forward
    # kernels validate (val at iter 0 and for the best model, test at the
    # end) in batches of 8
    full, full_wall, result = _finetune(root, "smoke_full", wrappers)
    steps = 30
    n_eval = 2 * -(-sizes["val"] // 8) + -(-sizes["test"] // 8)
    want = {"attn_block": 11 * n_eval, "attn_block_cls": steps + n_eval,
            "mlp_block": 12 * n_eval, "attn_block_stash": 11 * steps,
            "attn_block_bwd": 11 * steps, "attn_block_cls_bwd": steps,
            "mlp_block_stash": 12 * steps}
    _check(full == want, ("smoke_full launches", full, want))
    # the saved best model is the iter-0 snapshot: one adamw step from the
    # encoder's random init (generator seed 0)
    init = build_clip("ViT-B/16").init_random(
        torch.Generator().manual_seed(0)).state_dict()
    trained = result["model"]["backbone"]
    visual = [k for k in init if k.startswith("visual.")]
    moved = [k for k in visual
             if (torch.as_tensor(trained[k]) - init[k]).abs().max().item() > 0]
    _check(len(moved) == len(visual), ("tower tensors moved", len(moved),
                                       len(visual)))
    print(f"[train] every one of the {len(visual)} image-tower tensors moved")

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

    numbers = {"finetune_smoke_wall_s": frozen_wall,
               "finetune_smoke_full_wall_s": full_wall}
    numbers.update(_card_vs_cpu_step())
    numbers.update(_train_step_rate())
    return full, numbers


def _head_and_batch(bsz, gen_seed=0):
    """A random-init ViT-B/16 UML head (bf16 compute, every CLIP leaf
    trainable) and one crossmodal batch of ``bsz`` on the CPU."""
    import numpy as np
    import torch

    from uml_tpu_torch.models.clip import build_clip
    from uml_tpu_torch.models.uml_head import make_uml_clip_head

    clip = build_clip("ViT-B/16", dtype=torch.bfloat16).init_random(
        torch.Generator().manual_seed(gen_seed))
    model = make_uml_clip_head(clip, 8, freeze_backbone=False,
                               generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(gen_seed)
    batch = (torch.from_numpy(rng.integers(0, 256, (bsz, 224 * 224 * 3),
                                           dtype=np.uint8)),
             torch.from_numpy(rng.integers(0, 8, bsz)),
             torch.ones(bsz),
             torch.from_numpy(rng.standard_normal((bsz, 512)).astype(np.float32)),
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


def _card_vs_cpu_step():
    """One bs-4 forward + backward on the card and on the CPU plain path,
    same weights and batch."""
    import torch

    cpu_model, cpu_batch = _head_and_batch(4)
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
    print(f"[train] bs-4 step card vs CPU: loss {losses[0]:.6f} vs "
          f"{losses[1]:.6f} (rel {rel:.2e}, bound {STEP_LOSS_RTOL}); "
          f"{len(cosines)} gradient tensors, min cosine "
          f"{cosines[worst]:.6f} ({worst}), bound {STEP_MIN_GRAD_COSINE}")
    _check(rel <= STEP_LOSS_RTOL, ("bs-4 loss", losses))
    _check(cosines[worst] >= STEP_MIN_GRAD_COSINE, ("gradient cosine", worst,
                                                     cosines[worst]))
    return {"step_loss_rel_err": rel, "step_min_grad_cosine": cosines[worst]}


def _train_step_rate(bsz=64, iters=10):
    """Steady-state full-model train step (forward, backward, adamw) at
    ``bsz`` on a staged batch, and its profile."""
    import torch

    from uml_tpu_torch.train.optim import build_optimizer, build_schedule

    model, batch = _head_and_batch(bsz)
    model.to("cuda")
    batch = tuple(t.to("cuda") for t in batch)
    opt = build_optimizer("adamw", build_schedule(5e-5, "cosine", 50, 12800),
                          0.01)
    opt.init([p for p in model.parameters() if p.requires_grad])
    it = iter(range(10 ** 6))

    def step(marks=None):
        """One step; ``marks``: four CUDA events recorded before the
        forward, the backward and adamw, and after adamw (the backward's
        kernels run on the forward's stream, from autograd's thread)."""
        def mark(i):
            if marks is not None:
                marks[i].record()

        mark(0)
        opt.zero_grad()
        loss = _loss(model, batch)
        mark(1)
        loss.backward()
        mark(2)
        opt.step(next(it))
        mark(3)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
             for _ in range(iters)]
    t0 = time.perf_counter()
    for m in marks:
        step(m)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rate = bsz / (ms / 1e3)
    phases = [sum(m[i].elapsed_time(m[i + 1]) for m in marks) / iters
              for i in range(3)]
    print(f"[train] full-model train step bs {bsz}: {ms:.3f} ms = {rate:.1f} "
          f"img/s (forward, backward, adamw; peak memory {peak:.2f} GiB)")
    print(f"[train] phases on the card's stream (CUDA events): forward "
          f"{phases[0]:.3f} ms, backward {phases[1]:.3f} ms, adamw "
          f"{phases[2]:.3f} ms")
    _profile(f"train step bs {bsz}", step, top=16, by_op=True)
    return {"train_step_ms_bs64": ms, "train_img_per_s_bs64": rate,
            "train_peak_gib_bs64": peak, "train_forward_ms_bs64": phases[0],
            "train_backward_ms_bs64": phases[1], "train_adamw_ms_bs64": phases[2]}


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
    # device-side events only (kernels, copies): an aten op's own row
    # would count its kernels a second time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            # a record_function range (Optimizer.step#AdamW.step) spans
            # kernels counted in their own rows
            and not getattr(e, "is_user_annotation", False)
            and "#" not in e.key]
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
    launches, rate, root, sizes = phase_main_path()
    train_launches, train_numbers = phase_train(root, sizes)
    rate.update(train_numbers)
    # each port's launches come from the path it belongs to: the serving
    # kernels from the features run, the training kernels from the
    # full-model finetune run
    launches = {**launches, **{k: train_launches[k] for k in TRAIN_PORTS}}
    _check(all(launches[name] > 0 for name, _, _ in PORTS), launches)
    table = []
    for name, source, replaces in PORTS:
        row = kernels[name]
        table.append({"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": launches[name],
                      "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                      "plain_ms": row["plain_ms"]})
    print(json.dumps({"throughput": rate}))
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
