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
4. the kernel table as one JSON line, the device line last.

The script needs nothing of JAX.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
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
]

# Kernel vs plain version, bf16 on the card.  Both compute the same math
# with fp32 accumulation; they differ in summation order, so an
# intermediate (qkv, probabilities, hidden, residual) can round to the
# neighbouring bf16 value (2^-8 relative) and carry that into the output.
# The bound is on max|kernel - plain| / max|plain|: 1/64 (4 bf16 ulps of
# the largest output) for one half-block, 1/16 for the 12-layer tower,
# where such flips compound through 24 residual roundings.
REL_BOUND = {"attn_block": 1 / 64, "attn_block_cls": 1 / 64,
             "mlp_block": 1 / 64, "attn_block_causal": 1 / 64,
             "text_tower": 1 / 16}
# card vs CPU plain path on the same random-init ViT-B/16 (bf16 both):
# per-row cosine of the features
MIN_COSINE = 0.999


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
    ]
    results = {}
    for name, kernel_fn, plain_fn in cases:
        got = kernel_fn()
        want = plain_fn()
        torch.cuda.synchronize()
        _check(got.shape == want.shape, (name, got.shape, want.shape))
        _check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ms = _time_ms(kernel_fn)
        plain_ms = _time_ms(plain_fn)
        print(f"[kernels] {name:18s} shape {tuple(got.shape)} max_abs_err "
              f"{err:.5f} max_rel_err {err / scale:.5f} (bound "
              f"{REL_BOUND[name]:.5f}) kernel {ms:.4f} ms plain "
              f"{plain_ms:.4f} ms")
        _check(err <= REL_BOUND[name] * scale, f"{name}: {err} > bound")
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
    return launches, rate


def _profile(what, fn, reps=3):
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
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t, _ in rows)
    print(f"[profile] {what}: device busy {busy / reps / 1e3:.3f} ms per call, "
          f"{100 * busy / wall_us:.1f}% of {wall_us / reps / 1e3:.3f} ms wall")
    for key, t, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"[profile]   {100 * t / busy:5.1f}%  {t / reps / 1e3:8.3f} ms  "
              f"x{count // reps:<4d} {key[:90]}")


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
    launches, rate = phase_main_path()
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
