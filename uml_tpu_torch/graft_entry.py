"""Driver entry points of the port (the twin of ``__graft_entry__.py``).

entry()             -> (forward, example_args): the flagship's forward step,
                       CLIP ViT-B/16 image features from uint8 pixels in
                       bf16 (random weights from seed 0, 8 images from
                       seed 0), on the card unless the CPU is asked for
                       (``UML_TORCH_DEVICE=cpu``).
dryrun_multichip(n) -> one UML training step and four more legs over a
                       (data x model) mesh of ``n`` gloo processes on the
                       CPU, started the way core.meshes.launch_per_device
                       starts ranks; raises if any rank fails.

The mesh is ``(n // n_model, n_model)`` with ``n_model = 2`` when ``n`` is
even and at least 4, else 1.  Each rank runs:

(a) one adamw step of a tiny fp32 CLIP (2 layers of width 128, 32 px
    uint8 images) and a linear head, loss = image CE + 0.5 text CE over
    the global batch: the batch split over ``data``, the transformer
    weights tensor-parallel over ``model`` (parallel.apply_tp_sharding).
    The loss and the updated parameters are held to the same step run
    whole in the one process: the loss within 1e-5 relative, each
    parameter within 1e-5 of its largest entry where the reference
    gradient is at least 1e-6 of the tensor's largest, and within 2 lr
    where it is smaller (adamw scales a near-zero gradient's rounding
    noise up to lr a step: the attention's key bias, whose gradient the
    softmax cancels);
(b) the int8 (W8A8) model on the trained weights, tensor-parallel, on this
    rank's rows: finite, and equal to the model without the mesh;
(c) the fused half-block route (the kernels' plain versions on the CPU)
    of a 64 px CLIP, tensor-parallel, on this rank's rows: within 3e-4 of
    the non-fused plain-attention model on the whole batch;
(d) one MultiBench self-supervised step (the seq autoencoder, 6 -> 10
    features, zdim 10), data-parallel: the metrics of the same step run
    whole in the one process, within 1e-5 relative;
(e) generate_fewshot -> features -> finetune (``--mesh auto``: a data mesh
    over every rank) on a synthetic caltech fixture with a random-init
    ViT-B/32: the best validation accuracy in [0, 1].

``python -m uml_tpu_torch.graft_entry`` runs ``entry()``'s forward and
prints its shape, then ``dryrun_multichip`` over the visible cards (at
least 1).  Imports no JAX and nothing of uml_tpu.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASSES = 10
LR = 1e-3
TINY = dict(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128,
            vision_patch_size=16, transformer_width=128, transformer_heads=2,
            transformer_layers=2)
TINY_64PX = dict(TINY, image_resolution=64)
STEP_RTOL = 1e-5
PARAM_ATOL = 1e-5
NOISE_GRAD = 1e-6
FUSED_ATOL = 3e-4


def entry(device=None):
    """(forward, (model, images)): ``forward(model, images_uint8)`` -> the
    image features [8, 512] fp32 of CLIP ViT-B/16 in bf16 (random init,
    seed 0) on 8 uint8 images [8, 224, 224, 3] (seed 0), on ``device``
    (default: the card)."""
    from uml_tpu_torch.core.device import default_device
    from uml_tpu_torch.models.clip import build_clip

    device = torch.device(device) if device is not None else default_device()
    model = build_clip("ViT-B/16", dtype=torch.bfloat16).init_random(
        torch.Generator().manual_seed(0)).to(device).eval()

    def forward(model, images_uint8):
        with torch.no_grad():
            return model.encode_image_u8(images_uint8)

    images = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 224, 224, 3), dtype=np.uint8)).to(device)
    return forward, (model, images)


def make_caltech_fixture(root, n_classes=4, per_class=(10, 5, 6)):
    """A synthetic caltech-101 tree (8 x 8 JPEGs, one color each) and its
    split_zhou_Caltech101.json, as the datasets' registry reads them."""
    from PIL import Image

    from uml_tpu_torch.utils.io import save_as_json

    ds = os.path.join(root, "caltech-101")
    img_dir = os.path.join(ds, "101_ObjectCategories")
    split = {"train": [], "val": [], "test": []}
    for label in range(n_classes):
        cname = f"class_{label}"
        os.makedirs(os.path.join(img_dir, cname), exist_ok=True)
        counter = 0
        for part, n in zip(("train", "val", "test"), per_class):
            for _ in range(n):
                rel = f"{cname}/img_{counter:03d}.jpg"
                Image.new("RGB", (8, 8), (label * 10, counter, 0)).save(
                    os.path.join(img_dir, rel))
                split[part].append((rel, label, cname))
                counter += 1
    save_as_json(split, os.path.join(ds, "split_zhou_Caltech101.json"))
    return root


def run_fewshot_cli(root, dataset="caltech101", encoder="ViT-B/32", shot="3",
                    seed="1", alpha="0.5", text_type="hand_crafted", dirs=None,
                    random_init=True, extra_features=(), extra_finetune=()):
    """generate_fewshot -> features -> finetune on the data under ``root``
    (indices, features and experiments under it unless ``dirs`` names
    them) with ``encoder`` (random weights where none are found, with
    ``random_init``) -> finetune's (results, best_val, best_test).  In a
    multi-process job every rank runs features and finetune (``--mesh
    auto``); the splits are written by rank 0."""
    import torch.distributed as dist

    from uml_tpu_torch.cli import features as feat
    from uml_tpu_torch.cli import finetune as ft
    from uml_tpu_torch.cli import generate_fewshot as gf

    dirs = dirs or {}
    indices = dirs.get("indices", f"{root}/indices")
    if not dist.is_initialized() or dist.get_rank() == 0:
        gf.main(gf.build_parser().parse_args([
            "--data_dir", root, "--indices_dir", indices, "--dataset", dataset,
            "--train-shot", shot, "--seed", seed]))
    if dist.is_initialized():
        dist.barrier()
    common = ["--data_dir", root, "--indices_dir", indices,
              "--feature_dir", dirs.get("features", f"{root}/features"),
              "--dataset", dataset, "--clip-encoder", encoder, "--train-shot", shot,
              "--seed", seed, "--mesh", "auto",
              *(("--allow-random-init",) if random_init else ())]
    args = feat.build_parser().parse_args(
        common + ["--text-augmentation", "hand_crafted", *extra_features])
    args.overwrite, args.force_rerun = False, False
    feat.main(args)
    args = ft.build_parser().parse_args(
        common + ["--result_dir", dirs.get("experiments", f"{root}/experiments"),
                  "--text_type", text_type, "--modality", "crossmodal",
                  "--alpha", alpha, *extra_finetune])
    args.overwrite, args.force_rerun = False, False
    return ft.main(args)


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip check failed: {what}")


def _say(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(msg, flush=True)


def _whole_params(model) -> dict:
    """{name: the whole tensor} of every parameter, a tensor-parallel one
    gathered (the names it is declared under)."""
    from uml_tpu_torch.parallel.tensor_parallel import declared_name, whole

    return {declared_name(n): whole(p).detach() for n, p in model.named_parameters()}


def _leg_train_step(n, mesh):
    """(a) -> the trained tensor-parallel CLIP."""
    import torch.nn.functional as F

    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.parallel import apply_tp_sharding
    from uml_tpu_torch.parallel.data_parallel import global_mean, make_dp_train_step
    from uml_tpu_torch.parallel.tensor_parallel import _is_dtensor, split_sharded

    cfg = ClipConfig(**TINY)
    batch = 2 * n
    images = np.random.default_rng(0).integers(0, 256, (batch, 32, 32, 3), dtype=np.uint8)
    text = np.random.default_rng(1).standard_normal((batch, cfg.embed_dim)).astype(np.float32)
    img_labels = np.arange(batch) % N_CLASSES
    txt_labels = (np.arange(batch) + 1) % N_CLASSES
    head0 = (0.1 * np.random.default_rng(2).standard_normal(
        (cfg.embed_dim, N_CLASSES))).astype(np.float32)

    def build():
        clip = CLIP(cfg, torch.float32, attn_impl="reference").init_random(
            torch.Generator().manual_seed(0))
        model = torch.nn.Module()
        model.clip = clip
        model.head = torch.nn.Parameter(torch.from_numpy(head0.copy()))
        return model

    def loss_fn(model):
        def fn(images, text, img_labels, txt_labels):
            feats = model.clip.encode_image_u8(torch.as_tensor(images))
            img = F.cross_entropy(feats @ model.head, torch.as_tensor(img_labels),
                                  reduction="none")
            txt = F.cross_entropy(torch.as_tensor(text) @ model.head,
                                  torch.as_tensor(txt_labels), reduction="none")
            return global_mean(img) + 0.5 * global_mean(txt), None
        return fn

    def adamw(model):
        return torch.optim.AdamW(split_sharded(model.parameters()), lr=LR,
                                 weight_decay=1e-4)

    ref = build()
    opt = adamw(ref)
    want, _ = make_dp_train_step(loss_fn(ref), None, ref.parameters(), opt)(
        images, text, img_labels, txt_labels)
    # the text tower gets no gradient and stays as it was
    ref_grads = {k: (p.grad if p.grad is not None else torch.ones_like(p)).detach().clone()
                 for k, p in ref.named_parameters()}

    model = build()
    apply_tp_sharding(model.clip, mesh)
    opt = adamw(model)
    got, _ = make_dp_train_step(loss_fn(model), mesh, model.parameters(), opt)(
        images, text, img_labels, txt_labels)
    _check(bool(torch.isfinite(got)), ("loss", float(got)))
    _check(abs(float(got) - float(want)) <= STEP_RTOL * abs(float(want)),
           ("loss against one process", float(got), float(want)))
    shards = [p for p in model.clip.parameters() if _is_dtensor(p)]
    _check(bool(shards), "no parameter was sharded")
    whole, worst = _whole_params(model), 0.0
    for name, w in _whole_params(ref).items():
        g, d = ref_grads[name].abs(), (whole[name] - w).abs()
        noise = g < NOISE_GRAD * max(float(g.max()), 1e-30)
        bound = torch.where(noise, torch.full_like(d, 2 * LR),
                            torch.full_like(d, PARAM_ATOL * max(float(w.abs().max()), 1.0)))
        _check(bool((d <= bound).all()), ("updated parameter", name, float(d.max())))
        worst = max(worst, float(d[~noise].max()) if bool((~noise).any()) else 0.0)
    _say(f"dryrun_multichip({n}): mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
         f"loss={float(got):.4f} (one process {float(want):.4f}), {len(shards)} "
         f"tensor-parallel parameters, updated parameters within {worst:.1e} ok")
    return model.clip, images


def _leg_int8(n, mesh, trained, images):
    """(b) the int8 serving model on the trained weights over the mesh."""
    from uml_tpu_torch.core.meshes import maybe_shard_batch
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.parallel import apply_tp_sharding

    state = _whole_params(trained)
    q8 = []
    for tp in (False, True):
        model = CLIP(ClipConfig(**TINY), torch.float32, attn_impl="reference",
                     quant="int8")
        model.load_state_dict(state)
        if tp:
            apply_tp_sharding(model, mesh)
        with torch.no_grad():
            q8.append(model.encode_image_u8(torch.from_numpy(
                maybe_shard_batch(mesh, images))))
    _check(bool(torch.isfinite(q8[1]).all()), "int8 features not finite")
    _check(torch.equal(q8[0], q8[1]),
           ("int8 features over the mesh", float((q8[0] - q8[1]).abs().max())))
    _say(f"dryrun_multichip({n}): int8 extraction over the mesh ok")


def _leg_fused(n, mesh):
    """(c) the fused route's halves over TP x DP against plain attention."""
    from uml_tpu_torch.core.meshes import maybe_shard_batch
    from uml_tpu_torch.models.clip import CLIP, ClipConfig
    from uml_tpu_torch.parallel import apply_tp_sharding

    cfg = ClipConfig(**TINY_64PX)
    ref = CLIP(cfg, torch.float32, attn_impl="reference",
               ln_matmul_impl="reference").init_random(torch.Generator().manual_seed(0))
    fused = CLIP(cfg, torch.float32, attn_impl="fused", ln_matmul_impl="pallas")
    fused.load_state_dict(ref.state_dict())
    apply_tp_sharding(fused, mesh)
    images = np.random.default_rng(4).integers(0, 256, (2 * n, 64, 64, 3), dtype=np.uint8)
    with torch.no_grad():
        want = ref.encode_image_u8(torch.from_numpy(images))
        got = fused.encode_image_u8(torch.from_numpy(maybe_shard_batch(mesh, images)))
    err = float((got - maybe_shard_batch(mesh, want)).abs().max())
    _check(err < FUSED_ATOL, ("fused halves against plain attention", err))
    _say(f"dryrun_multichip({n}): fused half-blocks (plain on the CPU) over the "
         f"TPxDP mesh, max err {err:.1e} ok")


def _leg_selfsup(n, mesh):
    """(d) one MultiBench self-supervised step, data-parallel."""
    from uml_tpu_torch.models.seq_autoencoder import make_seq_uml
    from uml_tpu_torch.train.selfsup import SelfSupTrainer

    bsz, t = 2 * n, 8
    x = np.random.default_rng(2).standard_normal((bsz, t, 6)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal((bsz, t, 10)).astype(np.float32)
    lx = ly = np.full((bsz,), t, np.int64)
    metrics = []
    for m in (None, mesh):
        trainer = SelfSupTrainer(make_seq_uml(6, 10, 10), lr=1e-3, seed=0,
                                 device="cpu")
        trainer.init()
        metrics.append(trainer.train_step(*trainer.to_device(x, y, lx, ly), 1.0, 1.0,
                                          None, mode="xy", mesh=m))
    loss = float(metrics[1]["train/loss"])
    _check(bool(np.isfinite(loss)), ("seq-UML loss", loss))
    for key, want in metrics[0].items():
        got = float(metrics[1][key])
        _check(abs(got - float(want)) <= STEP_RTOL * max(abs(float(want)), 1.0),
               (key, got, float(want)))
    _say(f"dryrun_multichip({n}): seq-UML dp step loss={loss:.4f} ok")


def _leg_cli(n):
    """(e) the user-facing CLIs over --mesh auto."""
    import shutil

    import torch.distributed as dist

    box = [tempfile.mkdtemp(prefix="uml_dryrun_cli_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    root = box[0]
    if dist.get_rank() == 0:
        make_caltech_fixture(root)
    _, best_val, _ = run_fewshot_cli(root, extra_finetune=("--hyperparams", "smoke"))
    _check(0.0 <= best_val <= 1.0, ("best validation accuracy", best_val))
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(root, ignore_errors=True)
    _say(f"dryrun_multichip({n}): finetune CLI e2e over {dist.get_world_size()} "
         f"ranks (--mesh auto) val={best_val:.3f} ok")


def _rank_main(n: int) -> None:
    """One rank of ``dryrun_multichip(n)``."""
    import torch.distributed as dist

    from uml_tpu_torch.core.distributed import maybe_initialize
    from uml_tpu_torch.core.meshes import create_mesh

    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    _check(maybe_initialize() and dist.get_world_size() == n, "no process group")
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = create_mesh(n // n_model, n_model)
    try:
        trained, images = _leg_train_step(n, mesh)
        _leg_int8(n, mesh, trained, images)
        _leg_fused(n, mesh)
        _leg_selfsup(n, mesh)
        _leg_cli(n)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the legs over an ``n_devices``-rank (data x model) mesh of gloo
    processes on the CPU (module docstring); raises RuntimeError if any
    rank fails."""
    from uml_tpu_torch.core.meshes import launch_per_device

    env = {"UML_TORCH_DEVICE": "cpu", "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                                         if p)}
    code = launch_per_device(n_devices, argv=[
        sys.executable, "-c",
        f"import uml_tpu_torch.graft_entry as g; g._rank_main({int(n_devices)})"],
        env=env)
    if code != 0:
        raise RuntimeError(f"dryrun_multichip({n_devices}): a rank exited with {code}")


if __name__ == "__main__":
    from uml_tpu_torch.core.meshes import visible_cards

    fn, args = entry()
    out = fn(*args)
    print("entry forward:", tuple(out.shape), out.dtype)
    dryrun_multichip(max(visible_cards(), 1))
