"""Feature-extraction CLI (CLIP and DINO / DINOv2 encoders).

The port of uml_tpu/cli/features.py (flag/behavior parity with the
reference's vision_language/features.py): extracts and caches frozen-CLIP
features — train/val/test image features, per-class template text
features, CUPL descriptor features — into the reference's ``.pth`` path
scheme and schema (features.py:32-44, 96-103, 143-149, 180-184), with
idempotent skip-unless-overwrite semantics.

Pipeline, as uml_tpu's: JPEG decode (the native libjpeg decoder for
``crop``, else PIL; in the spawn pool when the encoder is on the card,
else in threads; ``UML_DECODE_WORKERS`` overrides) -> uint8 batch -> a
feeder thread copies it to the card on a stream of its own, from reused
pinned buffers -> the forward (bf16, hand-written kernels on the card) ->
a copy back into pinned memory, read one dispatch later.  The CLIP towers
are ViT-B/16, ViT-B/32 and RN50 / RN101 (``--clip-encoder``, default
RN50: convolutions through cuDNN, the text tower through the text_tower
kernel).  ``--quant int8|int8_mlp|int8_attn|int8_qkv`` serves the ViT
towers in int8 (W8A8: ops.quant, ops.tower_q8 under ``UML_TOWER_Q8=1``);
the last image layer stays bf16, and the RN models ignore the mode, as in
uml_tpu.  The encoder runs on the card; ``UML_TORCH_DEVICE=cpu`` asks for
the CPU (the kernels' plain PyTorch versions).

``--vision_model`` (a DINO / DINOv2 config of models/dino.py) takes the
image side, with ``--quant none|int8``, and ``--language_model`` the text
side (uml_tpu's ``_HFEncoderAdapter``); the caches are named after them.
The language model (models/languagemodel.py: BERT / RoBERTa by their CLS
row, GPT-2 and the other decoders by the masked mean, LLaMA / Mistral
through the port's LlamaEncoder) loads from local files only and runs on
the encoder's device in fp32; any ``--quant int8*`` makes the LLaMA
projections weight-only int8 (``int8_w``).  Without the files it raises
the load error, or under ``--allow_random_init`` writes hash-random text
features, as uml_tpu does on such a machine.

    python -m uml_tpu_torch.cli.features -d --dataset caltech101 \\
        --allow-random-init ...                          # RN50
    python -m uml_tpu_torch.cli.features -d --dataset caltech101 \\
        --clip-encoder ViT-B/16 --allow-random-init [--quant int8] ...
    python -m uml_tpu_torch.cli.features -d --dataset caltech101 \\
        --vision_model vit_base_patch14_dinov2.lvd142m \\
        --language_model bert-base-uncased --allow-random-init ...
    python -m uml_tpu_torch.cli.features -d --dataset caltech101 \\
        --vision_model vit_base_patch14_dinov2.lvd142m \\
        --language_model /path/to/open_llama_7b --quant int8 ...
    python -m uml_tpu_torch.cli.features -c configs/features.yaml

``--mesh auto`` (the default) run from the command line on a machine with
several cards starts one process per card (core.meshes.launch_per_card;
under torchrun or Slurm the launcher's processes join instead); ``main``
called from Python takes the job it runs in (core.meshes.mesh_from_flag).  The ranks split the work by loader
batch and by class, round robin: each rank decodes and encodes only its
own batches (their augmentation RNG is seeded by the batch index, so the
pixels are those of a one-process run), and rank 0 assembles every result
in order and alone writes the caches.  With one card there is no process
group and the run is the one-process run.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from uml_tpu_torch.core.device import default_device
from uml_tpu_torch.core.flags import build_shared_parser
from uml_tpu_torch.core.distributed import is_primary
from uml_tpu_torch.core.meshes import agree, data_rank, data_size, mesh_from_flag
from uml_tpu_torch.core.sweep import run_sweep_cli
from uml_tpu_torch.data.descriptors import (
    DESCRIPTOR_DICT,
    descriptor_path as default_descriptor_path,
    load_gpt_descriptions,
)
from uml_tpu_torch.data.feature_cache import (
    descriptor_outdir,
    img_outdir,
    save_cache,
    text_outdir,
)
from uml_tpu_torch.data.fewshot import get_few_shot_benchmark, get_testset
from uml_tpu_torch.data.loader import ImageBatchLoader
from uml_tpu_torch.data.templates import get_templates
from uml_tpu_torch.models.encoders import ClipEncoder, PendingOutput
from uml_tpu_torch.parallel.data_parallel import gather_in_order, owns
from uml_tpu_torch.utils.io import makedirs
from uml_tpu_torch.utils.seeding import cname2lab, set_random_seed

IMAGENET_TESTSETS = ["imagenetv2", "imagenet_sketch", "imagenet_a", "imagenet_r"]


def build_parser() -> argparse.ArgumentParser:
    return build_shared_parser()


# ---------------------------------------------------------------------------
# extraction passes
# ---------------------------------------------------------------------------


# a forward's output is read one dispatch later: the card runs batch i
# while the host reads batch i - 1 (tools/exp_torch_fetch_window.py times
# other windows)
FETCH_WINDOW = 1


def image_features(encoder, items, augmentation, batch_size, num_workers,
                   return_tokens=False, seed=0, mesh=None):
    """{'features','labels','paths','decoder'} over a split
    (features.py:152-184), pipelined as uml_tpu's loop is
    (uml_tpu/cli/features.py:72-180).

    A feeder thread owns the decode iteration and the staging
    (``encoder.stage_images``: the copy to the device on its own stream);
    a queue of at most 3 staged batches bounds what waits on the device.
    The main thread dispatches each forward (``encode_staged``), starts
    its copy back into pinned memory (PendingOutput) and reads the output
    ``FETCH_WINDOW`` dispatches later.  The feeder puts its terminal None
    in a ``finally``, so a decode error reaches the main thread, which
    re-raises it; an error in the main thread stops the feeder.

    Decode runs in the spawn pool (data/loader.py) when the encoder is on
    the card and there is more than one worker: there decode is the wall,
    and decode threads share the GIL with the feeder and the main thread
    (PERF.md: 1.6-1.8x on the card's host); in threads otherwise.
    ``UML_DECODE_WORKERS=thread|process`` overrides, as in uml_tpu.  The
    pool keeps ``max(4, num_workers)`` batches in flight.

    With a ``mesh`` this rank runs the batches whose index is its rank
    modulo the data axis, and rank 0 gets every batch in order (None on
    the other ranks)."""
    import queue
    import threading
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    kind = os.environ.get("UML_DECODE_WORKERS") or (
        "process" if encoder.device.type == "cuda" and num_workers > 1
        else "thread")
    # a worker decodes a whole batch: the prefetch window must cover the
    # workers or some sit idle (bench.py sizes it so as well)
    loader = ImageBatchLoader(items, augmentation, batch_size,
                              worker_kind=kind, num_workers=num_workers,
                              prefetch=max(4, num_workers), seed=seed,
                              shard=(None if mesh is None
                                     else (data_rank(mesh), data_size(mesh))))
    # provenance: the native decode differs pixel-wise from PIL (~2/255
    # on average); the cache records which one ran
    decoder = "native-libjpeg" if loader._native is not None else "pil"
    batches = []  # (features, labels, paths) of each batch, in order
    pending = deque()

    def drain(window):
        while len(pending) > window:
            out, labs, pths = pending.popleft()
            batches.append((out.result(), labs, pths))

    staged_q = queue.Queue(maxsize=3)
    stop = threading.Event()

    def feed():
        try:
            for imgs, labs, pths in loader:
                if stop.is_set():
                    break
                staged_q.put((encoder.stage_images(imgs), labs, pths))
        finally:
            staged_q.put(None)

    with ThreadPoolExecutor(max_workers=1) as feeder:
        feed_fut = feeder.submit(feed)
        try:
            i = 0
            while True:
                entry = staged_q.get()
                if entry is None:
                    feed_fut.result()  # re-raises a decode error
                    break
                (batch, n), labs, pths = entry
                out, n = encoder.encode_staged(batch, n,
                                               return_tokens=return_tokens)
                if return_tokens and i == 0:
                    print("Shape of image patch embeddings:", (n, *out.shape[1:]))
                pending.append((PendingOutput(out, n), labs, pths))
                drain(FETCH_WINDOW)
                i += 1
                if i % 20 == 0:
                    print(f"   ... {i}/{len(loader)} batches")
        finally:
            # on an error here, let the feeder finish: it may be blocked
            # on a full queue
            stop.set()
            while not feed_fut.done():
                try:
                    staged_q.get(timeout=0.1)
                except queue.Empty:
                    pass
    drain(0)
    batches = gather_in_order(mesh, batches)
    if batches is None:
        return None
    return {
        "features": np.concatenate([b[0] for b in batches], axis=0),
        "labels": np.concatenate([b[1] for b in batches], axis=0),
        "paths": [p for b in batches for p in b[2]],
        "decoder": decoder,
    }


def text_features(encoder, dsname, lab2cname, augmentation,
                  return_tokens=False, mesh=None):
    """Per-class template prompt features (features.py:107-149).  With a
    ``mesh`` the classes go round robin over the ranks and rank 0 gets
    them all in order (None on the other ranks)."""
    templates = get_templates(dsname, augmentation)
    # the dataset's class order comes from a set: rank 0's is everyone's
    classes = agree(mesh, list(lab2cname.items()))
    encoded, prompts_dict = [], {}
    for i, (label, cname) in enumerate(classes):
        text_prompts = [t.format(cname.replace("_", " ")) for t in templates]
        prompts_dict[label] = text_prompts
        if owns(mesh, i):
            encoded.append(encoder.encode_texts(text_prompts,
                                                return_tokens=return_tokens))
    encoded = gather_in_order(mesh, encoded)
    if encoded is None:
        return None
    feats = [out for out, _ in encoded]
    eots = [indices for _, indices in encoded]
    labels = [np.full(len(templates), label, dtype=np.int64) for label, _ in classes]
    return {
        "features": np.concatenate(feats, axis=0),
        "labels": np.concatenate(labels, axis=0),
        "eot_indices": np.concatenate(eots, axis=0),
        "prompts": prompts_dict,
        "lab2cname": lab2cname,
    }


def descriptor_features(encoder, descriptors, lab2cname, return_tokens=False,
                        mesh=None):
    """Per-class CUPL descriptor features (features.py:54-103); a ``mesh``
    splits the classes as ``text_features`` does."""
    cname2lab_dict = cname2lab(lab2cname)
    matched = []  # (label, descriptions) of the classes the dataset has
    for cls, descriptions in descriptors.items():
        key = cls.replace(" ", "_").lower()
        if key not in cname2lab_dict:
            print(f"[!!!] Class not found in lab2cname dict corresponding to {cls}")
            continue
        matched.append((cname2lab_dict[key], descriptions))
    if not matched:
        raise ValueError(
            "No descriptor class matched the dataset's classnames — the "
            "descriptor JSON and the benchmark's lab2cname are disjoint "
            "(wrong dataset, or a custom/synthetic class list)."
        )
    encoded = gather_in_order(mesh, [
        encoder.encode_texts(descriptions, return_tokens=return_tokens)
        for i, (_, descriptions) in enumerate(matched) if owns(mesh, i)])
    if encoded is None:
        return None
    feats = [out for out, _ in encoded]
    eots = [indices for _, indices in encoded]
    labels = [np.full(len(d), label, dtype=np.int64) for label, d in matched]
    prompts_dict = dict(matched)
    return {
        "features": np.concatenate(feats, axis=0),
        "labels": np.concatenate(labels, axis=0),
        "eot_indices": np.concatenate(eots, axis=0),
        "prompts": prompts_dict,
        "lab2cname": lab2cname,
        "cname2lab": cname2lab_dict,
    }


# ---------------------------------------------------------------------------
# prepare_* (idempotent cache writers)
# ---------------------------------------------------------------------------


def _should_write(path: str, overwrite: bool, what: str, mesh=None) -> bool:
    """Whether to (re)write a cache: rank 0's answer on every rank."""
    return agree(mesh, _should_write_here(path, overwrite, what)
                 if is_primary() else None)


def _should_write_here(path: str, overwrite: bool, what: str) -> bool:
    if overwrite or not os.path.exists(path):
        reason = "overwrite is set to True" if overwrite else "it does not exist"
        print(f"=> Saving {what} to {path} because {reason}")
        return True
    print(f"=> {what} already saved at {path} and overwrite is set to False")
    return False


def prepare_image_features(encoder, args, ds, mode="train"):
    encoder_name = args.clip_encoder if args.use_clip else args.vision_model
    path = img_outdir(args.feature_dir, encoder_name, args.dataset,
                      args.image_augmentation, args.train_shot, args.seed,
                      mode, args.return_tokens)
    makedirs(os.path.dirname(path))
    mesh = getattr(args, "mesh_obj", None)
    if not _should_write(path, args.overwrite, "image features", mesh):
        return
    if mode == "train":
        features = {
            split: image_features(encoder, ds[split], args.image_augmentation,
                                  args.batch_size, args.num_workers,
                                  args.return_tokens, args.seed, mesh)
            for split in ("train", "val")
        }
        if features["train"] is None:
            return
    else:
        features = image_features(encoder, ds["test"], "crop",
                                  args.batch_size, args.num_workers,
                                  args.return_tokens, args.seed, mesh)
        if features is None:
            return
    features["lab2cname"] = ds.get("lab2cname")
    save_cache(features, path)


def prepare_text_features(encoder, args, ds):
    text_encoder_name = args.clip_encoder if args.use_clip else args.language_model
    mesh = getattr(args, "mesh_obj", None)

    if args.descriptor_type is not None:
        dpath = descriptor_outdir(args.feature_dir, text_encoder_name,
                                  args.dataset, args.descriptor_type,
                                  args.return_tokens)
        if _should_write(dpath, args.overwrite, "descriptor features", mesh):
            hparams = dict(DESCRIPTOR_DICT[args.descriptor_type])
            fname = os.path.join(args.description_dir, hparams["dirname"],
                                 f"descriptors_{args.dataset}.json")
            if not os.path.exists(fname):
                # fall back to the vendored asset descriptors
                fname = default_descriptor_path(args.descriptor_type, args.dataset)
            hparams["fname"] = fname
            hparams["dsname"] = args.dataset
            descriptions, _ = load_gpt_descriptions(hparams)
            features = descriptor_features(encoder, descriptions,
                                           ds["lab2cname"], args.return_tokens,
                                           mesh)
            if features is not None:
                save_cache(features, dpath)

    path = text_outdir(args.feature_dir, text_encoder_name, args.dataset,
                       args.text_augmentation, args.return_tokens)
    makedirs(os.path.dirname(path))
    if _should_write(path, args.overwrite, "text features", mesh):
        features = text_features(encoder, args.dataset, ds["lab2cname"],
                                 args.text_augmentation, args.return_tokens,
                                 mesh)
        if features is not None:
            save_cache(features, path)


class _RandomTextEncoder:
    """Deterministic hash-random text features for smoke tests when no HF
    weights are cached (uml_tpu/cli/features.py:326-341; ``hash`` of a str
    varies between processes unless PYTHONHASHSEED is set)."""

    hidden_size = 768

    def encode(self, texts, return_tokens=False):
        feats = np.stack([
            np.random.default_rng(abs(hash(t)) % (2**32))
            .standard_normal(self.hidden_size).astype(np.float32)
            for t in texts
        ])
        indices = np.asarray([len(t) for t in texts])
        if return_tokens:
            return feats[:, None, :], np.ones(len(texts), np.int64)
        return feats, indices


class _HFEncoderAdapter(ClipEncoder):
    """(DINO / DINOv2 vision, HF language model) pair behind ClipEncoder's
    API (``stage_images``, ``encode_staged``, ``encode_images``,
    ``encode_texts``), ``model`` the
    DinoViT.  Images take the CLIP normalization, folded into the patch
    embedding, as on the CLIP path (uml_tpu/cli/features.py:344-442).
    ``text_model`` is a TextModel on the same device (any int8 ``quant``
    -> its weight-only ``int8_w``), or hash-random features under
    ``allow_random_init`` when it cannot load."""

    def __init__(self, vision_model: str = "", language_model: str = "",
                 allow_random_init: bool = False, device=None,
                 check_finite: bool = False, quant: str = "none"):
        from uml_tpu_torch.models.languagemodel import TextModel

        self.device = torch.device(device) if device is not None else default_device()
        self.check_finite = check_finite
        self._ring = None
        self.name = vision_model
        self.text_model = None
        self.model = None
        if language_model:
            try:
                self.text_model = TextModel(
                    language_model, device=self.device,
                    quant="int8_w" if quant.startswith("int8") else "none")
            except Exception as e:
                if not allow_random_init:
                    raise
                print(f"=> [random-init] text encoder for {language_model} "
                      f"({type(e).__name__}); features are hash-random")
                self.text_model = _RandomTextEncoder()
        if vision_model:
            from uml_tpu_torch.models.dino import load_dino

            self.model = load_dino(vision_model, allow_random_init=allow_random_init,
                                   quant=quant).to(self.device).eval()

    def encode_texts(self, texts, return_tokens=False):
        if self.text_model is None:
            raise RuntimeError("no language model configured (--language_model)")
        return self.text_model.encode(texts, return_tokens=return_tokens)

    def stage_images(self, imgs_uint8: np.ndarray):
        if self.model is None:
            raise RuntimeError("no vision model configured (--vision_model)")
        return super().stage_images(imgs_uint8)


def check_ported(args) -> None:
    """uml_tpu's early refusal of a mixed int8 mode with a non-CLIP tower
    (features.py:452-457)."""
    quant = getattr(args, "quant", "none")
    if args.vision_model and quant not in ("none", "int8"):
        raise SystemExit(
            f"--quant {quant}: the mixed int8 modes (int8_mlp/int8_attn/"
            f"int8_qkv) are CLIP-tower serving modes; "
            f"{args.vision_model} supports --quant none|int8")


def main(args):
    """Run the extraction; returns the encoder it used."""
    check_ported(args)
    args.mesh_obj = mesh_from_flag(args.mesh)
    if args.mesh_obj is not None:
        print(f"=> Extraction over {data_size(args.mesh_obj)} ranks")
    if args.seed >= 0:
        print(f"Setting fixed seed: {args.seed}")
        set_random_seed(args.seed)

    if args.dataset not in IMAGENET_TESTSETS:
        datasets = get_few_shot_benchmark(args.data_dir, args.indices_dir,
                                          args.dataset, args.train_shot, args.seed)
        print(f"=> Dataset sizes: train: {len(datasets['train'])}, "
              f"val: {len(datasets['val'])}, test: {len(datasets['test'])}")
    else:
        datasets = get_testset(args.dataset, args.data_dir)

    args.use_clip = args.vision_model == "" and args.language_model == ""
    if args.use_clip:
        print("=> Using CLIP model")
        encoder = ClipEncoder(args.clip_encoder,
                              allow_random_init=args.allow_random_init,
                              check_finite=args.debug_nans, quant=args.quant)
    else:
        print(f"=> Using {args.vision_model} for vision and "
              f"{args.language_model} for language")
        encoder = _HFEncoderAdapter(args.vision_model, args.language_model,
                                    allow_random_init=args.allow_random_init,
                                    check_finite=args.debug_nans,
                                    quant=args.quant)
    print(f"=> Encoder on {encoder.device}, quant {args.quant}")

    if args.dataset not in IMAGENET_TESTSETS:
        prepare_image_features(encoder, args, datasets, mode="train")
        prepare_image_features(encoder, args, datasets, mode="test")
        prepare_text_features(encoder, args, datasets)
    else:
        print(f"=> Saving ImageNet testset: {args.dataset}, "
              "only preparing image features")
        prepare_image_features(encoder, args, {"test": datasets}, mode="test")
    print("Done!")
    return encoder


if __name__ == "__main__":
    run_sweep_cli(main, build_parser(), description="Feature Extraction",
                  default_config="features.yaml")
