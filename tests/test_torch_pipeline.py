"""The port's host pipeline on the CPU: the decode pools, and the
feeder-structured features loop that reads each output a dispatch late.

* Loader: the spawn pool's pixels equal the thread pool's, and equal
  uml_tpu's loader with its native decoder on (built from its source into
  the test's directory, tests/test_torch_native.py::jax_native), for
  ``crop`` (native), ``flip`` and ``randomcrop`` (PIL) at a fixed seed;
  ``RawImageStream`` under ``crop`` equals uml_tpu's with native on; a
  worker killed halfway through sending a batch, or while idle, raises
  BrokenProcessPool in that iterator (never a hang) and the next iterator
  rebuilds the pool; a spawned worker imports no torch; workers decode
  natively exactly where the loader does.  Every wait on a pool is
  bounded (60 s, on a daemon thread) and the pools are shut down after
  each test.
* Loop: ``cli.features.image_features`` equals a loop that encodes batch
  by batch, bit for bit (the CPU runs the same plain PyTorch math on the
  same pixels), reading each output ``FETCH_WINDOW`` dispatches late; the
  encoder's device picks the decode workers; a decode error in the
  feeder, and an error in the main thread, re-raise within the bounded
  wait instead of hanging.
The copy stream and the ring of pinned buffers on the card:
tests/test_torch_cuda.py::test_pinned_ring_and_copy_stream.
"""

import os
import signal
import sys
import threading
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_native import jax_native, native_on, photo_jpeg  # noqa: F401
from uml_tpu.data import loader as jax_loader
from uml_tpu_torch import native
from uml_tpu_torch.cli import features as torch_features
from uml_tpu_torch.data import loader as torch_loader
from uml_tpu_torch.models import encoders
from uml_tpu_torch.models.clip import CLIP, ClipConfig

WAIT = 60
TINY_B32 = ClipConfig(embed_dim=64, image_resolution=224, vision_layers=2,
                      vision_width=128, vision_patch_size=32,
                      transformer_width=128, transformer_heads=2,
                      transformer_layers=1)


@pytest.fixture(autouse=True)
def _pools():
    torch.set_num_threads(1)
    yield
    torch_loader.shutdown_proc_pools()


def _items(root, n=13, size=(150, 200)):
    """JPEGs of smooth synthetic photos of a few sizes, and one PNG."""
    os.makedirs(root, exist_ok=True)
    items = []
    for i in range(n):
        h, w = size if i % 3 else size[::-1]
        path = os.path.join(root, f"img_{i:02d}.jpg")
        with open(path, "wb") as f:
            f.write(photo_jpeg(h + i, w, quality=80 + i))
        items.append({"impath": path, "label": i % 4})
    png = os.path.join(root, "img_png.png")
    Image.fromarray(np.full((60, 80, 3), 77, np.uint8)).save(png)
    items.append({"impath": png, "label": 0})
    return items


def _run(fn):
    """fn() on a daemon thread with a bounded wait -> its result (or its
    exception); a call still running after WAIT seconds fails the test."""
    box = {}

    def target():
        try:
            box["result"] = fn()
        except BaseException as e:  # handed to the test's thread
            box["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), f"still running after {WAIT} s"
    if "error" in box:
        raise box["error"]
    return box["result"]


def _wait_until(cond, what):
    for _ in range(WAIT * 10):
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(f"{what}: not within {WAIT} s")


def _batches(loader):
    return _run(lambda: list(loader))


@pytest.mark.parametrize("augmentation", ["crop", "flip", "randomcrop"])
def test_process_pool_pixels_equal_threads_and_uml_tpu(tmp_path, jax_native,
                                                       augmentation):
    items = _items(str(tmp_path / "img"))
    kw = dict(batch_size=4, num_workers=2, seed=3)
    thread = _batches(torch_loader.ImageBatchLoader(items, augmentation, **kw))
    proc = _batches(torch_loader.ImageBatchLoader(items, augmentation,
                                                  worker_kind="process", **kw))
    theirs = _batches(jax_loader.ImageBatchLoader(items, augmentation, **kw))
    assert len(thread) == len(proc) == len(theirs) == 4
    for (a, la, pa), (b, lb, pb), (c, lc, pc) in zip(thread, proc, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(la, lc)
        assert pa == pb == pc


def test_raw_image_stream_crop_equals_uml_tpu_native(tmp_path, jax_native):
    items = _items(str(tmp_path / "img"), n=9)
    kw = dict(batch_size=4, seed=2, num_workers=2)
    js = iter(jax_loader.RawImageStream(items, "crop", **kw))
    ts = iter(torch_loader.RawImageStream(items, "crop", **kw))
    for _ in range(4):   # 10 items, bs 4: ragged epochs
        for a, b in zip(next(js), next(ts)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("when", ["mid_send", "idle"])
def test_killed_worker_pool_is_rebuilt(tmp_path, when):
    """A worker killed halfway through sending its batch (16 images of 224
    x 224, 2.4 MB: more than a pipe holds, so with nobody reading, the
    worker sits in its send once the first bytes have arrived) raises
    BrokenProcessPool in that iterator.  A worker killed while idle
    between iterators goes unnoticed until the next iterator, which
    rebuilds the pool.  Either way the next extraction equals the first."""
    items = _items(str(tmp_path / "img"), n=64)
    kw = dict(batch_size=16, num_workers=2, prefetch=2, worker_kind="process")
    want = _batches(torch_loader.ImageBatchLoader(items, "crop", **kw))
    pool = torch_loader._PROC_POOLS[2]
    if when == "mid_send":
        it = iter(torch_loader.ImageBatchLoader(items, "crop", **kw))
        _run(lambda: next(it))   # two batches now in flight, unread
        _wait_until(lambda: any(c.poll() for c in pool.conns), "a worker sending")
        sending = next(i for i, c in enumerate(pool.conns) if c.poll())
        os.kill(pool.procs[sending].pid, signal.SIGKILL)
        with pytest.raises(BrokenProcessPool):
            _run(lambda: list(it))
        assert pool.broken
    else:
        os.kill(pool.procs[1].pid, signal.SIGKILL)
        _wait_until(lambda: not pool.alive(), "the worker dead")
    got = _batches(torch_loader.ImageBatchLoader(items, "crop", **kw))
    assert torch_loader._PROC_POOLS[2] is not pool
    assert len(got) == len(want) == 5
    for (a, _, _), (b, _, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_spawned_worker_imports_no_torch(tmp_path):
    items = _items(str(tmp_path / "img"), n=2)
    _batches(torch_loader.ImageBatchLoader(items, "crop", batch_size=2,
                                           num_workers=1, worker_kind="process"))
    pool = torch_loader._PROC_POOLS[1]
    probe = "[m in __import__('sys').modules for m in ('uml_tpu_torch.data.loader', 'torch')]"
    assert _run(lambda: pool.result(pool.submit(eval, probe))) == [True, False]
    assert "torch" in sys.modules   # this process does have it


def test_workers_decode_natively_where_the_loader_does(tmp_path, monkeypatch):
    """The loader's own probe decides for its workers, so the caches'
    ``decoder`` names what decoded: with the native decoder off in this
    process the spawned workers decode with PIL, even where they could
    load it; a worker told to decode natively that cannot, raises."""
    items = _items(str(tmp_path / "img"), n=6)
    kw = dict(batch_size=4, num_workers=2, seed=1)
    pil = _batches(torch_loader.ImageBatchLoader(items, "crop", fast_decode=False,
                                                 **kw))
    monkeypatch.setattr(native, "native_available", lambda: False)
    loader = torch_loader.ImageBatchLoader(items, "crop", worker_kind="process", **kw)
    assert loader._native is None
    for (a, _, _), (b, _, _) in zip(_batches(loader), pil):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(torch_loader, "_PROC_NATIVE", False)
    with pytest.raises(RuntimeError, match="does not load"):
        torch_loader._decode_batch_items(items[:1], 0, "crop", (224, 224), 0,
                                         use_native=True)


@pytest.fixture
def encoder(tmp_path, monkeypatch):
    """A ClipEncoder on the CPU around a tiny seeded ViT-B/32 checkpoint."""
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save(CLIP(TINY_B32).init_random(torch.Generator().manual_seed(4))
               .state_dict(), str(weights / "ViT-B-32.pt"))
    monkeypatch.setenv("UML_CLIP_WEIGHTS_DIR", str(weights))
    monkeypatch.setenv("UML_CLIP_VERIFY_SHA", "0")
    return encoders.ClipEncoder("ViT-B/32", device="cpu")


def _per_batch(encoder, items, bs=4, return_tokens=False):
    """The synchronous loop: each batch encoded and read before the next."""
    feats, labels, paths = [], [], []
    for imgs, labs, pths in torch_loader.ImageBatchLoader(items, "crop", bs,
                                                          num_workers=2):
        feats.append(encoder.encode_images(imgs, return_tokens=return_tokens))
        labels.append(labs)
        paths.extend(pths)
    return np.concatenate(feats), np.concatenate(labels), paths


@pytest.mark.parametrize("workers", ["thread", "process"])
@pytest.mark.parametrize("return_tokens", [False, True])
def test_pipelined_loop_equals_per_batch_encode(tmp_path, monkeypatch, encoder,
                                                workers, return_tokens):
    monkeypatch.setenv("UML_DECODE_WORKERS", workers)
    items = _items(str(tmp_path / "img"), n=10)
    got = _run(lambda: torch_features.image_features(
        encoder, items, "crop", 4, 2, return_tokens=return_tokens))
    want_f, want_l, want_p = _per_batch(encoder, items, return_tokens=return_tokens)
    np.testing.assert_array_equal(got["features"], want_f)
    np.testing.assert_array_equal(got["labels"], want_l)
    assert got["paths"] == want_p
    assert got["decoder"] == ("native-libjpeg" if native.native_available() else "pil")


@pytest.mark.parametrize("window, order", [
    (0, ["enc", "read"] * 3),
    (1, ["enc", "enc", "read", "enc", "read", "read"]),
    (8, ["enc"] * 3 + ["read"] * 3),
])
def test_fetch_window_reads_each_output_that_many_dispatches_late(
        tmp_path, monkeypatch, encoder, window, order):
    """FETCH_WINDOW outputs stay unread while the next forwards are
    dispatched (the default, 1: the card runs batch i while the host reads
    batch i - 1); every window gives the same features."""
    items = _items(str(tmp_path / "img"), n=10)
    want = _run(lambda: torch_features.image_features(encoder, items, "crop", 4, 2))
    events = []
    dispatch, result = encoder.encode_staged, encoders.PendingOutput.result
    monkeypatch.setattr(encoder, "encode_staged",
                        lambda *a, **k: (events.append("enc"), dispatch(*a, **k))[1])
    monkeypatch.setattr(encoders.PendingOutput, "result",
                        lambda self: (events.append("read"), result(self))[1])
    monkeypatch.setattr(torch_features, "FETCH_WINDOW", window)
    got = _run(lambda: torch_features.image_features(encoder, items, "crop", 4, 2))
    assert events == order
    np.testing.assert_array_equal(got["features"], want["features"])


@pytest.mark.parametrize("env, device, workers, kind", [
    (None, "cpu", 8, "thread"),
    (None, "cuda", 8, "process"),
    (None, "cuda", 1, "thread"),
    ("thread", "cuda", 8, "thread"),
    ("process", "cpu", 8, "process"),
])
def test_decode_workers_follow_the_encoder_device(monkeypatch, env, device,
                                                  workers, kind):
    """The spawn pool where the encoder is on the card (decode is the
    wall there) and there is more than one worker, else threads;
    UML_DECODE_WORKERS overrides."""
    if env is None:
        monkeypatch.delenv("UML_DECODE_WORKERS", raising=False)
    else:
        monkeypatch.setenv("UML_DECODE_WORKERS", env)
    seen = {}

    class Stop(Exception):
        pass

    def loader(*a, worker_kind, **k):
        seen["kind"] = worker_kind
        raise Stop

    monkeypatch.setattr(torch_features, "ImageBatchLoader", loader)
    fake = type("Encoder", (), {"device": torch.device(device)})()
    with pytest.raises(Stop):
        torch_features.image_features(fake, [], "crop", 4, workers)
    assert seen["kind"] == kind


@pytest.mark.parametrize("workers", ["thread", "process"])
def test_decode_error_reraises_without_hanging(tmp_path, monkeypatch, encoder,
                                               workers):
    monkeypatch.setenv("UML_DECODE_WORKERS", workers)
    items = _items(str(tmp_path / "img"), n=30)
    items[21] = {"impath": str(tmp_path / "missing.jpg"), "label": 0}
    with pytest.raises(FileNotFoundError):
        _run(lambda: torch_features.image_features(encoder, items, "crop", 2, 2))


def test_main_thread_error_stops_the_feeder(tmp_path, monkeypatch, encoder):
    items = _items(str(tmp_path / "img"), n=30)

    def broken(*a, **k):
        raise FloatingPointError("forward failed")

    monkeypatch.setattr(encoder, "encode_staged", broken)
    with pytest.raises(FloatingPointError):
        _run(lambda: torch_features.image_features(encoder, items, "crop", 2, 2))
