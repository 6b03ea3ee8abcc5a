"""The port's native JPEG decoder (uml_tpu_torch/native) against uml_tpu's.

The port keeps its own copy of ``jpeg_decoder.cpp``, byte-equal to
uml_tpu's, and builds it into ``build/native/<source hash>/``.  Its
output must equal, bit for bit, that of a library built from uml_tpu's
source into the test's own directory: no test here loads
``uml_tpu/native/libuml_jpeg.so`` or calls ``uml_tpu.native._load`` on
that shared path (``jax_native`` points uml_tpu's module at a private
library first).  The native decode is not PIL's: the two differ by
~2/255 on average (tests/test_native.py bounds the gap).
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import uml_tpu.native
from uml_tpu_torch import native
from uml_tpu_torch.data import loader as torch_loader
from uml_tpu_torch.data.transforms import load_uint8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def native_on():
    """Skip where this machine cannot build the native decoder."""
    if not native.native_available():
        pytest.skip(f"no g++/libjpeg: {native.unavailable_reason()}")


def photo_jpeg(h=375, w=500, quality=85):
    """A smooth synthetic photo as JPEG bytes (tests/test_native.py's)."""
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([
        128 + 100 * np.sin(xx / 40) * np.cos(yy / 60),
        128 + 80 * np.cos(xx / 25),
        128 + 90 * np.sin(yy / 35),
    ], -1).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture
def jax_native(native_on, monkeypatch, tmp_path):
    """uml_tpu's native decoder, built from its source into ``tmp_path``
    (never its shared library path) -> the uml_tpu.native module."""
    monkeypatch.setattr(uml_tpu.native, "_LIB", str(tmp_path / "libuml_jpeg.so"))
    monkeypatch.setattr(uml_tpu.native, "_lib", None)
    monkeypatch.setattr(uml_tpu.native, "_load_error", None)
    assert uml_tpu.native.native_available(), uml_tpu.native._load_error
    return uml_tpu.native


@pytest.fixture(scope="module")
def reference_lib(tmp_path_factory):
    """A library built from uml_tpu's source, in a directory of its own."""
    if not native.native_available():
        pytest.skip(f"no g++/libjpeg: {native.unavailable_reason()}")
    path = str(tmp_path_factory.mktemp("uml_tpu_native") / "lib.so")
    return native.load(native.build(src=uml_tpu.native._SRC, lib_path=path))


def test_source_is_byte_equal_to_uml_tpu():
    with open(native.SRC, "rb") as a, open(uml_tpu.native._SRC, "rb") as b:
        assert a.read() == b.read()


def test_library_lives_in_an_ignored_build_directory():
    path = native.library_path()
    assert path.startswith(os.path.join(ROOT, "build", "native") + os.sep)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_import_builds_nothing():
    """Importing the module (as a spawned decode worker does) neither
    builds nor loads the library, and imports no torch."""
    code = ("import sys, uml_tpu_torch.native as n, uml_tpu_torch.data.loader; "
            "print(n._lib is None and n._load_error is None, 'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.split()
    assert out == ["True", "False"]


@pytest.mark.parametrize("hw", [(224, 224), (224, 500), (500, 224), (64, 64),
                                (375, 500)])
def test_pixels_equal_uml_tpu_source(reference_lib, hw):
    jpeg = photo_jpeg(*hw)
    got = native.fast_decode_jpeg(jpeg, 224)
    assert got.shape == (224, 224, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, native.decode_with(reference_lib, jpeg, 224))


def test_pixels_equal_uml_tpu_module(jax_native, tmp_path):
    path = tmp_path / "a.jpg"
    path.write_bytes(photo_jpeg())
    np.testing.assert_array_equal(native.fast_decode_jpeg(str(path)),
                                  jax_native.fast_decode_jpeg(str(path)))


def test_garbage_raises(native_on):
    with pytest.raises(RuntimeError):
        native.fast_decode_jpeg(b"not a jpeg at all")


@pytest.mark.parametrize("worker_kind", ["thread", "process"])
def test_loader_falls_back_to_pil_per_image(native_on, tmp_path, worker_kind):
    """A PNG in a batch of JPEGs: the JPEGs decode natively, the PNG with
    PIL; a loader with another augmentation never takes the native path."""
    jpeg_path = tmp_path / "a.jpg"
    jpeg_path.write_bytes(photo_jpeg())
    png_path = tmp_path / "b.png"
    Image.fromarray(np.full((64, 48, 3), 90, np.uint8)).save(png_path)
    items = [{"impath": str(jpeg_path), "label": 0},
             {"impath": str(png_path), "label": 1}]
    loader = torch_loader.ImageBatchLoader(items, "crop", batch_size=2,
                                           num_workers=1, worker_kind=worker_kind)
    assert loader._native is not None
    try:
        imgs, labels, _ = next(iter(loader))
    finally:
        torch_loader.shutdown_proc_pools()
    assert labels.tolist() == [0, 1]
    np.testing.assert_array_equal(imgs[0], native.fast_decode_jpeg(str(jpeg_path)))
    np.testing.assert_array_equal(imgs[1], load_uint8(str(png_path)))
    assert torch_loader.ImageBatchLoader(items, "randomcrop")._native is None
    assert torch_loader.ImageBatchLoader(items, "crop", size=(224, 112))._native is None
    assert torch_loader.ImageBatchLoader(items, "crop", fast_decode=False)._native is None


def test_no_toolchain_falls_back_to_pil(tmp_path, monkeypatch):
    """Without g++ the decoder is unavailable, says why, raises on use, and
    the loader decodes with PIL."""
    monkeypatch.setattr(native, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.native_available()
    assert "g++" in native.unavailable_reason()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.fast_decode_jpeg(photo_jpeg())
    path = tmp_path / "a.jpg"
    path.write_bytes(photo_jpeg())
    loader = torch_loader.ImageBatchLoader([{"impath": str(path), "label": 0}],
                                           "crop", batch_size=1, num_workers=1)
    assert loader._native is None
    np.testing.assert_array_equal(next(iter(loader))[0][0], load_uint8(str(path)))


def test_processes_building_at_once_each_load_a_whole_library(native_on, tmp_path):
    """Four processes build one library path at once: every one loads a
    whole library and decodes, and no temporary file is left behind."""
    lib = tmp_path / "shared" / "libuml_jpeg.so"
    jpeg = tmp_path / "a.jpg"
    jpeg.write_bytes(photo_jpeg())
    code = ("import sys; from uml_tpu_torch import native; "
            "lib = native.load(native.build(lib_path=sys.argv[1])); "
            "print(native.decode_with(lib, sys.argv[2]).sum())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(lib), str(jpeg)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    want = str(native.fast_decode_jpeg(str(jpeg)).sum())
    assert [o.strip() for o, _ in outs] == [want] * 4
    assert os.listdir(lib.parent) == [lib.name]
