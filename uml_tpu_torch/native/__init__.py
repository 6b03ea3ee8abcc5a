"""The native JPEG decoder of the host pipeline (uml_tpu/native/).

``fast_decode_jpeg(src, target)`` decodes a JPEG with libjpeg's IDCT
scaling, resizes its shorter side to ``target`` (Catmull-Rom bicubic) and
center-crops ``target`` x ``target``: the deterministic ``crop`` pipeline
of data/transforms.py without a full-resolution decode.
``jpeg_decoder.cpp`` is uml_tpu's source, byte for byte, so both packages
decode the same pixels.

The library is compiled with g++ at first use, never at import, into
``build/native/<hash of the source>/libuml_jpeg.so`` under the repository
root, and bound with ctypes (a plain C interface).  The build writes a
temporary file and renames it into place, so processes that build at once
never load a half-written library.  A machine without g++ or the libjpeg
headers gets ``native_available() == False`` and the callers decode with
PIL, as uml_tpu does.

This module imports numpy and the standard library only (no torch), so a
spawned decode worker stays light and never touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jpeg_decoder.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(SRC))),
                          "build", "native")
CXX_FLAGS = ["-O3", "-fPIC", "-shared"]

_lib = None
_load_error: str | None = None


def library_path() -> str:
    """Where the library of this source lives (built or not)."""
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, digest, "libuml_jpeg.so")


def build(src: str = SRC, lib_path: str | None = None) -> str:
    """Compile ``src`` into ``lib_path`` unless it exists -> the path.
    g++ writes a temporary file in the same directory, then ``os.replace``
    puts it in place in one step.  A failed compile raises
    CalledProcessError with g++'s messages."""
    lib_path = lib_path or library_path()
    if os.path.exists(lib_path):
        return lib_path
    out_dir = os.path.dirname(lib_path)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, src, "-ljpeg"],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load(lib_path: str) -> ctypes.CDLL:
    """Load a built decoder library and declare its C entry."""
    lib = ctypes.CDLL(lib_path)
    lib.uml_decode_jpeg_resize_crop.restype = ctypes.c_int
    lib.uml_decode_jpeg_resize_crop.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p]
    return lib


def _library():
    """The process's decoder, built and loaded on first call; None (with
    the reason in ``_load_error``) where g++ or libjpeg is missing."""
    global _lib, _load_error
    if _lib is None and _load_error is None:
        try:
            _lib = load(build())
        except Exception as e:  # no toolchain or no libjpeg
            _load_error = f"{type(e).__name__}: {e}"
    return _lib


def native_available() -> bool:
    return _library() is not None


def unavailable_reason() -> str | None:
    """Why the decoder cannot be used here (None where it can)."""
    _library()
    return _load_error


def decode_with(lib, src, target: int = 224) -> np.ndarray:
    """``fast_decode_jpeg`` through a given loaded library."""
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            data = f.read()
    else:
        data = bytes(src)
    out = np.empty((target, target, 3), dtype=np.uint8)
    rc = lib.uml_decode_jpeg_resize_crop(
        data, len(data), target, out.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"jpeg decode failed (rc={rc})")
    return out


def fast_decode_jpeg(src, target: int = 224) -> np.ndarray:
    """JPEG path or bytes -> uint8 [target, target, 3] (decode, resize,
    center crop).  Raises RuntimeError where the library is unavailable or
    the input is not a decodable JPEG: callers fall back to PIL."""
    lib = _library()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable ({_load_error})")
    return decode_with(lib, src, target)
