"""ctypes bindings for the native C++ decode pipeline (native/adalog_data.cpp).

The port's copy of ``adalog_tpu.data.native_loader``, with its own build:
``build`` compiles the repository's ``native/adalog_data.cpp`` with g++ and
libjpeg into ``csrc/build/libadalog_data_<hash>.so`` (keyed by the hash of
the source), at first use. Where g++ or libjpeg is missing the build fails
once, quietly, and the pipeline (data/imagenet.py) decodes with PIL; which
decoder is in use is logged once. This is host-side decoding, not a device
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

log = logging.getLogger("adalog_tpu_torch")

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "adalog_data.cpp")
BUILD_DIR = os.path.join(_ROOT, "adalog_tpu_torch", "csrc", "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> str:
    """Where the library is built: the name carries the source's hash."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libadalog_data_{digest}.so")


def build() -> str:
    """Compile ``native/adalog_data.cpp`` unless its library exists; returns
    the library's path. Raises RuntimeError when the compiler fails."""
    lib = lib_path()
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-pthread", "-Wall", "-o", tmp,
           SOURCE, "-ljpeg"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                   # no g++ on the PATH
        raise RuntimeError(f"g++ not runnable: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"adalog_data.cpp: g++ failed ({proc.returncode})"
                           f":\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.adalog_decode_preprocess.restype = ctypes.c_int
    lib.adalog_decode_preprocess.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_double,
        fp, fp, fp]
    lib.adalog_preprocess_rgb8.restype = ctypes.c_int
    lib.adalog_preprocess_rgb8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, fp, fp, fp]
    lib.adalog_batch_load.restype = ctypes.c_int
    lib.adalog_batch_load.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_double, fp, fp, fp, ctypes.c_int]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None (and PIL decoding) when
    it cannot be built. Built or refused once a process."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _bind(build())
                log.info("data: decoding JPEGs with the native library %s",
                         os.path.relpath(lib_path(), _ROOT))
            except (RuntimeError, OSError) as e:
                log.info("data: native decoder unavailable (%s); decoding "
                         "with PIL", str(e).splitlines()[0])
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_preprocess(jpeg_bytes: bytes, out_size: int, crop_pct: float,
                      mean, std) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.adalog_decode_preprocess(
        jpeg_bytes, len(jpeg_bytes), out_size, crop_pct,
        _fp(mean), _fp(std), _fp(out))
    return out if rc == 0 else None


def preprocess_rgb8(rgb: np.ndarray, out_size: int, crop_pct: float,
                    mean, std) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((out_size, out_size, 3), np.float32)
    rc = lib.adalog_preprocess_rgb8(
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, out_size,
        crop_pct, _fp(mean), _fp(std), _fp(out))
    return out if rc == 0 else None


def batch_load(paths: Sequence[str], out_size: int, crop_pct: float,
               mean, std, n_threads: int = 8) -> Optional[np.ndarray]:
    """Parallel load+decode+preprocess; failed images are zero-filled."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((n, out_size, out_size, 3), np.float32)
    lib.adalog_batch_load(arr, n, out_size, crop_pct, _fp(mean), _fp(std),
                          _fp(out), n_threads)
    return out
