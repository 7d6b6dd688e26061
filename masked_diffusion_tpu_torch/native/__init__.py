"""Native host-preprocessing library: lazy g++ build + ctypes binding.

The port's copy of masked_diffusion_tpu/native/__init__.py (the port imports
nothing of the JAX package): the same C interface (mdt_resize_center_crop,
mdt_preprocess_batch) of the same source (preprocess.cc, a byte-for-byte
copy below its header), the same g++ flags, the same cache key (the flags
and the CPU model) and the same atomic rename into place.

The C++ pipeline replaces the Python/PIL per-image transform loop of the
dataset preload (the reference's torchvision chain, utils/mydataset.py:
64-83): a plain pixel-center bilinear resize of the short side, a center
crop and the scale to [0,1] (or [-1,1]), OpenMP over the images of a batch.
It is opt-in (MDT_NATIVE_PREPROCESS in data/datasets.py) because PIL's
resize is antialiased and the two give different numbers.

The .so is compiled on first use into build/native/ at the root of the
checkout (beside the CUDA kernels' build/kernels/), or $MDT_NATIVE_CACHE,
and reused. With MDT_DISABLE_NATIVE set, or without a toolchain, get_lib()
returns None and the loaders use PIL or numpy: the library is an
accelerator, not a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "preprocess.cc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
#: the loaded library's path
lib_path: Optional[str] = None


def _cache_dir() -> str:
    d = os.environ.get("MDT_NATIVE_CACHE") or os.path.join(_ROOT, "build", "native")
    os.makedirs(d, exist_ok=True)
    return d


_CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]


def _build() -> Optional[str]:
    # the compile flags are part of the cache key: -march=native makes the
    # binary machine-specific, so a cache dir shared across heterogeneous
    # hosts must not serve one host's build to another (SIGILL), and flag
    # changes must rebuild even though the source mtime didn't move
    import hashlib
    import platform

    cpu = platform.machine()
    try:  # -march=native binds to the exact CPU model, not just the ISA
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    cpu = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    tag = hashlib.sha256(" ".join(_CXX_FLAGS + [cpu]).encode()).hexdigest()[:12]
    so_path = os.path.join(_cache_dir(), f"libmdt_preprocess.{tag}.so")
    if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
        return so_path
    # compile to a private temp file and rename into place: concurrent
    # processes racing g++ straight onto so_path could dlopen a half-written
    # binary
    tmp_path = f"{so_path}.tmp.{os.getpid()}"
    cmd = ["g++", *_CXX_FLAGS, _SRC, "-o", tmp_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp_path, so_path)  # atomic within the cache dir
        return so_path
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp_path)
        except OSError:
            pass
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Compile-on-demand; returns None when the toolchain is unavailable."""
    global _LIB, _TRIED, lib_path
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("MDT_DISABLE_NATIVE"):
            return None
        so = _build()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mdt_resize_center_crop.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.mdt_resize_center_crop.restype = None
        lib.mdt_preprocess_batch.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, ctypes.c_int, ctypes.c_int,
        ]
        lib.mdt_preprocess_batch.restype = None
        _LIB, lib_path = lib, so
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _as_u8_hwc(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(img)


def resize_center_crop_native(
    img: np.ndarray, out_size: int, to_pm1: bool = False
) -> Optional[np.ndarray]:
    """One image; None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    img = _as_u8_hwc(img)
    h, w, c = img.shape
    dst = np.empty((out_size, out_size, c), dtype=np.float32)
    lib.mdt_resize_center_crop(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_size,
        1 if to_pm1 else 0,
    )
    return dst


def preprocess_batch_native(
    batch: np.ndarray, out_size: int, to_pm1: bool = False
) -> Optional[np.ndarray]:
    """N same-sized images (N,H,W,C) uint8; None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if batch.ndim == 3:
        batch = batch[..., None]
    if batch.dtype != np.uint8:
        batch = (np.clip(batch, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    batch = np.ascontiguousarray(batch)
    n, h, w, c = batch.shape
    dst = np.empty((n, out_size, out_size, c), dtype=np.float32)
    lib.mdt_preprocess_batch(
        batch.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_size,
        1 if to_pm1 else 0,
    )
    return dst
