"""Image normalization and grid rendering (numpy/PIL).

Replaces torchvision.utils.make_grid / save_image and the reference's
normalize helpers (utils/datautils.py:211-229, sampler.py:369-417). Arrays are
NHWC float; grids are uint8 PNGs.

A copy of masked_diffusion_tpu/utils/grids.py; the port imports nothing of
the JAX package. tests/test_torch_port_host.py holds it equal to the
original.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np


def normalize01(x: np.ndarray) -> np.ndarray:
    """Per-image min-max to [0,1] with a flat-image guard
    (datautils.normalize01 :211-222)."""
    x = np.asarray(x, dtype=np.float32)
    flat = x.reshape(x.shape[0], -1)
    mn = flat.min(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    mx = flat.max(axis=1).reshape(-1, *([1] * (x.ndim - 1)))
    rng = mx - mn
    rng = np.where(rng > 0, rng, 1.0)
    return (x - mn) / rng


def normalize01_global(x: np.ndarray) -> np.ndarray:
    """Batch-global min-max to [0,1] (datautils.normalize01_global :225-229)."""
    x = np.asarray(x, dtype=np.float32)
    mn, mx = x.min(), x.max()
    rng = (mx - mn) if mx > mn else 1.0
    return (x - mn) / rng


def make_grid(
    images: np.ndarray,
    nrow: Optional[int] = None,
    padding: int = 2,
    pad_value: float = 0.0,
) -> np.ndarray:
    """Tile NHWC images into one HWC image (torchvision make_grid layout:
    nrow = images per row)."""
    images = np.asarray(images, dtype=np.float32)
    n, h, w, c = images.shape
    if nrow is None:
        nrow = int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.full(
        (ncol * (h + padding) + padding, nrow * (w + padding) + padding, c),
        pad_value,
        dtype=np.float32,
    )
    for i in range(n):
        r, col = divmod(i, nrow)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = images[i]
    return grid


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def save_png(img01: np.ndarray, path: str) -> None:
    from PIL import Image

    arr = to_uint8(img01)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)


def save_image_grid(
    sample: np.ndarray,
    normalization: str = "global",
    dir_save: Optional[str] = None,
    file_sample: Optional[str] = None,
) -> np.ndarray:
    """Sampler._save_image_grid (sampler.py:369-387): sqrt-batch grid with
    global or per-image normalization; optionally saved to PNG."""
    sample = np.asarray(sample, dtype=np.float32)
    if normalization == "global":
        sample = normalize01_global(sample)
    elif normalization == "image":
        sample = normalize01(sample)
    grid = make_grid(sample)
    if dir_save is not None and file_sample is not None:
        save_png(grid, os.path.join(dir_save, file_sample))
    return grid


def save_multi_index_image_grid(
    sample: np.ndarray,
    nrow: Optional[int] = None,
    normalization: str = "global",
    option: Optional[str] = None,
) -> list:
    """Per-item trajectory grids (sampler.py:390-417). sample is
    (batch, timesteps, H, W, C); returns one grid per batch item."""
    grids = []
    for i in range(sample.shape[0]):
        s = sample[i][1:] if option == "skip_first" else sample[i]
        if normalization == "global":
            s = normalize01_global(s)
        elif normalization == "image":
            s = normalize01(s)
        grids.append(make_grid(s, nrow=nrow))
    return grids


def save_image_pair_grid(
    data1: np.ndarray, data2: np.ndarray, dir_save: str, file_save: str
) -> None:
    """Interleaved pair grid (sampler.py:474-484)."""
    n = data1.shape[0]
    data = np.empty((2 * n,) + data1.shape[1:], dtype=np.float32)
    data[0::2] = data1
    data[1::2] = data2
    nrow = int(math.ceil(math.sqrt(n))) * 2
    grid = make_grid(normalize01(data), nrow=nrow)
    save_png(grid, os.path.join(dir_save, file_save))
