"""Image conversion + debug probes (reference utils/util.py:14-117).

tensor2im        : NHWC float batch -> one uint8 grid image (util.py:14-44's
                   auto-grid + [0,1]->[0,255] conversion).
save_image       : uint8 array -> PNG on disk with optional resize
                   (util.py:66-81).
diagnose_network : mean absolute gradient/param probe — the reference walks
                   module.parameters() and averages |grad| (util.py:47-63);
                   here it reduces an nn.Module's parameters, or a dict or
                   iterable of tensors or arrays, to the same number.
make_multi_grid  : list of batches -> row-major grid of grids
                   (util.py:100-117).

A copy of masked_diffusion_tpu/utils/imaging.py (diagnose_network walks
torch containers where the original walks a JAX pytree); the port imports
nothing of the JAX package. tests/test_torch_port_host.py holds it equal to
the original.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np

from masked_diffusion_tpu_torch.utils.grids import make_grid, normalize01_global, to_uint8


def tensor2im(batch: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Batch (N,H,W,C) float -> uint8 HWC grid (grayscale stays 1-channel)."""
    batch = np.asarray(batch, dtype=np.float32)
    if batch.ndim == 3:
        batch = batch[None]
    grid = make_grid(normalize01_global(batch) if normalize else batch)
    return to_uint8(grid)


def save_image(image_numpy: np.ndarray, image_path: str, size: Optional[int] = None) -> None:
    """uint8 HWC (or HW) -> PNG, optional square resize (util.py:66-81)."""
    from PIL import Image

    arr = np.asarray(image_numpy)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    pil = Image.fromarray(arr)
    if size is not None:
        pil = pil.resize((size, size), Image.BILINEAR)
    os.makedirs(os.path.dirname(image_path) or ".", exist_ok=True)
    pil.save(image_path)


def _leaves(tree):
    """The arrays of a module, a (nested) dict or an iterable, in order."""
    import torch

    if isinstance(tree, torch.nn.Module):
        tree = tree.parameters()
    if isinstance(tree, torch.Tensor):
        yield tree.detach().float().cpu().numpy()
    elif hasattr(tree, "shape"):
        yield np.asarray(tree)
    elif isinstance(tree, dict):
        for key in sorted(tree):  # the order of jax.tree.leaves
            yield from _leaves(tree[key])
    elif hasattr(tree, "__iter__") and not isinstance(tree, (str, bytes)):
        for item in tree:
            yield from _leaves(item)


def diagnose_network(tree, name: str = "network") -> float:
    """Mean of per-leaf mean |value| over a module's parameters or a
    container of tensors (grads or params) — the util.py:47-63 probe,
    printed and returned."""
    leaves = list(_leaves(tree))
    if not leaves:
        mean = 0.0
    else:
        mean = float(np.mean([np.abs(leaf).mean() for leaf in leaves]))
    print(name)
    print(mean)
    return mean


def make_multi_grid(
    batches: Sequence[np.ndarray], nrow: Optional[int] = None, padding: int = 2
) -> np.ndarray:
    """Tile several same-shaped batch-grids into one canvas (util.py:100-117):
    each inner batch becomes a sqrt-grid; the outer layout is row-major with
    `nrow` grids per row."""
    grids = [make_grid(np.asarray(b, dtype=np.float32), padding=padding) for b in batches]
    h = max(g.shape[0] for g in grids)
    w = max(g.shape[1] for g in grids)
    c = grids[0].shape[-1]
    n = len(grids)
    if nrow is None:
        nrow = int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    canvas = np.zeros((ncol * h, nrow * w, c), dtype=np.float32)
    for i, g in enumerate(grids):
        r, col = divmod(i, nrow)
        canvas[r * h : r * h + g.shape[0], col * w : col * w + g.shape[1]] = g
    return canvas
