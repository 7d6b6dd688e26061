"""Data-mean histogram for the 'data' latent initialization.

Mirrors main_train_masked.py:60-87: compute per-image means (image-wise, Nx1)
or per-channel means (channel-wise, NxC), histogram them with
bins=sample_num (density), ravel, renormalize to a probability vector, and
cumsum — the sampler then inverse-CDF samples initial constant-image means
from it (sampler.py:46-69).

A copy of masked_diffusion_tpu/data/histogram.py; the port imports nothing
of the JAX package. tests/test_torch_port_host.py holds it equal to the
original.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def compute_mean_histogram(
    data: np.ndarray,
    bins: int,
    mean_area: str = "image-wise",
) -> Tuple:
    """data: NHWC float array. Returns (hist_shape, bin_edges, cum_sum) or
    (None, None, None) when not needed (matching get_dataset's data_hist)."""
    if mean_area == "channel-wise":
        means = data.mean(axis=(1, 2))  # (N, C)
    elif mean_area == "image-wise":
        means = data.mean(axis=(1, 2, 3))[:, None]  # (N, 1)
    else:
        raise ValueError(f"unknown mean_area: {mean_area!r}")

    hist, bin_edges = np.histogramdd(means, bins=bins, density=True)
    hist_shape = hist.shape
    flat = hist.ravel()
    total = flat.sum()
    if total > 0:
        flat = flat / total
    cum_sum = np.cumsum(flat)
    return hist_shape, [np.asarray(e) for e in bin_edges], cum_sum


def empty_histogram() -> Tuple:
    """The reference's placeholder when sample_latent_shape != 'data'
    (main_train_masked.py:82-87)."""
    return None, None, None
