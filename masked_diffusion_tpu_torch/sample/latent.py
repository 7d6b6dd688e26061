"""Latent initialization for the reverse process (reference sampler.py:46-99).

Counterpart of masked_diffusion_tpu/sample/latent.py. latent_initial: the
default 'data' mode inverse-CDF samples a per-image mean from the
training-set mean histogram (masked_diffusion_tpu/data/histogram.py) and
broadcasts it to a constant image. Draws come from a torch.Generator on the
CPU; the latent is moved to `device`. latent_initial_interpolation: the
interpolation sampler's grid of constant images (no draws).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def latent_initial(
    generator: torch.Generator,
    sample_num: int,
    out_channel: int,
    data_size: int,
    sample_latent_shape: str = "data",
    mean_area: str = "image-wise",
    dataset_hist: Optional[tuple] = None,
    device="cuda",
) -> torch.Tensor:
    """Constant-image latents (N, H, W, C) float32 on `device` (the card
    unless the caller names another device)."""
    mode = sample_latent_shape.lower()
    dim_sample = 1 if mean_area == "image-wise" else out_channel

    def uniform(n):
        return torch.rand((n,), generator=generator, dtype=torch.float64)

    if mode == "data":
        if dataset_hist is None or dataset_hist[0] is None:
            raise ValueError("sample_latent_shape='data' needs a dataset histogram")
        hist_shape, bin_edges, cum_sum = dataset_hist
        flat_idx = torch.searchsorted(torch.as_tensor(np.asarray(cum_sum)), uniform(sample_num))
        flat_idx = flat_idx.clamp(0, int(np.prod(hist_shape)) - 1)
        index_bin = torch.unravel_index(flat_idx, tuple(int(s) for s in hist_shape))
        means = []
        for c in range(dim_sample):
            edges = torch.as_tensor(np.asarray(bin_edges[c]), dtype=torch.float64)
            lo, hi = edges[index_bin[c]], edges[index_bin[c] + 1]
            means.append((hi - lo) * uniform(sample_num) + lo)
        sample_mean = torch.stack(means, dim=-1)
    elif mode == "zero":
        sample_mean = torch.zeros((sample_num, dim_sample))
    elif mode == "normal":
        sample_mean = torch.randn((sample_num, dim_sample), generator=generator)
    elif mode == "uniform":
        sample_mean = torch.rand((sample_num, dim_sample), generator=generator) * 2.0 - 1.0
    elif mode == "grid":
        sample_mean = torch.linspace(-1.0, 1.0, sample_num)[:, None]
    else:
        raise ValueError(f"unknown sample_latent_shape: {sample_latent_shape!r}")

    sample = sample_mean.to(torch.float32)[:, None, None, :]
    return sample.expand(sample_num, data_size, data_size, out_channel).contiguous().to(device)


def latent_initial_interpolation(
    sample_num: int,
    out_channel: int,
    data_size: int,
    interpolation_shift: float,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grid of constant images spanning [-1, 1] adjusted by the interpolation
    shift (sampler.py:86-99). Returns (latent (N, H, W, C), mu (N,)), float32
    on `device`."""
    if interpolation_shift > 0:
        grid = torch.linspace(-1.0, 1.0 - interpolation_shift, sample_num)
    elif interpolation_shift < 0:
        grid = torch.linspace(-1.0 - interpolation_shift, 1.0, sample_num)
    else:
        grid = torch.linspace(-1.0, 1.0, sample_num)
    grid = grid.to(torch.float32)
    latent = grid[:, None, None, None].expand(sample_num, data_size, data_size, out_channel)
    return latent.contiguous().to(device), grid.to(device)
