"""Batched normalization / moment-matching helpers (utils/datautils.py).

NHWC numpy versions of the reference's torch helpers: per-image and
per-channel mean/std matchers (:168-208), min-max normalizers (:211-229, also
exported from utils/grids.py for artifact rendering), zero-mean shift and
whitening (:232-244). All reductions run over spatial (+channel) axes with
keepdims.

A copy of masked_diffusion_tpu/data/transforms.py; the port imports nothing
of the JAX package. tests/test_torch_port_host.py holds it equal to the
original.
"""

from __future__ import annotations

import numpy as np

from masked_diffusion_tpu_torch.utils.grids import normalize01, normalize01_global  # noqa: F401


def _mean_image(x):
    return x.mean(axis=(1, 2, 3), keepdims=True)


def _std_image(x):
    # torch.std uses the unbiased (ddof=1) estimator
    return x.std(axis=(1, 2, 3), keepdims=True, ddof=1)


def _mean_channel(x):
    return x.mean(axis=(1, 2), keepdims=True)


def _std_channel(x):
    return x.std(axis=(1, 2), keepdims=True, ddof=1)


def normalize_mean(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Match per-image means (datautils.normalize_mean :203-208)."""
    return source - _mean_image(source) + _mean_image(target)


def normalize_mean_channel(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Match per-channel means (datautils.normalize_mean_channel :168-174)."""
    return source - _mean_channel(source) + _mean_channel(target)


def normalize(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Whiten source per-image, then shift to target's per-image mean
    (datautils.normalize :178-187 — the reference divides by source std only,
    the target-std rescale is commented out there; preserved)."""
    return (source - _mean_image(source)) / _std_image(source) + _mean_image(target)


def normalize_channel(source: np.ndarray, target: np.ndarray) -> np.ndarray:
    """Full per-channel moment match (datautils.normalize_channel :190-200):
    source gets target's channel-wise mean AND std."""
    out = (source - _mean_channel(source)) / _std_channel(source)
    return out * _std_channel(target) + _mean_channel(target)


def make_mean_zero(data: np.ndarray) -> np.ndarray:
    """Subtract the per-image mean (datautils.make_mean_zero :232-236)."""
    return data - _mean_image(data)


def whiten(data: np.ndarray) -> np.ndarray:
    """Per-image zero-mean / unit-std (datautils.whiten :239-244)."""
    return (data - _mean_image(data)) / _std_image(data)
