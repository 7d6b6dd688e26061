"""Exponential moving average of parameters.

Counterpart of masked_diffusion_tpu/models/ema.py: the diffusers EMAModel
warmup law the reference configures (main_train_masked.py:116-131:
use_ema_warmup=True, inv_gamma, power, max_decay): decay(step) = 1 - (1 +
step/inv_gamma)^(-power), clamped to [min_decay, max_decay], with step =
optimization_step - 1 and decay forced to 0 at the first step (so the EMA
starts as a copy of the online parameters).

The decay is a host float (the step counter lives on the host) or a 0-d
tensor on the parameters' device, which the train step uses, so that a
CUDA graph of it reads each step's decay from the device; neither
launches a transfer. The update is a few in-place foreach kernels over the
parameter lists, in the EMA's dtype (fp32), 64 MiB of parameters at a time.
Under tensor parallelism (parallel/tp.py) the EMA copy holds the same
slices as the model, so the elementwise update runs on each rank's slices.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_CHUNK_BYTES = 64 << 20  # of EMA parameters an update works on at once


def ema_decay(
    optimization_step: int,
    inv_gamma: float = 1.0,
    power: float = 0.75,
    min_decay: float = 0.0,
    max_decay: float = 0.9999,
    use_warmup: bool = True,
) -> float:
    """Decay value at an optimization step (1-indexed, i.e. after increment)."""
    step = float(max(0, int(optimization_step) - 1))
    if step <= 0:
        return 0.0
    if use_warmup:
        cur = 1.0 - (1.0 + step / inv_gamma) ** (-power)
    else:
        cur = (1.0 + step) / (10.0 + step)
    return min(max(cur, min_decay), max_decay)


@torch.no_grad()
def ema_update(
    ema_params: Sequence[torch.Tensor],
    params: Sequence[torch.Tensor],
    decay: Union[float, torch.Tensor],
) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, elementwise.
    decay: a float, or a 0-d tensor on the parameters' device."""
    ema_params = list(ema_params)
    params = [p.detach().to(e.dtype) for e, p in zip(ema_params, params)]
    keep = 1.0 - decay
    # (1 - decay) * params is made a chunk of parameters at a time, so its
    # temporary stays near _CHUNK_BYTES, not the model's size
    for part in _chunks(ema_params, _CHUNK_BYTES):
        torch._foreach_mul_(ema_params[part], decay)
        torch._foreach_add_(ema_params[part], torch._foreach_mul(params[part], keep))


def _chunks(tensors: Sequence[torch.Tensor], limit: int):
    """Slices of consecutive tensors of at most `limit` bytes together (a
    larger tensor alone)."""
    start = size = 0
    for i, t in enumerate(tensors):
        n = t.numel() * t.element_size()
        if i > start and size + n > limit:
            yield slice(start, i)
            start, size = i, 0
        size += n
    if start < len(tensors):
        yield slice(start, len(tensors))
