"""Exponential moving average of parameters.

Counterpart of masked_diffusion_tpu/models/ema.py: the diffusers EMAModel
warmup law the reference configures (main_train_masked.py:116-131:
use_ema_warmup=True, inv_gamma, power, max_decay): decay(step) = 1 - (1 +
step/inv_gamma)^(-power), clamped to [min_decay, max_decay], with step =
optimization_step - 1 and decay forced to 0 at the first step (so the EMA
starts as a copy of the online parameters).

The decay is a host float (the step counter lives on the host), so the
update launches no transfer; the update itself is two in-place foreach
kernels over the parameter lists, in the EMA's dtype (fp32).
"""

from __future__ import annotations

from typing import Sequence

import torch


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
    decay: float,
) -> None:
    """ema <- decay * ema + (1 - decay) * params, in place, elementwise."""
    ema_params = list(ema_params)
    params = [p.detach().to(e.dtype) for e, p in zip(ema_params, params)]
    torch._foreach_mul_(ema_params, decay)
    torch._foreach_add_(ema_params, params, alpha=1.0 - decay)
