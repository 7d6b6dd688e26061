"""Interpolation sampler (reference sampler.py:264-366).

Counterpart of masked_diffusion_tpu/sample/interpolation.py:
make_interpolation_sample_fn. Sweeps a grid of constant-image latents across
[-1, 1] (shifted by interpolation_shift) and runs the reverse loop with a
*deterministic* shift clamped around each latent's mean and a *shared*
degradation mask across the batch, so the batch dimension becomes an
interpolation axis through data space. A Python loop over the used
timesteps, T down to 1, in the idiom of sample/loop.py; each step runs

    interpolation shift -> UNet -> inverse shift
    -> degrade(t) with the carried mask (all zero on the first step, so the
       whole image takes the mean), degrade(t-1) with a fresh shared mask
    -> update rule (base_momentum, momentum or boosting)

and, unlike the main loop, skips the last step's state update for every
rule (the reference's `if i > 0`, JAX :131-132). No kernel of the port runs
in the degrade ops (a threshold on one shared uniform field); the UNet's
GroupNorm does. The loop makes no host sync: the field's generator lives on
the device and is seeded from a CPU generator.

Data-parallel (a parallel/mesh.MeshPlan of N ranks): the grid is padded to
a multiple of N by repeating its last point (JAX :67-73), each rank samples
its rows and the result is gathered (collective) and trimmed. The shared
field's generator is NOT folded with the rank: the mask is the whole batch's,
so every rank draws the same one.

`draws=` injects the shared field: a callable step -> StepDraws whose
mask_uniform is the (1, 1, H, W) uniform field of that step (step the index
into used_timesteps), as the tests and the smoke check feed both sides the
same random numbers.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import validate_sampling_modes
from masked_diffusion_tpu_torch.ops import degrade as degrade_ops
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan, local_rows, round_up
from masked_diffusion_tpu_torch.sample.latent import latent_initial_interpolation
from masked_diffusion_tpu_torch.sample.loop import StepDraws
from masked_diffusion_tpu_torch.utils import host

#: The update rules interpolation sampling runs (JAX :46-49).
RULES = ("base_momentum", "momentum", "boosting")


def validate_interpolation_modes(cfg) -> None:
    """Raise ValueError for a rule the sampler does not run, or a mode
    coupling config.validate_sampling_modes refuses (interpolation needs
    thresholding)."""
    if cfg.momentum_adaptive not in RULES:
        raise ValueError(
            f"momentum_adaptive {cfg.momentum_adaptive!r} unsupported for interpolation sampling"
        )
    validate_sampling_modes(cfg)


def make_interpolation_sample_fn(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    used_timesteps: np.ndarray,
    interpolation_shift: float,
    *,
    device="cuda",
    plan=None,
) -> Callable:
    """Build sample(generator=None, draws=None) -> (sample_0, mu).

    sample_0: (cfg.sample_num, H, W, C) float32, mu: (cfg.sample_num,) the
    grid, both the whole batch (gathered over the plan's ranks; collective
    when there is more than one). The model moves to `device` in the compute
    dtype (bf16 when cfg.weight_dtype is bf16, else fp32); module.to() acts
    in place. generator: a CPU torch.Generator seeding the shared field
    (default: seeded with cfg.seed). draws: callable step -> StepDraws with
    mask_uniform (1, 1, H, W).
    """
    validate_interpolation_modes(cfg)
    device = torch.device(device)
    plan = plan or MeshPlan(device=device)
    rule = cfg.momentum_adaptive
    compute_dtype = torch.bfloat16 if cfg.weight_dtype == "bfloat16" else torch.float32
    model = model.to(device=device, dtype=compute_dtype).eval()
    shift_c = float(interpolation_shift)

    num = int(cfg.sample_num)
    latent, mu = latent_initial_interpolation(num, cfg.out_channel, cfg.data_size, shift_c,
                                              device=device)
    padded = round_up(num, plan.data_size)
    if padded > num:  # repeat the last grid point
        latent = torch.cat([latent, latent[-1:].expand(padded - num, *latent.shape[1:])])
        mu = torch.cat([mu, mu[-1:].expand(padded - num)])
    rows = local_rows(padded, plan)
    latent_rows = latent[rows].permute(0, 3, 1, 2).contiguous()
    mu_rows = mu[rows]

    used = np.asarray(used_timesteps, dtype=np.int64)
    n_steps = len(used)
    ts = torch.as_tensor(used, device=device)
    next_ts = torch.as_tensor(np.concatenate([used[:1], used[1:] - 1]), device=device)
    amount_next = schedule.degrade_amount(next_ts).float()  # t itself on the last step
    ratios = schedule.shift_ratio(ts)
    b = latent_rows.shape[0]
    t_rows, amn_rows, ratio_rows = (x[:, None].expand(n_steps, b).contiguous()
                                    for x in (ts.float(), amount_next, ratios))

    def sample(generator: Optional[torch.Generator] = None,
               draws: Optional[Callable[[int], StepDraws]] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.seed))
        field_gen = None
        if draws is None:  # shared by the ranks: no rank folded in
            seed = int(torch.randint(0, 2**62, (1,), generator=generator))
            field_gen = torch.Generator(device=device).manual_seed(seed)
        sample_t = latent_rows
        h, w = sample_t.shape[2:]
        with torch.inference_mode():
            mask_prev = momentum = torch.zeros_like(sample_t)
            sample_0 = sample_t
            for i in range(n_steps - 1, -1, -1):
                shift = shift_ops.schedule_shift_interpolation(
                    ratio_rows[i], mu_rows, shift_c, sample_t.shape)
                shifted = sample_t + shift
                out = model(shifted.to(compute_dtype), t_rows[i]).float()
                sample_0 = (shifted + out) - shift

                if draws is not None:
                    field = draws(i).mask_uniform
                    if field is None:
                        raise ValueError("draws give no interpolation field (mask_uniform)")
                else:
                    field = torch.rand((1, 1, h, w), generator=field_gen, device=device)
                degraded_t = degrade_ops.degrade_with_mask(sample_0, mask_prev, cfg.mean_option,
                                                           cfg.mean_area)
                degraded_next, mask_next, _ = degrade_ops.degrade_interpolation_sampling(
                    sample_0, amn_rows[i], cfg.mean_option, uniforms=field)

                difference = sample_t - degraded_t
                if rule == "base_momentum":
                    new_sample_t = degraded_next + difference
                elif rule == "momentum":
                    r = cfg.adaptive_momentum_rate
                    momentum = (1.0 - r) * momentum + r * difference
                    new_sample_t = momentum + degraded_next
                else:  # boosting (the reference's effective behaviour)
                    momentum = difference
                    new_sample_t = momentum + degraded_next
                if i > 0:  # the reference updates state only when i > 0 (sampler.py:316)
                    sample_t, mask_prev = new_sample_t, mask_next
            result = sample_0.permute(0, 2, 3, 1)
        return host.gather(result)[:num].to(device), mu[:num]

    return sample
