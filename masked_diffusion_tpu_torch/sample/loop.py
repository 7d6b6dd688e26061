"""Reverse-process sampler: a Python loop over the used timesteps, T down to 1.

Counterpart of masked_diffusion_tpu/sample/loop.py:make_sample_fn on its
fused-kernel branch (loop.py:267-290). Each step runs

    shift -> UNet -> inverse shift -> fused degrade(t), degrade(t-1) + update

with the last step's state update skipped (the reference's `if i > 0`
guard, loop.py:288). The degrade pair and the update are one kernel launch
(ops/fused_degrade.py); the UNet's norms go through the GroupNorm kernel.

Covered modes are those the JAX package's fused gate admits
(_use_fused_degrade, loop.py:56-108): independent mask dependency,
base_momentum or base_sampling, 1-channel masks, and a const or image-wise
degraded_area mean. Any other mode raises NotImplementedError naming it;
nothing takes another path quietly.

State is NCHW on `device`; the latent in and the sample out are NHWC, the
JAX package's layout. The loop makes no host sync: schedule amounts live on
the device, the kernel's Philox seed and the shift generator's seed come
from a CPU torch.Generator.

Data-parallel (a parallel/mesh.MeshPlan; one rank when none is given): the
latent holds this rank's rows of the global batch; the fused step goes
through fused_degrade_update_sharded (the rank's rows, its Philox seed
folded with the rank, as JAX loop.py:274-285; rank 0's seed is the one
drawn) and the shift generator's seed is folded with the rank too, so
local image i on two ranks draws differently.

`draws=` is the one injection point: a callable step -> StepDraws giving the
bits for t and t-1 and the shift draws of that step, so the tests and the
smoke check can feed both sides the same random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import parse_mean_option, validate_sampling_modes
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.fused_degrade import fused_degrade_update_sharded
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.ops.shard import fold_seed
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan


@dataclasses.dataclass
class StepDraws:
    """One step's random numbers. bits: int64 (2, B, H*W) uint32 values (t,
    then t-1); uniform/normal: the shift draws of ops/shift.draw_shapes."""

    bits: torch.Tensor
    uniform: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None


def fused_mode(cfg):
    """The fused kernel's (mean_mode, mean_value) for cfg; raises
    NotImplementedError naming any mode the port does not cover yet."""
    dependency = cfg.sampling_mask_dependency
    rule = cfg.momentum_adaptive
    if dependency not in ("independent", "dependent_prev", "dependent_t"):
        raise ValueError(f"unknown sampling_mask_dependency: {dependency!r}")
    if rule not in ("base_sampling", "base_momentum", "momentum", "boosting"):
        raise ValueError(f"unknown momentum_adaptive: {rule!r}")
    validate_sampling_modes(cfg)
    mean_mode, mean_value = parse_mean_option(cfg.mean_option)
    unported = []
    if cfg.capture_trajectory:
        unported.append("capture_trajectory")
    if int(getattr(cfg, "encoder_reuse", 0) or 0) > 1:
        unported.append(f"encoder_reuse={cfg.encoder_reuse}")
    if dependency != "independent":
        unported.append(f"sampling_mask_dependency={dependency}")
    if rule not in ("base_momentum", "base_sampling"):
        unported.append(f"momentum_adaptive={rule}")
    if cfg.degrade_channel != "1-channel":
        unported.append(f"degrade_channel={cfg.degrade_channel}")
    if mean_mode not in ("const", "degraded_area"):
        unported.append(f"mean_option={cfg.mean_option}")
    if mean_mode == "degraded_area" and cfg.mean_area != "image-wise":
        unported.append(f"mean_area={cfg.mean_area}")
    if unported:
        raise NotImplementedError(
            f"sampling mode not yet ported: {', '.join(unported)}"
        )
    return mean_mode, float(mean_value or 0.0)


def make_sample_fn(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    used_timesteps: np.ndarray,
    *,
    device="cuda",
    plan=None,
) -> Callable:
    """Build sample(latent, generator=None, draws=None) -> sample_0.

    latent: (B, H, W, C) NHWC; returns sample_0 (B, H, W, C) float32 on
    `device`. `used_timesteps` (ascending, 1-indexed) is walked in reverse.
    The model moves to `device` in the compute dtype (bf16 for
    mixed_precision=bf16, else fp32) — module.to() acts in place.
    generator: a CPU torch.Generator for the kernel's and the shift's seeds
    (default: seeded with cfg.seed). draws: callable step -> StepDraws, step
    the index into used_timesteps. plan: a parallel/mesh.MeshPlan (default:
    one rank); with more than one rank the latent (and the draws) hold this
    rank's rows.
    """
    device = torch.device(device)
    plan = plan or MeshPlan(device=device)
    mean_mode, mean_value = fused_mode(cfg)
    compute_dtype = torch.bfloat16 if cfg.weight_dtype == "bfloat16" else torch.float32
    model = model.to(device=device, dtype=compute_dtype).eval()

    used = np.asarray(used_timesteps, dtype=np.int64)
    n_steps = len(used)
    ts = torch.as_tensor(used, device=device)
    next_ts = torch.as_tensor(np.concatenate([used[:1], used[1:] - 1]), device=device)
    amount_t = schedule.degrade_amount(ts).float()
    amount_next = schedule.degrade_amount(next_ts).float()  # t itself on the last step
    ratios = schedule.shift_ratio(ts)

    def sample(latent: torch.Tensor, generator: Optional[torch.Generator] = None,
               draws: Optional[Callable[[int], StepDraws]] = None) -> torch.Tensor:
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.seed))
        seeds = torch.randint(0, 2**62, (2,), generator=generator).tolist()
        shift_gen = torch.Generator(device=device).manual_seed(fold_seed(seeds[1], plan.rank))

        sample_t = latent.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()
        b = sample_t.shape[0]
        shape = tuple(sample_t.shape)
        rows = [x[:, None].expand(n_steps, b).contiguous()
                for x in (ts.float(), amount_t, amount_next, ratios)]
        t_rows, amt_rows, amn_rows, ratio_rows = rows

        sample_0 = sample_t
        with torch.inference_mode():
            for i in range(n_steps - 1, -1, -1):
                # --- shift -> UNet -> inverse shift (sampler.py:142-152)
                if draws is not None:
                    d = draws(i)
                    bits = d.bits
                    shift = shift_ops.shift_from_draws(
                        cfg.shift_type, ratio_rows[i], shape, d.uniform, d.normal,
                        cfg.noise_mean,
                    )
                else:
                    bits = None
                    shift = shift_ops.schedule_shift(
                        shift_gen, ratio_rows[i], shape, cfg.shift_type, cfg.noise_mean
                    )
                shifted = shift_ops.perturb_shift(sample_t, shift)
                out = model(shifted.to(compute_dtype), t_rows[i]).float()
                sample_0 = shift_ops.perturb_shift_inverse(shifted + out, shift)
                # --- degrade at t and t-1 + update rule, one kernel
                new_sample_t, _ = fused_degrade_update_sharded(
                    sample_t, sample_0, amt_rows[i], amn_rows[i], plan=plan,
                    batch=b * plan.data_size, select=cfg.select_degrade_pixel,
                    mean_mode=mean_mode, mean_value=mean_value, rule=cfg.momentum_adaptive,
                    seed=seeds[0], offset=n_steps - 1 - i, bits=bits,
                )
                if i > 0:  # the reference guards the state update on the last step
                    sample_t = new_sample_t
        return sample_0.permute(0, 2, 3, 1)

    return sample
