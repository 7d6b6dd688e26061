"""The train step.

Counterpart of masked_diffusion_tpu/train/step.py:_make_step_impl
(:103-217). `base` and `mean_shift` are one step with the shift stage off
or on. Per step:

  timestep draw from the epoch's curriculum -> degrade (the exact-k mask
  kernel in indexing mode) -> (shift) -> UNet under autocast (bf16 for
  --mixed_precision bf16; every GroupNorm forward and backward is a CUDA
  kernel on CUDA) -> recon = net_in + out -> (inverse shift) -> (weighted)
  MSE in fp32 -> backward -> global-norm clip(1.0) -> optimizer update ->
  EMA update on sync steps.

The step makes no host sync: the schedule's per-timestep tables live on the
device, seeds come from a CPU torch.Generator, the LR and the counters are
host numbers, and the metrics come back as 0-d device tensors for the
trainer to fetch once per epoch.

`draws=` is the one injection point: a TrainDraws giving the timestep
indices, the mask draws and the shift draws of the step, so the tests and
the smoke check can feed both packages the same random numbers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.models.ema import ema_decay, ema_update
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.degrade import degrade_training, device_generator
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainDraws:
    """One step's random numbers.

    timeindex: (B,) int64 positions in the epoch's used-timestep list.
    bits: indexing masks, int64 (B, H*W) uint32 draws (ops/kmask.py).
    mask_uniform: thresholding masks, (B, 1|C, H, W) uniforms in [0, 1).
    uniform / normal: the shift draws of ops/shift.draw_shapes.
    """

    timeindex: torch.Tensor
    bits: Optional[torch.Tensor] = None
    mask_uniform: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None


@dataclasses.dataclass
class TrainState:
    """The model, its EMA copy (None when EMA is off), the optimizer and
    the micro-step counter (which drives the EMA warmup and the logged LR)."""

    model: torch.nn.Module
    ema_model: Optional[torch.nn.Module]
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_ema: bool = True) -> TrainState:
    ema = None
    if use_ema:
        ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model=model, ema_model=ema, optimizer=optimizer)


def make_train_step(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    optimizer: Optimizer,
    used_timesteps: np.ndarray,
    lr_schedule: Optional[Callable[[int], float]] = None,
    device="cuda",
) -> Callable:
    """Build step(state, batch, generator=None, draws=None) -> metrics.

    batch: (B, H, W, C) NHWC images (the dataset's layout) on any device.
    generator: a CPU torch.Generator for every seed of the step (default:
    seeded with cfg.seed). draws: a TrainDraws, replacing every draw.
    `model` and `optimizer` are those of the state the step is given; the
    model, and at its first update the EMA copy, move to `device` (in
    place)."""
    device = torch.device(device)
    model.to(device)
    used = torch.as_tensor(np.asarray(used_timesteps, dtype=np.int64), device=device)
    n_used = int(used.numel())
    # per-curriculum-position tables on the device: the step only gathers
    amount_by_index = schedule.degrade_amount(used)
    ratio_by_index = schedule.shift_ratio(used)
    t_by_index = used.float()
    weight_table = (
        schedule.loss_weight_table(cfg.loss_weight_power_base, device)
        if cfg.loss_weight_use else None
    )
    mean_shift = cfg.method == "mean_shift"
    accum = max(1, cfg.gradient_accumulation_steps)
    bf16 = cfg.weight_dtype == "bfloat16"

    def step(state: TrainState, batch: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             draws: Optional[TrainDraws] = None) -> Dict[str, torch.Tensor]:
        img = batch.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()
        b = img.shape[0]
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.seed))
        dev_gen = None
        if draws is None:
            dev_gen = device_generator(generator, device)
            timeindex = torch.randint(0, n_used, (b,), generator=dev_gen, device=device)
        else:
            timeindex = draws.timeindex.to(device)

        # --- degrade (scheduler.degrade_training)
        degraded, _, _, _ = degrade_training(
            img, amount_by_index[timeindex], cfg.select_degrade_pixel, cfg.degrade_channel,
            cfg.mean_option, cfg.mean_area, generator=generator,
            bits=None if draws is None else draws.bits,
            uniforms=None if draws is None else draws.mask_uniform,
        )

        # --- mean shift (trainer_masked_mean_shift.py:119-120)
        shift = None
        net_in = degraded
        if mean_shift:
            ratios = ratio_by_index[timeindex]
            if draws is None:
                shift = shift_ops.schedule_shift(dev_gen, ratios, tuple(img.shape),
                                                 cfg.shift_type, cfg.noise_mean)
            else:
                shift = shift_ops.shift_from_draws(cfg.shift_type, ratios, tuple(img.shape),
                                                   draws.uniform, draws.normal, cfg.noise_mean)
            net_in = degraded + shift

        # --- UNet, residual reconstruction, fp32 loss
        state.optimizer.zero_grad()
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
            out = state.model(net_in, t_by_index[timeindex])
        recon = net_in + out.float()
        inv_recon = recon - shift if mean_shift else recon
        per_px = (inv_recon - img) ** 2
        if weight_table is not None:
            # indexed by timeindex, the reference's quirk (step.py:169)
            per_px = weight_table[timeindex][:, None, None, None] * per_px
        loss = per_px.mean()
        loss.backward()
        state.optimizer.update()

        # --- EMA, only on sync boundaries (trainer_masked.py:151-153)
        state.step += 1
        opt_step = state.step // accum
        if state.ema_model is not None and state.step % accum == 0:
            if next(state.ema_model.parameters()).device != img.device:
                state.ema_model.to(device)  # made before the model moved
            decay = ema_decay(opt_step, cfg.ema_inv_gamma, cfg.ema_power, 0.0,
                              cfg.ema_max_decay)
            ema_update(state.ema_model.parameters(), state.model.parameters(), decay)

        with torch.no_grad():
            metrics = {
                "train_loss": loss.detach(),
                "shifted_degrade_img_mean": net_in.mean(),
                "degraded_train_mean": degraded.mean(),
                "reconstruct_train_mean": recon.detach().mean(),
                "inverse_reconstruct_train_mean": inv_recon.detach().mean(),
            }
            if lr_schedule is not None:
                metrics["lr"] = torch.full((), lr_schedule(opt_step), device=device)
        return metrics

    return step
