"""The train step, and the train-visuals pass of the save cadence.

Counterpart of masked_diffusion_tpu/train/step.py:_make_step_impl
(:103-217) and make_train_visuals_fn (:278-340), which share the work before
the UNet (_make_prepare). `base` and `mean_shift` are one step with the shift stage off
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
trainer to fetch once per epoch (under a plan, the rank's own: the trainer
takes their mean over the ranks in that fetch).

`draws=` is the one injection point: a TrainDraws giving the timestep
indices, the mask draws and the shift draws of the step, so the tests and
the smoke check can feed both packages the same random numbers.

Data-parallel (a parallel/mesh.MeshPlan of N > 1 ranks, one process each):
create_train_state wraps the model in DistributedDataParallel, whose
construction broadcasts rank 0's parameters, and the EMA copy is made after
it. The step takes this rank's rows of the global batch; injected draws are
the global batch's and are sliced to the rank's rows. DDP averages the
gradients over the ranks during backward (under gradient accumulation,
no_sync on every micro step but the window's last), so the clip at 1.0 and
the update see the global batch's gradient and every rank makes the same
update; the EMA follows the unwrapped module. Masks go through the sharded kernel form (ops/degrade.py), and
the caller's generator is the rank's own (train/trainer.py folds its seed).

Tensor and spatial parallelism (a plan with model_size M > 1; the model
placed by parallel/mesh.py:place_model before the optimizer is built): the
M ranks of a model group take the same rows and draws (the data rank's).
Under TP, DDP wraps the model over the data group only (a sharded
gradient is the rank's slice and may not be averaged across the model
group), and the optimizer averages the replicated gradients over the model
group and takes the clip's norm over the whole logical gradient
(train/optim.py:Optimizer.set_tensor_parallel). Under SP (plan.spatial) the UNet
splits its input and gathers its output itself (parallel/sp.py), so the
degrade, shift and loss run on whole images on every rank; DDP wraps the
model over all D x M ranks, each rank's gradient is its rows' share, and
the loss is scaled by M before the backward so that DDP's average over D x M
ranks is the mean over the D data ranks.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.models.ema import ema_decay, ema_update
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.degrade import degrade_training, device_generator
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.parallel.mesh import local_rows
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
    """The model, its EMA copy (None when EMA is off), the optimizer, the
    micro-step counter (which drives the EMA warmup and the logged LR), and
    the DistributedDataParallel wrapper of the model when data-parallel."""

    model: torch.nn.Module
    ema_model: Optional[torch.nn.Module]
    optimizer: Optimizer
    step: int = 0
    ddp: Optional[torch.nn.Module] = None


def create_train_state(model: torch.nn.Module, optimizer: Optimizer,
                       use_ema: bool = True, plan=None) -> TrainState:
    """The state of a fresh run. With a plan of more than one data rank, or
    spatial partitioning, the model (already on the rank's device, and
    placed on the plan's model axis) is wrapped in DistributedDataParallel,
    which gives every rank of its group that group's first rank's
    parameters, before the EMA copy (sharded like the model under TP)."""
    ddp = None
    spatial = plan is not None and plan.model_size > 1 and plan.spatial
    if plan is not None and (plan.data_size > 1 or spatial):
        from torch.nn.parallel import DistributedDataParallel

        dev = next(model.parameters()).device
        # SP: every rank (the default group); DP and TP: the data group
        ddp = DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            find_unused_parameters=False, process_group=None if spatial else plan.data_group)
    ema = None
    if use_ema:
        ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(model=model, ema_model=ema, optimizer=optimizer, ddp=ddp)


def make_train_step(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    optimizer: Optimizer,
    used_timesteps: np.ndarray,
    lr_schedule: Optional[Callable[[int], float]] = None,
    device="cuda",
    plan=None,
) -> Callable:
    """Build step(state, batch, generator=None, draws=None) -> metrics.

    batch: (B, H, W, C) NHWC images (the dataset's layout) on any device;
    with a plan of N > 1 ranks, this rank's B rows of the global batch.
    generator: a CPU torch.Generator for every seed of the step (default:
    seeded with cfg.seed). draws: a TrainDraws, replacing every draw (with a
    plan, the global batch's). `model` and `optimizer` are those of the
    state the step is given; the model, and at its first update the EMA
    copy, move to `device` (in place)."""
    device = torch.device(device)
    ranks = plan.data_size if plan is not None else 1
    # SP: each rank's gradient is its rows' share; DDP averages D x M of them
    loss_scale = plan.model_size if plan is not None and plan.spatial else 1
    model.to(device)
    prepare = _make_prepare(schedule, cfg, used_timesteps, device, plan)
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
        if draws is not None and ranks > 1:
            rows = local_rows(b * ranks, plan)
            draws = TrainDraws(**{k: None if v is None else v[rows]
                                  for k, v in vars(draws).items()})
        p = prepare(img, generator, draws)
        timeindex, degraded, shift, net_in = p["timeindex"], p["degraded"], p["shift"], p["net_in"]

        # --- UNet, residual reconstruction, fp32 loss
        opt = state.optimizer
        opt.zero_grad()  # where a window starts; inside it the micro steps sum
        net = state.ddp if state.ddp is not None else state.model
        # DDP: only the accumulation window's last micro step all-reduces
        window_open = state.ddp is not None and opt.mini_step + 1 < opt.every_k
        with state.ddp.no_sync() if window_open else contextlib.nullcontext():
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
                out = net(net_in, p["t"])
            recon = net_in + out.float()
            inv_recon = recon - shift if mean_shift else recon
            per_px = (inv_recon - img) ** 2
            if weight_table is not None:
                # indexed by timeindex, the reference's quirk (step.py:169)
                per_px = weight_table[timeindex][:, None, None, None] * per_px
            loss = per_px.mean()
            (loss * loss_scale).backward()
        opt.update()

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


def _make_prepare(schedule: MaskSchedule, cfg, used_timesteps: np.ndarray, device, plan):
    """prepare(img, generator, draws) -> the step's work before the UNet
    (train/step.py:_make_step_impl up to the forward): the timestep draw from
    the epoch's curriculum, the degrade (the exact-k mask kernel in indexing
    mode) and, for mean_shift, the shift. img is NCHW on `device`. Returns a
    dict: timeindex, t, degraded, masks, degrade_mask, mean_mask, shift
    (None for base) and net_in."""
    used = torch.as_tensor(np.asarray(used_timesteps, dtype=np.int64), device=device)
    n_used = int(used.numel())
    # per-curriculum-position tables on the device: the step only gathers
    amount_by_index = schedule.degrade_amount(used)
    ratio_by_index = schedule.shift_ratio(used)
    t_by_index = used.float()
    mean_shift = cfg.method == "mean_shift"

    def prepare(img: torch.Tensor, generator: torch.Generator,
                draws: Optional[TrainDraws] = None) -> Dict[str, Optional[torch.Tensor]]:
        dev_gen = None
        if draws is None:
            dev_gen = device_generator(generator, device)
            timeindex = torch.randint(0, n_used, (img.shape[0],), generator=dev_gen,
                                      device=device)
        else:
            timeindex = draws.timeindex.to(device)

        # --- degrade (scheduler.degrade_training)
        degraded, masks, degrade_mask, mean_mask = degrade_training(
            img, amount_by_index[timeindex], cfg.select_degrade_pixel, cfg.degrade_channel,
            cfg.mean_option, cfg.mean_area, generator=generator,
            bits=None if draws is None else draws.bits,
            uniforms=None if draws is None else draws.mask_uniform, plan=plan,
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
        return {"timeindex": timeindex, "t": t_by_index[timeindex], "degraded": degraded,
                "masks": masks, "degrade_mask": degrade_mask, "mean_mask": mean_mask,
                "shift": shift, "net_in": net_in}

    return prepare


def make_train_visuals_fn(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    used_timesteps: np.ndarray,
    device="cuda",
    plan=None,
) -> Callable:
    """Build visuals(batch, generator) -> the reference's train-time visual
    tensors (JAX train/step.py:make_train_visuals_fn; train_visual_names,
    trainer_masked.py:58, trainer_masked_mean_shift.py:58): input,
    degraded_img, degrade_binary_masks, degradation_mask, mean_pixel, mask
    (the network output, as the reference names it) and reconstructed_img,
    plus shift, shifted_degrade_img and inverse_shift_reconstructed_img on
    the mean-shift path; each (B, H, W, C) float32, NHWC.

    One forward under torch.no_grad, on the batch the step was given (NHWC;
    with a plan, this rank's rows), drawing as the step does from
    `generator` (a CPU torch.Generator). The trainer runs it once per save
    cadence, never in the hot loop."""
    device = torch.device(device)
    prepare = _make_prepare(schedule, cfg, used_timesteps, device, plan)
    bf16 = cfg.weight_dtype == "bfloat16"

    def visuals(batch: torch.Tensor, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        img = batch.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad():
            p = prepare(img, generator)
            with torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16):
                out = model(p["net_in"], p["t"])
            recon = p["net_in"] + out.float()
            tensors = {
                "input": img,
                "degraded_img": p["degraded"],
                "degrade_binary_masks": p["masks"],
                "degradation_mask": p["degrade_mask"],
                "mean_pixel": p["mean_mask"],
                "mask": out.float(),
                "reconstructed_img": recon,
            }
            if p["shift"] is not None:
                tensors["shift"] = p["shift"]
                tensors["shifted_degrade_img"] = p["net_in"]
                tensors["inverse_shift_reconstructed_img"] = recon - p["shift"]
            return {k: v.expand(img.shape).permute(0, 2, 3, 1) for k, v in tensors.items()}

    return visuals
