"""Reverse-process sampler: a Python loop over the used timesteps, T down to 1.

Counterpart of masked_diffusion_tpu/sample/loop.py:make_sample_fn. Each step
runs

    shift -> UNet -> inverse shift -> degrade(t), degrade(t-1) -> update rule

on one of two branches, picked from the mode alone (fused_mode):

  fused  the coverage of the JAX package's fused gate (_use_fused_degrade,
         loop.py:56-108): no trajectory capture, independent mask
         dependency, base_momentum or base_sampling, 1-channel masks, a
         const or image-wise degraded_area mean. The degrade pair and the
         update are one launch of ops/fused_degrade.py's kernel.
  plain  every other mode, as the JAX loop's non-fused branch
         (loop.py:292-337): the degrade ops of ops/degrade.py, then the
         update rule in tensor ops. Indexing masks go through the exact-k
         kernel (ops/kmask.py) on CUDA, twice a step (independent) or once
         (dependent_prev); thresholding masks compare uniforms drawn on the
         device from one generator made per call.
           dependencies  independent; dependent_prev (the mask at t is the
                         previous step's mask at t-1, all zero on the first
                         step: the JAX carry's zeros, loop.py:385-389);
                         dependent_t (nested thresholding masks from one
                         uniform field)
           rules         base_sampling, base_momentum, momentum (its buffer
                         starts at zero), boosting (the momentum line
                         overwritten by the difference, sampler.py:248-249)
         with 1- or 3-channel masks and every mean mode.

The last step's state update is skipped for base_sampling and base_momentum
(the reference's `if i > 0` guard, loop.py:288, :333-335), not for momentum
and boosting. --encoder_reuse > 1 raises NotImplementedError naming it, an
unknown mode ValueError; interpolation sampling is another entry point
(sample/interpolation.py).

Trajectory capture (capture_trajectory=True, JAX loop.py:340-383): the
sampler returns (sample_0, trajectory). trajectory holds the 11
TRAJECTORY_FIELDS of the first k images as device tensors (n_steps, k, H,
W, C), NHWC, index 0 the first reverse step (t = T), in buffers allocated
once a call and filled in place; and `means`: four (n_steps,) tensors, the
per-step means of sample_t, shifted, sample_0 and shifted_result over the
FULL batch. The JAX package keeps its ys flattened, (T, k, H*W*C), because
a TPU pads the two minor dims of a buffer to its tiles; a GPU buffer has no
such padding, so the port keeps the image layout, and trajectory_images
turns the JAX layout into it. Capture always runs the plain branch.

State is NCHW on `device`; the latent in and the sample out are NHWC, the
JAX package's layout. The loop makes no host sync: schedule amounts live on
the device, the kernels' Philox seeds and the generators' seeds come from a
CPU torch.Generator, and the captured values are written on the device.

Data-parallel (a parallel/mesh.MeshPlan; one rank when none is given): the
latent holds this rank's rows of the global batch; the fused step goes
through fused_degrade_update_sharded, the exact-k masks through
exact_count_masks_sharded (the rank's rows, the seed folded with the rank;
rank 0's is the one drawn, as JAX loop.py:274-285), and the shift's and the
thresholding field's generators are seeded with the rank folded in, so
local image i on two ranks draws differently. Captured images are the first
k rows of rank 0, the global batch's first k, when k is at most the rows a
rank; otherwise every rank's rows are gathered (collective). The means are
the mean over the ranks (utils/host.mean_over_ranks, collective).

`draws=` is the one injection point: a callable step -> StepDraws giving a
step's mask draws for t and t-1 and its shift draws, so the tests and the
smoke check can feed both sides the same random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import parse_mean_option, validate_sampling_modes
from masked_diffusion_tpu_torch.ops import degrade as degrade_ops
from masked_diffusion_tpu_torch.ops import shift as shift_ops
from masked_diffusion_tpu_torch.ops.fused_degrade import fused_degrade_update_sharded
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.ops.shard import fold_seed
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan
from masked_diffusion_tpu_torch.utils import host

#: The captured fields, in the JAX package's order (loop.py:41).
TRAJECTORY_FIELDS = (
    "sample_t", "shift", "shifted", "mask", "shifted_result", "sample_0",
    "degrade_mask_t", "degrade_mask_next_t", "degraded_t", "difference",
    "degraded_next_t",
)
#: The full-batch per-step means a capture carries.
TRAJECTORY_MEANS = ("sample_t", "shifted", "sample_0", "shifted_result")


def trajectory_images(buf, height: int, width: int, channels: int):
    """One JAX-captured buffer, (T, k, H*W*C) flattened row-major NHWC
    images, in the port's layout (T, k, H, W, C); numpy or torch."""
    t, k, _ = buf.shape
    return buf.reshape(t, k, height, width, channels)


@dataclasses.dataclass
class StepDraws:
    """One step's random numbers, each for t, then t-1.

    bits: indexing masks, int64 (2, B, H*W) uint32 values.
    mask_uniform: thresholding masks, (2, B, c, H, W) uniforms in [0, 1),
      c = C for 3-channel masks, else 1 (dependent_t reads only the first).
    uniform / normal: the shift draws of ops/shift.draw_shapes.
    """

    bits: Optional[torch.Tensor] = None
    mask_uniform: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None
    normal: Optional[torch.Tensor] = None


def validate_modes(cfg) -> None:
    """Raise for a sampling mode no branch runs: ValueError for an unknown
    dependency or rule and the couplings config.validate_sampling_modes
    refuses, NotImplementedError naming encoder_reuse > 1."""
    if cfg.sampling_mask_dependency not in ("independent", "dependent_prev", "dependent_t"):
        raise ValueError(f"unknown sampling_mask_dependency: {cfg.sampling_mask_dependency!r}")
    if cfg.momentum_adaptive not in ("base_sampling", "base_momentum", "momentum", "boosting"):
        raise ValueError(f"unknown momentum_adaptive: {cfg.momentum_adaptive!r}")
    validate_sampling_modes(cfg)
    parse_mean_option(cfg.mean_option)
    reuse = int(getattr(cfg, "encoder_reuse", 0) or 0)
    if reuse < 0:
        raise ValueError(f"encoder_reuse must be >= 0, got {reuse}")
    if reuse > 1:
        raise NotImplementedError(f"sampling mode not yet ported: encoder_reuse={reuse}")


def fused_mode(cfg, capture_trajectory: bool = False):
    """The fused kernel's (mean_mode, mean_value) when it covers cfg's mode,
    else None (the plain branch runs it). Raises as validate_modes."""
    validate_modes(cfg)
    mean_mode, mean_value = parse_mean_option(cfg.mean_option)
    covered = (
        not capture_trajectory
        and cfg.sampling_mask_dependency == "independent"
        and cfg.momentum_adaptive in ("base_momentum", "base_sampling")
        and cfg.degrade_channel == "1-channel"
        and (mean_mode == "const"
             or (mean_mode == "degraded_area" and cfg.mean_area == "image-wise"))
    )
    return (mean_mode, float(mean_value or 0.0)) if covered else None


def make_sample_fn(
    model: torch.nn.Module,
    schedule: MaskSchedule,
    cfg,
    used_timesteps: np.ndarray,
    *,
    device="cuda",
    plan=None,
    capture_trajectory: bool = False,
    capture_items: int = 0,
) -> Callable:
    """Build sample(latent, generator=None, draws=None) -> sample_0, or
    (sample_0, trajectory) with capture_trajectory.

    latent: (B, H, W, C) NHWC; returns sample_0 (B, H, W, C) float32 on
    `device`. `used_timesteps` (ascending, 1-indexed) is walked in reverse.
    The model moves to `device` in the compute dtype (bf16 for
    mixed_precision=bf16, else fp32) — module.to() acts in place.
    generator: a CPU torch.Generator for every seed of the call (default:
    seeded with cfg.seed). draws: callable step -> StepDraws, step the index
    into used_timesteps. plan: a parallel/mesh.MeshPlan (default: one rank);
    with more than one rank the latent (and the draws) hold this rank's
    rows. capture_items: the k images captured (0: the whole global batch).
    """
    device = torch.device(device)
    plan = plan or MeshPlan(device=device)
    fused = fused_mode(cfg, capture_trajectory)
    compute_dtype = torch.bfloat16 if cfg.weight_dtype == "bfloat16" else torch.float32
    model = model.to(device=device, dtype=compute_dtype).eval()
    dependency, rule = cfg.sampling_mask_dependency, cfg.momentum_adaptive
    select = cfg.select_degrade_pixel
    degrade_kw = dict(select_degrade_pixel=select, degrade_channel=cfg.degrade_channel,
                      mean_option=cfg.mean_option, mean_area=cfg.mean_area, plan=plan)
    mean_kw = dict(mean_option=cfg.mean_option, mean_area=cfg.mean_area)
    skip_on_last = rule in ("base_sampling", "base_momentum")

    used = np.asarray(used_timesteps, dtype=np.int64)
    n_steps = len(used)
    ts = torch.as_tensor(used, device=device)
    next_ts = torch.as_tensor(np.concatenate([used[:1], used[1:] - 1]), device=device)
    amount_t = schedule.degrade_amount(ts).float()
    amount_next = schedule.degrade_amount(next_ts).float()  # t itself on the last step
    ratios = schedule.shift_ratio(ts)

    def sample(latent: torch.Tensor, generator: Optional[torch.Generator] = None,
               draws: Optional[Callable[[int], StepDraws]] = None):
        if generator is None:
            generator = torch.Generator().manual_seed(int(cfg.seed))
        seeds = torch.randint(0, 2**62, (2,), generator=generator).tolist()
        shift_gen = torch.Generator(device=device).manual_seed(fold_seed(seeds[1], plan.rank))
        # the plain branch's masks: the exact-k kernel's Philox seeds (CPU
        # draws), and the thresholding field's generator on the device
        mask_gen = torch.Generator().manual_seed(seeds[0])
        field_gen = None
        if fused is None and select == "thresholding" and draws is None:
            field_gen = torch.Generator(device=device).manual_seed(
                fold_seed(seeds[0], plan.rank))

        sample_t = latent.to(device=device, dtype=torch.float32).permute(0, 3, 1, 2).contiguous()
        b, c, h, w = sample_t.shape
        shape = (b, c, h, w)
        field_shape = (1 if dependency == "dependent_t" else 2,
                       b, c if cfg.degrade_channel == "3-channel" else 1, h, w)
        rows = [x[:, None].expand(n_steps, b).contiguous()
                for x in (ts.float(), amount_t, amount_next, ratios)]
        t_rows, amt_rows, amn_rows, ratio_rows = rows

        with torch.inference_mode():
            zeros = torch.zeros(shape, device=device)
            mask_prev, momentum = zeros, zeros
            sample_0 = sample_t
            if capture_trajectory:
                k = min(capture_items or b * plan.data_size, b * plan.data_size)
                k_local = min(k, b)
                traj = {name: torch.empty((n_steps, k_local, h, w, c), device=device)
                        for name in TRAJECTORY_FIELDS}
                means = torch.empty((len(TRAJECTORY_MEANS), n_steps), device=device)
            for i in range(n_steps - 1, -1, -1):
                d = draws(i) if draws is not None else None
                # --- shift -> UNet -> inverse shift (sampler.py:142-152)
                if d is not None:
                    shift = shift_ops.shift_from_draws(
                        cfg.shift_type, ratio_rows[i], shape, d.uniform, d.normal,
                        cfg.noise_mean,
                    )
                else:
                    shift = shift_ops.schedule_shift(
                        shift_gen, ratio_rows[i], shape, cfg.shift_type, cfg.noise_mean
                    )
                shifted = shift_ops.perturb_shift(sample_t, shift)
                out = model(shifted.to(compute_dtype), t_rows[i]).float()
                shifted_result = shifted + out
                sample_0 = shift_ops.perturb_shift_inverse(shifted_result, shift)

                if fused is not None:
                    # --- degrade at t and t-1 + update rule, one kernel
                    new_sample_t, _ = fused_degrade_update_sharded(
                        sample_t, sample_0, amt_rows[i], amn_rows[i], plan=plan,
                        batch=b * plan.data_size, select=select, mean_mode=fused[0],
                        mean_value=fused[1], rule=rule, seed=seeds[0],
                        offset=n_steps - 1 - i, bits=None if d is None else d.bits,
                    )
                    if i > 0:
                        sample_t = new_sample_t
                    continue

                # --- degrade at t and t-1 (sampler.py:167-196)
                bits = field = None
                if d is not None:
                    bits, field = d.bits, d.mask_uniform
                    need = "bits" if select == "indexing" else "mask_uniform"
                    if getattr(d, need) is None:
                        raise ValueError(f"draws give no {select} mask draws ({need})")
                elif field_gen is not None:
                    field = torch.rand(field_shape, generator=field_gen, device=device)

                def independent(amount, which):
                    return degrade_ops.degrade_independent_base_sampling(
                        sample_0, amount, **degrade_kw, generator=mask_gen,
                        bits=None if bits is None else bits[which],
                        uniforms=None if field is None else field[which])[:2]

                if dependency == "independent":
                    degraded_t, mask_t = independent(amt_rows[i], 0)
                    degraded_next, mask_next = independent(amn_rows[i], 1)
                elif dependency == "dependent_prev":
                    degraded_t = degrade_ops.degrade_with_mask(sample_0, mask_prev, **mean_kw)
                    mask_t = mask_prev
                    degraded_next, mask_next = independent(amn_rows[i], 1)
                else:  # dependent_t
                    degraded_t, mask_t, _, degraded_next, mask_next, _ = (
                        degrade_ops.degrade_dependent_base_sampling(
                            sample_0, amt_rows[i], amn_rows[i], cfg.degrade_channel,
                            uniforms=None if field is None else field[0], **mean_kw))

                # --- update rule (sampler.py:199-250)
                difference = degraded_next - degraded_t
                if rule == "base_sampling":
                    new_sample_t = degraded_next
                elif rule == "base_momentum":
                    new_sample_t = sample_t + difference  # cold diffusion
                elif rule == "momentum":
                    r = cfg.adaptive_momentum_rate
                    momentum = (1.0 - r) * momentum + r * (sample_t - degraded_t)
                    new_sample_t = momentum + degraded_next
                    difference = sample_t - degraded_t
                else:  # boosting: the reference's momentum line is overwritten
                    momentum = sample_t - degraded_t
                    new_sample_t = momentum + degraded_next
                    difference = momentum

                if capture_trajectory:
                    j = n_steps - 1 - i
                    values = (sample_t, shift, shifted, out, shifted_result, sample_0,
                              mask_t, mask_next, degraded_t, difference, degraded_next)
                    for name, x in zip(TRAJECTORY_FIELDS, values):
                        traj[name][j].copy_(x.expand(shape)[:k_local].permute(0, 2, 3, 1))
                    means[:, j] = torch.stack(
                        [x.mean() for x in (sample_t, shifted, sample_0, shifted_result)])
                mask_prev = mask_next
                if i > 0 or not skip_on_last:
                    sample_t = new_sample_t

            result = sample_0.permute(0, 2, 3, 1)
            if not capture_trajectory:
                return result
            if k > k_local:  # rank 0's rows are not all of the first k: gather
                traj = {name: host.gather(buf.transpose(0, 1))[:k].transpose(0, 1).to(device)
                        for name, buf in traj.items()}
            means = host.mean_over_ranks(means)
            traj["means"] = dict(zip(TRAJECTORY_MEANS, means))
        return result, traj

    return sample
