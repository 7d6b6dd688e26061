"""Mask generation and mean-fill degradation, NCHW.

Counterpart of masked_diffusion_tpu/ops/degrade.py: the parts the train step
uses (:96-113, :186-301) and the sampling-time ops of the reverse loop's
plain branch (:116-132, :304-441). The interpolation sampler's op (:444) is
not ported.

  'indexing'     exactly k degraded pixels per image (k from the schedule's
                 integer table): the exact-k mask kernel (ops/kmask.py) on
                 CUDA, its plain version on the CPU, 1-channel, broadcast
                 over channels. masks_from_uniforms (:50-78) has no copy:
                 its exact-k law, ties broken by pixel index, is the
                 kernel's on composite keys. It goes through the kernel's
                 sharded form (exact_count_masks_sharded: the rank's rows,
                 its generator folded with the rank), as the JAX route
                 (:200-217), on a 1-rank plan when no plan is given
  'thresholding' per-pixel uniform > ratio, 1-channel (one mask shared by
                 the channels) or 3-channel (independent per channel)

Mask convention: 1 = kept pixel, 0 = degraded. Mean fills (scheduler.py:
298-323, kept exactly, including the sign-flipped 'non_degraded_area'
formula and its zero-count guard):
  const v            : mean = v
  'degraded_area'    : mean of the degraded pixels, image-wise (B,1,1,1) or
                       channel-wise (B,C,1,1)
  'non_degraded_area': -(sum of KEPT pixels)/(count of DEGRADED pixels) per
                       channel, 0 where nothing is degraded
Degradation D(x) = (1-m)*mu + m*x (scheduler.py:319).

Sampling-time ops (scheduler.py:326-598): the independent degrade returns
the *binary* mask, unlike training; the dependent one thresholds one shared
uniform field at two ratios (nested masks at t and t-1); the index ops
degrade a prefix of a fixed per-image pixel permutation, through a
slot-of-pixel map built with one scatter on the device (the count stays a
tensor: no host sync).

Random numbers: a CPU torch.Generator seeds the mask kernel's Philox, or a
device generator for the thresholding uniforms, made on each call (the
sampling loop draws its fields from one device generator per call and
passes them in); `bits` (indexing) or `uniforms` (thresholding) inject the
draws, as the tests and the smoke check do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from masked_diffusion_tpu_torch.config import parse_mean_option
from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks_sharded
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan


def device_generator(generator: torch.Generator, device: torch.device) -> torch.Generator:
    """`generator` itself for the CPU; else a generator on `device` seeded
    from it (no host-device transfer)."""
    if device.type == "cpu":
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def threshold_masks(
    batch: int,
    height: int,
    width: int,
    channels: int,
    ratios: torch.Tensor,
    per_channel: bool,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel uniform-vs-ratio masks (scheduler.py:286-296) on ratios'
    device: (B, 1, H, W) shared ('1-channel') or (B, C, H, W) ('3-channel').
    uniforms: the draws in [0, 1) of that shape, else drawn from generator."""
    shape = (batch, channels if per_channel else 1, height, width)
    u = _uniform_field(shape, ratios.device, generator, uniforms)
    return _above(u, ratios)


def nested_threshold_masks(
    batch: int,
    height: int,
    width: int,
    channels: int,
    ratios_a: torch.Tensor,
    ratios_b: torch.Tensor,
    per_channel: bool,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shared uniform field thresholded at two levels -> nested masks
    (degrade_dependent_base_sampling, scheduler.py:494-513), each of
    threshold_masks' shape; `uniforms` injects the one field."""
    shape = (batch, channels if per_channel else 1, height, width)
    u = _uniform_field(shape, ratios_a.device, generator, uniforms)
    return _above(u, ratios_a), _above(u, ratios_b)


def _uniform_field(shape, device, generator, uniforms) -> torch.Tensor:
    if uniforms is None:
        gen = device_generator(generator or torch.Generator(), device)
        return torch.rand(shape, generator=gen, device=device)
    if tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms must have shape {shape}, got {tuple(uniforms.shape)}")
    return uniforms


def _above(u: torch.Tensor, ratios: torch.Tensor) -> torch.Tensor:
    return (u > ratios.to(torch.float32).reshape(-1, 1, 1, 1)).to(torch.float32)


def generate_masks(
    img: torch.Tensor,
    amount: torch.Tensor,
    select_degrade_pixel: str,
    degrade_channel: str,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    plan=None,
) -> torch.Tensor:
    """Masks broadcast to img's (B, C, H, W) shape. On CUDA, indexing always
    launches the exact-k mask kernel, through its sharded form on `plan` (a
    parallel/mesh.MeshPlan, img holding this rank's rows; one rank when
    None)."""
    b, c, h, w = img.shape
    if select_degrade_pixel == "indexing":
        plan = plan or MeshPlan(device=img.device)
        masks = exact_count_masks_sharded(b * plan.data_size, h, w, amount.to(torch.int32),
                                          plan=plan, generator=generator, bits=bits)
    elif select_degrade_pixel == "thresholding":
        masks = threshold_masks(b, h, w, c, amount, degrade_channel == "3-channel",
                                generator=generator, uniforms=uniforms)
    else:
        raise ValueError(f"unknown select_degrade_pixel: {select_degrade_pixel!r}")
    return masks.expand(b, c, h, w)


def compute_mean_pixel(
    img: torch.Tensor,
    masks: torch.Tensor,
    mean_option,
    mean_area: str,
) -> torch.Tensor:
    """Fill value for degraded pixels (scheduler.py:298-317), (B, 1|C, 1, 1)."""
    mode, value = parse_mean_option(mean_option)
    b, c = img.shape[:2]

    if mode == "const":
        return torch.full((b, c, 1, 1), value, dtype=img.dtype, device=img.device)

    inv = 1.0 - masks
    if mode == "degraded_area":
        if mean_area == "image-wise":
            dims = (1, 2, 3)
        elif mean_area == "channel-wise":
            dims = (2, 3)
        else:
            raise ValueError(f"unknown mean_area: {mean_area!r}")
        sum_pixel = (img * inv).sum(dim=dims, keepdim=True)
        count = inv.sum(dim=dims, keepdim=True)
        # a zero degraded count means nothing gets filled: the value is inert
        return torch.where(count > 0, sum_pixel / count.clamp(min=1.0),
                           torch.zeros_like(sum_pixel))

    if mode == "non_degraded_area":
        # the reference formula (scheduler.py:311-314): the *kept* pixels
        # summed, divided by the *degraded* count, negated; 0 where none
        sum_pixel = (img * masks).sum(dim=(2, 3), keepdim=True)
        count = inv.sum(dim=(2, 3), keepdim=True)
        return torch.where(count > 0, sum_pixel / count.clamp(min=1.0) * -1.0,
                           torch.zeros_like(sum_pixel))

    raise ValueError(f"unsupported mean_option mode: {mode!r}")


def degrade_training(
    img: torch.Tensor,
    amount: torch.Tensor,
    select_degrade_pixel: str,
    degrade_channel: str,
    mean_option,
    mean_area: str,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    plan=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-time degradation (scheduler.py:266-323), img (B, C, H, W).

    Returns (degrade_img, masks, degrade_mask, mean_mask):
      degrade_img  = (1-m)*mu + m*x
      masks        = binary masks broadcast to x
      degrade_mask = (1-m)*mu + m       (mu on degraded pixels, 1 elsewhere)
      mean_mask    = mu everywhere
    """
    masks = generate_masks(img, amount, select_degrade_pixel, degrade_channel,
                           generator=generator, bits=bits, uniforms=uniforms, plan=plan)
    mean_pixel = compute_mean_pixel(img, masks, mean_option, mean_area)
    inv = 1.0 - masks
    degrade_img = inv * mean_pixel + masks * img
    degrade_mask = inv * mean_pixel + masks
    mean_mask = mean_pixel.expand(img.shape)
    return degrade_img, masks, degrade_mask, mean_mask


def degrade_independent_base_sampling(
    img: torch.Tensor,
    amount: torch.Tensor,
    select_degrade_pixel: str,
    degrade_channel: str,
    mean_option,
    mean_area: str,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    plan=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sampling-time degradation with a fresh independent mask
    (scheduler.py:418-477). Returns (degrade_img, masks, mean_mask), masks
    the *binary* mask broadcast to img (unlike training's degrade_mask)."""
    masks = generate_masks(img, amount, select_degrade_pixel, degrade_channel,
                           generator=generator, bits=bits, uniforms=uniforms, plan=plan)
    mean_pixel = compute_mean_pixel(img, masks, mean_option, mean_area)
    degrade_img = (1.0 - masks) * mean_pixel + masks * img
    return degrade_img, masks, mean_pixel.expand(img.shape)


def degrade_dependent_base_sampling(
    img: torch.Tensor,
    amount_t: torch.Tensor,
    amount_next_t: torch.Tensor,
    degrade_channel: str,
    mean_option,
    mean_area: str,
    *,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Nested masks for (t, t-1) from one shared uniform field
    (scheduler.py:480-549; thresholding only, config.validate_sampling_modes
    refuses indexing). Returns (degrade_t, mask_t, mean_mask_t, degrade_next,
    mask_next, mean_mask_next)."""
    b, c, h, w = img.shape
    masks = nested_threshold_masks(b, h, w, c, amount_t, amount_next_t,
                                   degrade_channel == "3-channel",
                                   generator=generator, uniforms=uniforms)
    out = []
    for m in masks:
        m = m.expand(img.shape)
        mean_pixel = compute_mean_pixel(img, m, mean_option, mean_area)
        out += [(1.0 - m) * mean_pixel + m * img, m, mean_pixel.expand(img.shape)]
    return tuple(out)


def degrade_with_mask(img: torch.Tensor, masks: torch.Tensor, mean_option,
                      mean_area: str) -> torch.Tensor:
    """Degrade with a caller-provided mask (scheduler.py:572-598): the
    'dependent_prev' mode reuses the previous step's mask."""
    mean_pixel = compute_mean_pixel(img, masks, mean_option, mean_area)
    return (1.0 - masks) * mean_pixel + masks * img


def _slot_of_pixel(index: torch.Tensor, hw: int) -> torch.Tensor:
    """(B, HW) int64: slot[i, p] = j where index[i, j] == p (one scatter on
    index's device)."""
    index = index.to(torch.int64)
    positions = torch.arange(hw, device=index.device).expand(index.shape[0], hw)
    return torch.zeros((index.shape[0], hw), dtype=torch.int64,
                       device=index.device).scatter_(1, index, positions)


def degrade_index_sampling(
    index: torch.Tensor,
    count_t: torch.Tensor,
    img: torch.Tensor,
    mean_option,
    mean_area: str,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Degrade the first count_t[0] entries of a fixed per-image pixel
    permutation (scheduler.py:379-415; every image shares the count at a
    step, as in the reference). index: (B, H*W) integers. Pixels whose slot
    in the permutation is >= the count are kept. Returns (degrade_img,
    masks, mean_mask)."""
    b, c, h, w = img.shape
    count = count_t.reshape(-1)[0].to(torch.int64)
    masks = (_slot_of_pixel(index, h * w) >= count).to(torch.float32)
    masks = masks.reshape(b, 1, h, w).expand(img.shape)
    mean_pixel = compute_mean_pixel(img, masks, mean_option, mean_area)
    degrade_img = (1.0 - masks) * mean_pixel + masks * img
    return degrade_img, masks, mean_pixel.expand(img.shape)


def degrade_dependent_momentum_sampling(
    sample_t: torch.Tensor,
    sample_0: torch.Tensor,
    index_list: torch.Tensor,
    index_start,
    index_end,
    mean_option,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Composite degradation on a shared permutation (scheduler.py:326-376):
    pixels in slots [0, index_start) keep sample_t's values, [index_start,
    index_end) take sample_0's, and the rest are mean-filled. index_start,
    index_end: integers or 0-d tensors. Returns (noisy_img, mean_masks,
    mean_pixel broadcast to the image). The mean is a const or
    'non_degraded_area' (the reference's image-wise sum of the preserved
    pixels over the 1-channel degraded count and the channel count,
    negated); any other mode raises ValueError."""
    b, c, h, w = sample_t.shape
    slot = _slot_of_pixel(index_list, h * w).reshape(b, 1, h, w)
    start = torch.as_tensor(index_start, dtype=torch.int64, device=slot.device)
    end = torch.as_tensor(index_end, dtype=torch.int64, device=slot.device)
    masks_t = (slot < start).to(torch.float32)
    masks_0 = ((slot >= start) & (slot < end)).to(torch.float32)
    mask = (slot < end).to(torch.float32)
    preserved = sample_t * masks_t + sample_0 * masks_0

    mode, value = parse_mean_option(mean_option)
    if mode == "const":
        mean_pixel = torch.full((b, c, 1, 1), value, dtype=sample_t.dtype,
                                device=sample_t.device)
    elif mode == "non_degraded_area":
        sum_pixel = (preserved * mask).sum(dim=(1, 2, 3), keepdim=True)
        count = (1.0 - mask).sum(dim=(1, 2, 3), keepdim=True)
        mean_pixel = torch.where(count > 0, sum_pixel / count.clamp(min=1.0) / c * -1.0,
                                 torch.zeros_like(sum_pixel))
    else:
        raise ValueError(
            f"mean_option {mean_option!r} unsupported for dependent momentum sampling"
        )
    noisy_img = (1.0 - mask) * mean_pixel + preserved
    mean_masks = (1.0 - mask) * mean_pixel
    return noisy_img, mean_masks, mean_pixel.expand(sample_t.shape)
