"""Mask generation and mean-fill degradation for training, NCHW.

Counterpart of masked_diffusion_tpu/ops/degrade.py, the parts the train step
uses (:96-113, :186-301). The sampling-time variants (:304-471) are not
ported yet; the fused sampling path (ops/fused_degrade.py) does not need
them.

  'indexing'     exactly k degraded pixels per image (k from the schedule's
                 integer table): the exact-k mask kernel (ops/kmask.py) on
                 CUDA, its plain version on the CPU, 1-channel, broadcast
                 over channels. masks_from_uniforms (:50-78) has no copy:
                 its exact-k law, ties broken by pixel index, is the
                 kernel's on composite keys
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

Random numbers: a CPU torch.Generator seeds everything (the mask kernel's
Philox seed, or a device generator for the thresholding uniforms); `bits`
(indexing) or `uniforms` (thresholding) inject the draws instead, as the
tests and the smoke check do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from masked_diffusion_tpu_torch.config import parse_mean_option
from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks


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
    if uniforms is None:
        gen = device_generator(generator or torch.Generator(), ratios.device)
        uniforms = torch.rand(shape, generator=gen, device=ratios.device)
    elif tuple(uniforms.shape) != shape:
        raise ValueError(f"uniforms must have shape {shape}, got {tuple(uniforms.shape)}")
    return (uniforms > ratios.to(torch.float32).reshape(batch, 1, 1, 1)).to(torch.float32)


def generate_masks(
    img: torch.Tensor,
    amount: torch.Tensor,
    select_degrade_pixel: str,
    degrade_channel: str,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masks broadcast to img's (B, C, H, W) shape. On CUDA, indexing always
    launches the exact-k mask kernel."""
    b, c, h, w = img.shape
    if select_degrade_pixel == "indexing":
        masks = exact_count_masks(b, h, w, amount.to(torch.int32), generator=generator,
                                  bits=bits)
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-time degradation (scheduler.py:266-323), img (B, C, H, W).

    Returns (degrade_img, masks, degrade_mask, mean_mask):
      degrade_img  = (1-m)*mu + m*x
      masks        = binary masks broadcast to x
      degrade_mask = (1-m)*mu + m       (mu on degraded pixels, 1 elsewhere)
      mean_mask    = mu everywhere
    """
    masks = generate_masks(img, amount, select_degrade_pixel, degrade_channel,
                           generator=generator, bits=bits, uniforms=uniforms)
    mean_pixel = compute_mean_pixel(img, masks, mean_option, mean_area)
    inv = 1.0 - masks
    degrade_img = inv * mean_pixel + masks * img
    degrade_mask = inv * mean_pixel + masks
    mean_mask = mean_pixel.expand(img.shape)
    return degrade_img, masks, degrade_mask, mean_mask
