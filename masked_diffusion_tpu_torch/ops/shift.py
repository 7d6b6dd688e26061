"""Mean-shift perturbations (reference scheduler.py:612-777), NCHW.

Counterpart of masked_diffusion_tpu/ops/shift.py. Each of the six families
has two forms:

  shift_from_draws(...)  takes its random draws as tensors — the form the
                         tests feed with the JAX package's draws;
  schedule_shift(...)    draws them from a torch.Generator and calls the
                         form above.

Every family is scaled by ratio_list[t-1] and broadcast to the image shape.
The JAX package's deliberate divergences from the reference hold here too:
channel counts come from the shape, 'noise_with_perturbation' discards its
perturbation term unless combine_perturbation=True (scheduler.py:708 vs :713),
and 'noise_std_reduction' is vectorised over the batch.

The interpolation sampler's shift (schedule_shift_interpolation) draws
nothing: a constant times the ratio, clamped around each latent's mean.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

SHIFT_TYPES = (
    "1-d_constant",
    "3-d_constant",
    "noise_reduction",
    "noise_std_reduction",
    "noise_with_perturbation",
    "non_shift",
)


def draw_shapes(shift_type: str, shape: Tuple[int, int, int, int]):
    """Shapes of the draws `shift_from_draws` takes for an NCHW `shape`:
    (uniform-in-[-1,1] shape or None, standard-normal shape or None)."""
    b, c, h, w = shape
    return {
        "1-d_constant": ((b,), None),
        "3-d_constant": ((b, c, 1, 1), None),
        "noise_reduction": (None, (b, 1, h, w)),
        "noise_std_reduction": (None, (b, c, h, w)),
        "noise_with_perturbation": ((b, 1, 1, 1), (b, c, h, w)),
        "non_shift": (None, None),
    }[shift_type]


def shift_from_draws(
    shift_type: str,
    ratios_t: torch.Tensor,
    shape: Tuple[int, int, int, int],
    uniform: Optional[torch.Tensor] = None,
    normal: Optional[torch.Tensor] = None,
    noise_mean: float = 0.0,
    dtype=torch.float32,
    combine_perturbation: bool = False,
) -> torch.Tensor:
    """The shift field (B, C, H, W) from given draws.

    uniform: draws in [-1, 1) of draw_shapes(...)[0]; normal: standard-normal
    draws of draw_shapes(...)[1]. ratios_t: (B,) ratio_list[t-1].
    """
    if shift_type not in SHIFT_TYPES:
        raise ValueError(f"unknown shift_type: {shift_type!r}")
    r = ratios_t.float()[:, None, None, None]

    if shift_type == "1-d_constant":
        shift = (uniform * ratios_t.float())[:, None, None, None]
    elif shift_type == "3-d_constant":
        shift = uniform * r
    elif shift_type == "noise_reduction":
        shift = (noise_mean + normal) * r
    elif shift_type == "noise_std_reduction":
        shift = noise_mean + normal * r
    elif shift_type == "noise_with_perturbation":
        rand = noise_mean + normal
        if combine_perturbation:
            shift = (uniform + rand) * r
        else:
            # reference effective behaviour: perturbation drawn, then discarded
            shift = rand * r
    else:  # non_shift
        shift = torch.zeros((shape[0], 1, 1, 1), device=ratios_t.device)
    return shift.to(dtype).expand(shape)


def schedule_shift(
    generator: torch.Generator,
    ratios_t: torch.Tensor,
    shape: Tuple[int, int, int, int],
    shift_type: str,
    noise_mean: float = 0.0,
    dtype=torch.float32,
    combine_perturbation: bool = False,
) -> torch.Tensor:
    """Draw the per-step shift field (B, C, H, W) on ratios_t's device."""
    if shift_type not in SHIFT_TYPES:
        raise ValueError(f"unknown shift_type: {shift_type!r}")
    u_shape, n_shape = draw_shapes(shift_type, shape)
    dev = ratios_t.device
    uniform = normal = None
    if u_shape is not None:
        uniform = torch.rand(u_shape, generator=generator, device=dev) * 2.0 - 1.0
    if n_shape is not None:
        normal = torch.randn(n_shape, generator=generator, device=dev)
    return shift_from_draws(
        shift_type, ratios_t, shape, uniform, normal, noise_mean, dtype,
        combine_perturbation,
    )


def schedule_shift_interpolation(
    ratios_t: torch.Tensor,
    mu: torch.Tensor,
    interpolation_shift: float,
    shape: Tuple[int, int, int, int],
    dtype=torch.float32,
) -> torch.Tensor:
    """Deterministic interpolation shift clamped around the latent mean
    (scheduler.py:735-754): shift = c * ratio, clamped to [-mu-r, -mu+r],
    broadcast to the NCHW `shape`. ratios_t, mu: (B,)."""
    r = ratios_t.to(torch.float32)
    shift = torch.full((shape[0],), float(interpolation_shift), device=r.device) * r
    mu = mu.to(torch.float32).reshape(-1)
    shift = torch.clamp(shift, -1.0 * mu - r, -1.0 * mu + r)
    return shift[:, None, None, None].to(dtype).expand(shape)


def perturb_shift(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x + shift (scheduler.py:757-766)."""
    return data + shift


def perturb_shift_inverse(data: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """x - shift (scheduler.py:769-777)."""
    return data - shift
