"""Masking schedules and the per-epoch timestep curriculum.

A copy of masked_diffusion_tpu/ops/schedule.py, whose module imports
jax.numpy: the four numpy table builders, build_schedule with its
schedule/selection coupling errors, and MaskSchedule with its loss-weight
table. The tables stay numpy (host-side, deduplicated, so T is
data-dependent); the views used inside the sampling loop and the train step
are tensors on a device the caller names.

Reference semantics (scheduler.py of hytae1993/masked-diffusion-model):
  linear      :103-109  np.linspace(1e-3, 1, T) float ratios
  log         :112-127  int pixel counts, dedup, last entry forced to H*W
  exponential :130-142  base**linspace(0,1,T) / last, float ratios
  sigmoid     :144-170  int counts via logistic, dedup, endpoints forced
  curriculum  :173-192  keep every 2^(scale-section)-th step, last forced to T
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

_INT_SCHEDULES = ("log", "sigmoid")
_RATIO_SCHEDULES = ("linear", "exponential")


def linear_schedule(num_steps: int) -> np.ndarray:
    return np.linspace(1e-3, 1.0, num_steps)


def log_schedule(num_steps: int, image_size: int) -> np.ndarray:
    if num_steps > image_size:
        raise ValueError(
            "Desired to remove number of pixels is greater than the size of input image."
        )
    x = np.linspace(1, image_size, num_steps)
    values = np.log(x)
    values = values - values.min() + 1
    values = values * (image_size / values.max())
    values = np.asarray(values, dtype=int)
    counts = np.array(sorted(set(values.tolist())))
    counts[-1] = image_size  # the last T removes every pixel
    return counts


def exponential_schedule(num_steps: int, base: float) -> np.ndarray:
    lin = np.linspace(0.0, 1.0, num_steps)
    exp = np.asarray(base, dtype=np.float64) ** lin
    return exp / exp[-1]


def sigmoid_schedule(num_steps: int, base: float, image_size: int) -> np.ndarray:
    if num_steps > image_size:
        raise ValueError(
            "Desired to remove number of pixels is greater than the size of input image."
        )
    i = np.arange(num_steps, dtype=np.float64)
    # np.exp saturates to inf (logistic -> 0) instead of raising at T=4096
    with np.errstate(over="ignore"):
        logistic = 1.0 / (1.0 + np.exp(-0.1 * base * (i - num_steps / 2)))
    result = (1 + (image_size - 1) * logistic).astype(int).tolist()
    min_val = min(result)
    result = [v - min_val + 1 for v in result]
    max_val = max(result)
    result = [v * image_size // max_val for v in result]
    result[0] = 1
    result[-1] = image_size
    return np.array(sorted(set(result)))


@dataclasses.dataclass(frozen=True)
class MaskSchedule:
    """Precomputed masking schedule.

    table: raw values indexed by t-1 — int pixel counts for log/sigmoid,
      float ratios for linear/exponential.
    ratios: the reference's ratio_list — counts/image_size for log, the raw
      table otherwise (integer counts for sigmoid, an observable quirk kept).
    """

    name: str
    image_size: int
    num_steps: int
    table: np.ndarray
    ratios: np.ndarray
    select_degrade_pixel: str

    # ------------------------------------------------------------- device views
    def table_tensor(self, device) -> torch.Tensor:
        dtype = torch.int32 if self.name in _INT_SCHEDULES else torch.float32
        return torch.as_tensor(np.asarray(self.table), dtype=dtype, device=device)

    def ratios_tensor(self, device) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(self.ratios, np.float32), dtype=torch.float32, device=device
        )

    def degrade_amount(self, timesteps: torch.Tensor) -> torch.Tensor:
        """table[t-1] for 'indexing' (int pixel counts), ratio_list[t-1] for
        'thresholding' (reference scheduler.py:88-100). 1-indexed timesteps;
        the result lies on the timesteps' device."""
        idx = timesteps.long() - 1
        if self.select_degrade_pixel == "indexing":
            return self.table_tensor(timesteps.device)[idx]
        return self.ratios_tensor(timesteps.device)[idx]

    def shift_ratio(self, timesteps: torch.Tensor) -> torch.Tensor:
        """ratio_list[t-1], the shift magnitude scale (scheduler.py:612-732)."""
        return self.ratios_tensor(timesteps.device)[timesteps.long() - 1]

    # ------------------------------------------------------------- curriculum
    def timesteps_for_epoch(self, epoch: int, epoch_length: int, scale: int) -> np.ndarray:
        """Hierarchical per-epoch timestep curriculum (scheduler.py:173-192):
        section s of `scale` keeps every 2^(scale-s)-th step, last forced to T."""
        T = self.num_steps
        section = math.ceil((epoch + 1) / (epoch_length / scale))
        exponent = max(0, scale - section)
        period = 2**exponent
        used = [i for i in range(1, T + 1) if i % period == 0]
        if not used:
            used = [T]
        used[-1] = T
        return np.asarray(used, dtype=np.int32)

    # ------------------------------------------------------------- loss weights
    def loss_weight_table(self, power_base: float, device="cpu") -> torch.Tensor:
        """power_base ** linspace(1, 0, T) in fp32 (scheduler.py:780-794)."""
        alpha = torch.linspace(1.0, 0.0, self.num_steps, dtype=torch.float32, device=device)
        base = torch.full((), float(power_base), dtype=torch.float32, device=device)
        return torch.pow(base, alpha)

    def loss_weights(self, timeindex: torch.Tensor, power_base: float) -> torch.Tensor:
        """Weights indexed by *timeindex* — the draw position within the
        epoch's used-timestep list, exactly as the reference trainers pass it
        (trainer_masked.py:136-138, trainer_masked_mean_shift.py:148)."""
        table = self.loss_weight_table(power_base, timeindex.device)
        return table[timeindex.long()]


def build_schedule(
    name: str,
    ddpm_num_steps: int,
    data_size: int,
    select_degrade_pixel: str = "indexing",
    schedule_base: float = 10.0,
) -> MaskSchedule:
    """Build the full schedule table host-side (scheduler.py:27-65)."""
    image_size = data_size * data_size

    if name == "linear":
        table = linear_schedule(ddpm_num_steps)
    elif name == "log":
        table = log_schedule(ddpm_num_steps, image_size)
    elif name == "exponential":
        table = exponential_schedule(ddpm_num_steps, schedule_base)
    elif name == "sigmoid":
        table = sigmoid_schedule(ddpm_num_steps, schedule_base, image_size)
    else:
        raise ValueError("Invalid mask ratio scheduler")

    ratios = table / image_size if name == "log" else np.asarray(table, np.float64)

    if select_degrade_pixel == "indexing" and name in _RATIO_SCHEDULES:
        raise ValueError(
            f"select_degrade_pixel='indexing' needs integer pixel-count schedules "
            f"(log/sigmoid); '{name}' produces float ratios. Use 'thresholding'."
        )
    if select_degrade_pixel == "thresholding" and name == "sigmoid":
        raise ValueError(
            "select_degrade_pixel='thresholding' with the sigmoid schedule compares "
            "uniform noise against integer pixel counts (always unmasked); use "
            "'indexing' for sigmoid."
        )
    if select_degrade_pixel not in ("indexing", "thresholding"):
        raise ValueError(f"unknown select_degrade_pixel: {select_degrade_pixel!r}")

    return MaskSchedule(
        name=name,
        image_size=image_size,
        num_steps=len(table),
        table=np.asarray(table),
        ratios=np.asarray(ratios, dtype=np.float64),
        select_degrade_pixel=select_degrade_pixel,
    )
