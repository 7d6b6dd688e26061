"""Optimizers and LR schedules, as optax defines them.

Counterpart of masked_diffusion_tpu/train/optim.py, which mirrors the
reference's get_optimizer / get_lr_scheduler (main_train_masked.py:134-165):

  cosine      : linear warmup, then 0.5*(1+cos(pi * cycles * 2 * progress))
  hard_cosine : warmup, then cosine with hard restarts over `cycles`
  constant    : warmup to lr, then flat
  linear      : warmup, then linear decay to 0

`build_optimizer` composes what the JAX package chains in optax:

  optax.MultiSteps(chain(clip_by_global_norm(1.0), adam|adamw|sgd), k)

  - clip: g * max/||g|| where ||g|| >= max (optax's formula, not
    clip_grad_norm_'s max/(||g|| + 1e-6)), the global norm over every
    gradient, computed on the device;
  - adam, adamw (weight decay 0.01 on every parameter, eps 1e-8) and plain
    sgd are torch.optim's, whose update equals optax's;
  - gradient accumulation as MultiSteps: the running mean of k micro-step
    gradients (optax's Welford update acc + (g - acc)/(n + 1)) goes through
    clip + optimizer on the k-th micro step, and parameters stay put on the
    others;
  - the LR is the schedule at the optimizer's update count from 0, as optax
    evaluates it, so it advances once per update.

The LR and every count are host numbers: a step makes no host-device
transfer.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Optional

import torch


def build_lr_schedule(
    name: str,
    lr: float,
    warmup_steps: int,
    total_steps: int,
    num_cycles: float = 0.5,
) -> Callable[[int], float]:
    """step -> learning rate (a host float)."""
    if name not in ("cosine", "hard_cosine", "constant", "linear"):
        raise ValueError(f"unknown lr_scheduler: {name!r}")
    warmup_steps = max(0, int(warmup_steps))

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return lr * step / max(1.0, warmup_steps)
        denom = max(1.0, total_steps - warmup_steps)
        progress = min(max((step - warmup_steps) / denom, 0.0), 1.0)
        if name == "cosine":
            decay = max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))
        elif name == "hard_cosine":
            if progress >= 1.0:
                decay = 0.0
            else:
                cyc = math.fmod(progress * num_cycles, 1.0)
                decay = max(0.0, 0.5 * (1.0 + math.cos(math.pi * cyc)))
        elif name == "constant":
            decay = 1.0
        else:  # linear
            decay = 1.0 - progress
        return lr * decay

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm/||g||) (optax's rule: kept
    as they are below the norm). Returns the global norm (a device scalar)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """clip + base optimizer + MultiSteps accumulation over `params`.

    After backward, `update()` takes the parameters' .grad: it accumulates
    them and, on every k-th call, clips the mean, sets the LR to
    schedule(count) and steps the base optimizer. `count` is the number of
    updates made (the LR schedule's step), `mini_step` the micro steps since
    the last one."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        base: torch.optim.Optimizer,
        schedule: Callable[[int], float],
        grad_clip_norm: Optional[float] = 1.0,
        gradient_accumulation_steps: int = 1,
    ):
        self.params = list(params)
        self.base = base
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.every_k = max(1, int(gradient_accumulation_steps))
        self.count = 0
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def update(self) -> bool:
        """Consume the micro step's gradients; True when parameters moved."""
        # a parameter the loss did not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.every_k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_add_(self._acc, diff, alpha=1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return False
            grads = self._acc
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(grads, self.grad_clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.base.param_groups:
            group["lr"] = lr
        self.base.step()
        self.count += 1
        if self._acc is not None:
            self.mini_step = 0
            self.zero_grad()  # the accumulator is the next round's zero
            torch._foreach_zero_(self._acc)
        return True


def build_optimizer(
    optim_name: str,
    params: Iterable[torch.nn.Parameter],
    schedule: Callable[[int], float],
    grad_clip_norm: Optional[float] = 1.0,
    gradient_accumulation_steps: int = 1,
) -> Optimizer:
    params = list(params)
    name = optim_name.lower()
    if name == "sgd":
        base = torch.optim.SGD(params, lr=0.0)
    elif name == "adam":
        base = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        # torch.optim.AdamW's default weight_decay=0.01, as the reference uses
        # it (main_train_masked.py:139-140) and optax.adamw is configured
        base = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    else:
        raise ValueError(f"unknown optimizer: {optim_name!r}")
    return Optimizer(params, base, schedule, grad_clip_norm, gradient_accumulation_steps)
