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
  - adam and adamw (weight decay 0.01 on every parameter, eps 1e-8) are
    torch.optim's, whose update equals optax's; plain sgd is optax's
    p - lr * g in foreach ops (a torch.optim.SGD holds its param_groups);
  - gradient accumulation as MultiSteps: the k micro-step gradients sum
    in .grad (under DistributedDataParallel's no_sync too), and on the k-th
    micro step their mean, the sum over k, goes through clip + optimizer;
    parameters stay put on the others. optax's Welford running mean
    acc + (g - acc)/(n + 1) is the same mean up to rounding;
  - the LR is the schedule at the optimizer's update count from 0, as optax
    evaluates it, so it advances once per update.

The counts are host numbers; the LR the base optimizer reads is a 0-d
tensor on the parameters' device (`Optimizer.lr_tensor`: float32 on a card,
float64 on the CPU, the host number it was), so an update makes no
host-device transfer and no host sync, and its device work
(`Optimizer.apply_update`) can be captured into a CUDA graph as it is:
on a card Adam and AdamW run torch's capturable form (their step counts on
the device); torch's SGD would read a tensor LR on the host, so SGD's
update is the port's own on every device. The gradients are static
tensors: made once, zeroed in place where a window starts, summed into by
backward (train/step.py:make_train_epoch replays the same tensors). Under tensor
parallelism the clip's norm is the whole logical gradient's
(Optimizer.set_tensor_parallel), so it scales as in one process.

`Optimizer.state_dict` is what a checkpoint keeps of it (optax keeps the
same in MultiSteps' opt_state): the base optimizer's per-parameter state
(AdamW's exp_avg, exp_avg_sq and step), the update `count` that drives the
LR, `mini_step`, and inside an accumulation window the summed .grad, so that
a run resumed there finishes the window as the uninterrupted run does.
Tensors are keyed "<parameter name>.<key>" by the model's parameter names
(the diffusers names of io/weights.py), never by position.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[Sequence[bool]] = None, group=None) -> torch.Tensor:
    """Scale grads in place by min(1, max_norm/||g||) (optax's rule: kept
    as they are below the norm). Returns the global norm (a device scalar).
    Under tensor parallelism (parallel/tp.py) `sharded` marks the gradients
    that are this rank's slices: their squared norms are summed over the
    model `group` (collective), the replicated ones count once, so the norm
    is the whole logical gradient's."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is None or not any(sharded):
        norm = torch.linalg.vector_norm(norms)
    else:
        from masked_diffusion_tpu_torch.parallel.mesh import all_reduce_sum

        mask = torch.tensor(list(sharded), device=norms.device)
        sq = norms.square()
        norm = (sq[~mask].sum() + all_reduce_sum(sq[mask].sum(), group)).sqrt()
    scale = torch.clamp(max_norm / norm, max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """clip + base optimizer + MultiSteps accumulation over `params`.

    Before backward, `zero_grad()` zeroes .grad in place where a window
    starts, so backward sums the micro steps' gradients there. After it,
    `update()` on every k-th call divides the sum by k, clips it (.grad
    keeps the clipped mean until the next window), sets the LR to
    schedule(count) and steps the base optimizer. `count` is the number of
    updates made (the LR schedule's step), `mini_step` the micro steps
    since the last one. The device work and the host counts come apart for
    a CUDA graph: `zero_grads` and `apply_update(lr)` are the device work,
    `advance()` the counts, and `windows(n)` says from the counts what the
    next n micro steps do, the one statement of MultiSteps' window rule."""

    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        base: torch.optim.Optimizer,
        schedule: Callable[[int], float],
        grad_clip_norm: Optional[float] = 1.0,
        gradient_accumulation_steps: int = 1,
        names: Optional[Sequence[str]] = None,
    ):
        self.params = list(params)
        # tensor parallelism (set_tensor_parallel): which gradients are slices
        self.sharded: Optional[List[bool]] = None
        self.model_group = None
        self.names = list(names) if names is not None else None
        if self.names is not None and len(self.names) != len(self.params):
            raise ValueError(f"{len(self.names)} names for {len(self.params)} parameters")
        self.base = base
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.every_k = max(1, int(gradient_accumulation_steps))
        self.count = 0
        self.mini_step = 0
        self._lr: Optional[torch.Tensor] = None

    def set_tensor_parallel(self, sharded_names: Sequence[str], model_group) -> None:
        """The updates of a model that parallel/tp.py:shard_module converted:
        `sharded_names` are its sharded parameters (needs names=),
        `model_group` the plan's. The clip then takes the whole logical
        gradient's norm, and the replicated parameters' gradients are
        averaged over the model group first: every rank computes them from
        the same values, but a card's nondeterministic backward kernels (cuDNN
        weight gradients) may round them apart, and replicated parameters
        must stay equal on every rank of the group."""
        if self.names is None:
            raise ValueError("set_tensor_parallel needs the parameter names (names=)")
        names = set(sharded_names)
        self.sharded = [n in names for n in self.names]
        self.model_group = model_group

    def _average_replicated(self, grads: List[torch.Tensor]) -> None:
        """grads of the replicated parameters, in place: their mean over the
        model group, in one all-reduce of them packed flat (collective)."""
        import torch.distributed as dist

        from masked_diffusion_tpu_torch.parallel.mesh import all_reduce_sum

        repl = [g for g, s in zip(grads, self.sharded) if not s]
        if not repl:
            return
        flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in repl]), self.model_group)
        flat /= dist.get_world_size(self.model_group)
        for g, part in zip(repl, flat.split([g.numel() for g in repl])):
            g.copy_(part.view_as(g))

    def lr_tensor(self) -> torch.Tensor:
        """The 0-d LR that the updates read, on the parameters' device:
        float32 on a card (the capturable optimizers' dtype), float64 on the
        CPU (the host number it was)."""
        dev = self.params[0].device
        if self._lr is None or self._lr.device != dev:
            dtype = torch.float64 if dev.type == "cpu" else torch.float32
            self._lr = torch.zeros((), dtype=dtype, device=dev)
        return self._lr

    def windows(self, n: int) -> List[Tuple[bool, bool, int]]:
        """(starts, closes, count) of each of the next n micro steps, from
        the counts and without changing them: whether it starts an
        accumulation window (zeroes the gradients), whether it closes one
        (updates), and the update count the LR schedule reads there."""
        mini, count, out = self.mini_step, self.count, []
        for _ in range(n):
            closes = mini + 1 >= self.every_k
            out.append((mini == 0, closes, count))
            mini, count = (0, count + 1) if closes else (mini + 1, count)
        return out

    def zero_grad(self) -> None:
        """Zero .grad where an accumulation window starts (on every call
        when k = 1); inside a window the micro steps' gradients sum there."""
        if self.windows(1)[0][0]:
            self.zero_grads()

    @torch.no_grad()
    def zero_grads(self) -> None:
        """Every parameter's .grad zeroed in place, made where missing: the
        same tensors from step to step, which backward sums into."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in self.params])

    @torch.no_grad()
    def update(self) -> bool:
        """Consume the micro step's gradients; True when parameters moved."""
        _, closes, count = self.windows(1)[0]
        if closes:
            lr = self.lr_tensor()
            lr.fill_(self.schedule(count))
            self.apply_update(lr)
        self.advance()
        return closes

    def advance(self) -> None:
        """The host counts of one micro step: mini_step, and count where the
        window closes."""
        _, closes, _ = self.windows(1)[0]
        if closes:
            self.count, self.mini_step = self.count + 1, 0
        else:
            self.mini_step += 1

    @torch.no_grad()
    def apply_update(self, lr: torch.Tensor) -> None:
        """The device work of a window's closing micro step: the summed
        gradients' mean over the window, the clip, and the base optimizer's
        step at `lr` (a 0-d tensor on the parameters' device). No host
        sync, so a CUDA graph captures it as it is."""
        # a parameter the loss did not reach has a zero gradient, as in JAX
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.every_k > 1:
            torch._foreach_div_(grads, float(self.every_k))
        if self.sharded is not None:
            self._average_replicated(grads)
        if self.grad_clip_norm is not None:
            clip_by_global_norm_(grads, self.grad_clip_norm, self.sharded, self.model_group)
        for p, g in zip(self.params, grads):
            p.grad = g
        if isinstance(self.base, torch.optim.SGD):
            # optax's sgd; torch's would take a tensor LR as a host number
            # (an item() sync)
            torch._foreach_sub_(self.params, torch._foreach_mul(grads, lr))
            return
        self._capturable()
        for group in self.base.param_groups:
            group["lr"] = lr
        with warnings.catch_warnings():
            # torch warns that a capturable optimizer also runs eagerly: it
            # does, whenever a step is not replayed from a graph
            warnings.filterwarnings("ignore", message=".*capturable=True.*")
            self.base.step()

    def _capturable(self) -> None:
        """Adam and AdamW on a card in torch's capturable form (the step
        counts on the device, the LR read as a tensor), with any step count
        of a state made otherwise moved to its parameter's device."""
        dev = self.params[0].device
        if dev.type == "cpu" or not isinstance(self.base, (torch.optim.Adam, torch.optim.AdamW)):
            return
        if all(g["capturable"] for g in self.base.param_groups):
            return
        for group in self.base.param_groups:
            group["capturable"] = True
            for p in group["params"]:
                st = self.base.state.get(p, {})
                if "step" in st:
                    st["step"] = st["step"].to(device=p.device, dtype=torch.float32)

    def state_dict(self) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(tensors, scalars): the base optimizer's per-parameter tensors and,
        inside an accumulation window, each parameter's summed .grad (None
        grads are left out), keyed "<name>.<key>"; and the counters and the
        base optimizer's hyperparameters, JSON-able. The tensors are the
        live ones: copy them before the next step."""
        if self.names is None:
            raise ValueError("Optimizer.state_dict needs the parameter names (names=)")
        tensors: Dict[str, torch.Tensor] = {}
        for name, p in zip(self.names, self.params):
            for key, value in self.base.state.get(p, {}).items():
                if isinstance(value, torch.Tensor):
                    tensors[f"{name}.{key}"] = value
            if self.mini_step > 0 and p.grad is not None:
                tensors[f"{name}.grad"] = p.grad
        groups = [{k: float(v) if isinstance(v, torch.Tensor) else v
                   for k, v in g.items() if k != "params"}
                  for g in self.base.state_dict()["param_groups"]]
        scalars = {"count": self.count, "mini_step": self.mini_step, "every_k": self.every_k,
                   "base": type(self.base).__name__, "param_groups": groups}
        return tensors, scalars

    def load_state_dict(self, tensors: Dict[str, torch.Tensor], scalars: dict) -> None:
        """Restore what state_dict returned, onto the parameters' devices.
        Raises on another base optimizer, another accumulation length, or a
        tensor of no parameter."""
        if self.names is None:
            raise ValueError("Optimizer.load_state_dict needs the parameter names (names=)")
        if scalars["base"] != type(self.base).__name__ or scalars["every_k"] != self.every_k:
            raise ValueError(
                f"optimizer state of {scalars['base']} with accumulation {scalars['every_k']}, "
                f"this run has {type(self.base).__name__} with {self.every_k}")
        index = {name: i for i, name in enumerate(self.names)}
        state: Dict[int, dict] = {}
        grads: Dict[int, torch.Tensor] = {}
        for full, value in tensors.items():
            name, key = full.rsplit(".", 1)
            if name not in index:
                raise KeyError(f"optimizer state for {name!r}, which is no parameter here")
            if key == "grad":
                grads[index[name]] = value
            else:
                state.setdefault(index[name], {})[key] = value
        groups = self.base.state_dict()["param_groups"]
        # torch places each tensor on its parameter's device and dtype (a
        # step count stays where torch keeps it)
        self.base.load_state_dict({"state": state, "param_groups": groups})
        with torch.no_grad():
            for i, p in enumerate(self.params):
                g = grads.get(i)
                p.grad = None if g is None else g.to(p.device, p.dtype, copy=True)
        self.count = int(scalars["count"])
        self.mini_step = int(scalars["mini_step"])


def build_optimizer(
    optim_name: str,
    params: Iterable[torch.nn.Parameter],
    schedule: Callable[[int], float],
    grad_clip_norm: Optional[float] = 1.0,
    gradient_accumulation_steps: int = 1,
    names: Optional[Sequence[str]] = None,
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
    return Optimizer(params, base, schedule, grad_clip_norm, gradient_accumulation_steps,
                     names)
