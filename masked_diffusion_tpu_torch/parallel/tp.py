"""Tensor parallelism: wide layers channel-sharded over a model group.

Counterpart of masked_diffusion_tpu/parallel/tp.py. The JAX package shards
every leaf whose output-feature axis is at least --tp_min_features wide and
divisible by the model axis (`leaf_sharding`, :34-40) and lets GSPMD insert
the collectives. The port does the same by hand, Megatron-style, on the M
ranks of a model group (parallel/mesh.py):

  * the rule: `leaf_sharded(shape, M, min_features)` on the port's layouts,
    whose output-feature axis is dim 0 of a Conv2d weight (O, I, kh, kw), of
    a Linear weight (O, I), and the only axis of a bias or a GroupNorm weight
    or bias. It picks the tensors that JAX's rule picks on its HWIO / (I, O)
    layouts (tests/test_torch_port_parallel.py holds the two sets equal
    through io/weights.flax_layout's names);
  * `shard_module` converts a built UNet in place. Each sharded Conv2d and
    Linear becomes column-parallel: the rank keeps its output slice of the
    weight and bias, computes its output channels and all-gathers them over
    the model group. Two autograd Functions carry the Megatron pair: the
    input is copied to the group (identity forward, all-reduce of the input
    gradient backward) and the output gathered from it (all-gather forward;
    the backward keeps the rank's own slice and does not sum, because
    everything after the gather is computed identically on every rank). A
    sharded GroupNorm weight and bias are all-gathered where they are used,
    so kernel 2 runs on full channels as under data parallelism (the
    activations stay whole: TP divides the parameters, their AdamW moments
    and their EMA by M, not the activations);
  * `sharded_fraction` is the share of bytes stored sharded, counted as JAX
    counts it;
  * `shard_state` / `join_state` and their collective forms `scatter_state`
    / `gather_state` turn sharded model, EMA and optimizer tensors into the
    one-process layout and back, so a checkpoint written under any mesh is
    today's layout and restores under any other.

Parameter names do not change. The optimizer averages the replicated
parameters' gradients over the model group (equal in exact arithmetic; a
card's nondeterministic backward kernels may round them apart) and takes
the clip's norm over the whole logical gradient (train/optim.py: the
sharded gradients' squared norms are all-reduced over the model group), DDP
wraps the model over the data group only (train/step.py), and the EMA copy
updates its local slices.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

import torch
import torch.nn as nn

from masked_diffusion_tpu_torch.models.unet import GroupNormAct
from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from masked_diffusion_tpu_torch.parallel.mesh import (
    MeshPlan,
    PlanRef,
    all_gather_list,
    all_gather_rows,
    all_reduce_sum,
)


def leaf_sharded(shape: Sequence[int], model_size: int, min_features: int = 256) -> bool:
    """JAX's by-shape rule on the port's layouts: the output-feature axis
    (dim 0) is at least min_features wide and divisible by model_size > 1."""
    return (model_size > 1 and len(shape) >= 1 and shape[0] >= min_features
            and shape[0] % model_size == 0)


def sharded_fraction(tensors: Iterable[torch.Tensor], model_size: int,
                     min_features: int = 256) -> float:
    """The share of the tensors' bytes (full, one-process shapes) stored
    sharded rather than replicated: what TP buys in per-rank memory."""
    total = sharded = 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        total += nbytes
        if leaf_sharded(t.shape, model_size, min_features):
            sharded += nbytes
    return sharded / total if total else 0.0


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the input gradient over the
    model group (each rank's part comes from its output channels)."""

    @staticmethod
    def forward(ctx, x, ref):
        ctx.ref = ref
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.ref.plan.model_group), None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather of every rank's slice along `dim` over the model group;
    the backward keeps this rank's slice of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, dim, ref):
        plan = ref.plan
        ctx.dim, ctx.rank, ctx.n = dim, plan.model_rank, x.shape[dim]
        return all_gather_rows(x, dim, plan.model_group, plan.model_size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


def gather_from_group(x: torch.Tensor, dim: int, ref: PlanRef) -> torch.Tensor:
    return _GatherFromGroup.apply(x, dim, ref)


class ColumnParallelConv2d(nn.Conv2d):
    """A Conv2d holding its rank's output channels; its output is whole."""

    tp: PlanRef

    def forward(self, x):
        y = super().forward(_CopyToGroup.apply(x, self.tp))
        return gather_from_group(y, 1, self.tp)


class ColumnParallelLinear(nn.Linear):
    """A Linear holding its rank's output features; its output is whole."""

    tp: PlanRef

    def forward(self, x):
        y = super().forward(_CopyToGroup.apply(x, self.tp))
        return gather_from_group(y, y.dim() - 1, self.tp)


class ShardedGroupNormAct(GroupNormAct):
    """GroupNormAct holding its rank's slice of weight and bias, gathered
    (in one collective) where they are used: the norm (kernel 2) runs on
    full channels. Without a gradient (sampling) the gathered pair is kept
    until either parameter changes."""

    tp: PlanRef
    _full = None  # ((versions and addresses of weight, bias), gathered (2, C))

    def forward(self, x):
        w, b = self.weight, self.bias
        key = (w._version, b._version, w.data_ptr(), b.data_ptr(), w.dtype)
        if torch.is_grad_enabled() or self._full is None or self._full[0] != key:
            full = gather_from_group(torch.stack([w, b]), 1, self.tp)
            self._full = None if torch.is_grad_enabled() else (key, full)
        else:
            full = self._full[1]
        return group_norm_silu(x, full[0], full[1], self.num_groups, self.eps, self.silu)


_COLUMN = {nn.Conv2d: ColumnParallelConv2d, nn.Linear: ColumnParallelLinear,
           GroupNormAct: ShardedGroupNormAct}


@torch.no_grad()
def shard_module(model: nn.Module, plan: MeshPlan, min_features: int = 256) -> List[str]:
    """Convert `model` in place: every Conv2d, Linear and GroupNormAct whose
    output width passes leaf_sharded keeps model rank j's slice [j*O/M,
    (j+1)*O/M) of its weight and bias and becomes its column-parallel form.
    Records and returns the sharded parameter names (model.tp_sharded)."""
    ref, m, j = PlanRef(plan), plan.model_size, plan.model_rank
    names = []
    for name, module in list(model.named_modules()):
        cls = _COLUMN.get(type(module))
        if cls is None or not leaf_sharded(module.weight.shape, m, min_features):
            continue
        n = module.weight.shape[0] // m
        for pname in ("weight", "bias"):
            p = getattr(module, pname)
            if p is not None:
                setattr(module, pname, nn.Parameter(p.detach()[j * n:(j + 1) * n].clone(),
                                                    requires_grad=p.requires_grad))
                names.append(f"{name}.{pname}")
        module.__class__ = cls
        module.tp = ref
        if isinstance(module, nn.Conv2d):
            module.out_channels = n
        elif isinstance(module, nn.Linear):
            module.out_features = n
    model.tp_sharded = tuple(names)
    return names


def _param_of(key: str, value: torch.Tensor, sharded) -> bool:
    """Whether a state tensor is sharded: a sharded parameter itself, or a
    per-parameter tensor "<name>.<key>" of one (AdamW's moments, a .grad)
    of one or more dimensions (the step count stays whole)."""
    return value.dim() > 0 and (key in sharded or key.rsplit(".", 1)[0] in sharded)


def shard_state(state: Dict[str, torch.Tensor], sharded: Iterable[str], model_size: int,
                model_rank: int) -> Dict[str, torch.Tensor]:
    """One-process tensors -> model rank `model_rank`'s: each sharded one
    cut to its dim-0 slice, the others as they are."""
    sharded = set(sharded)
    out = {}
    for k, v in state.items():
        if _param_of(k, v, sharded):
            n = v.shape[0] // model_size
            v = v[model_rank * n:(model_rank + 1) * n].clone()
        out[k] = v
    return out


def join_state(parts: Sequence[Dict[str, torch.Tensor]],
               sharded: Iterable[str]) -> Dict[str, torch.Tensor]:
    """Every model rank's tensors, in model rank order -> the one-process
    tensors: each sharded one concatenated along dim 0."""
    sharded = set(sharded)
    return {k: torch.cat([p[k] for p in parts]) if _param_of(k, v, sharded) else v
            for k, v in parts[0].items()}


def scatter_state(state: Dict[str, torch.Tensor], model: nn.Module,
                  plan: MeshPlan) -> Dict[str, torch.Tensor]:
    """shard_state for this rank of a model that shard_module converted
    (identity for any other)."""
    sharded = getattr(model, "tp_sharded", ())
    if not sharded:
        return state
    return shard_state(state, sharded, plan.model_size, plan.model_rank)


def gather_state(state: Dict[str, torch.Tensor], model: nn.Module,
                 plan: MeshPlan) -> Dict[str, torch.Tensor]:
    """join_state of the model group's tensors, on every rank of it
    (identity for a model shard_module did not convert). COLLECTIVE over
    the model group: one all-gather of the sharded tensors packed flat, a
    pack per dtype and device."""
    sharded = set(getattr(model, "tp_sharded", ()))
    if not sharded:
        return state
    packs: Dict[tuple, List[str]] = {}
    for k, v in state.items():
        if _param_of(k, v, sharded):
            packs.setdefault((v.dtype, v.device), []).append(k)
    out = dict(state)
    for keys in packs.values():
        flat = torch.cat([state[k].detach().reshape(-1) for k in keys])
        parts = all_gather_list(flat, plan.model_group, plan.model_size)
        offset = 0
        for k in keys:
            v = state[k]
            out[k] = torch.cat([p[offset:offset + v.numel()].view(v.shape) for p in parts])
            offset += v.numel()
    return out
