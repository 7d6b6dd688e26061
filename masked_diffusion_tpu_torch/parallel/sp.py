"""Spatial partitioning: UNet activations split along image height over a
model group.

Counterpart of masked_diffusion_tpu/parallel/sp.py, for images whose UNet
activations outgrow one card. The JAX package pins the UNet input to
P('data', 'model') on NHWC and lets GSPMD partition the convolutions,
norms and attention. The port does it by hand on the M ranks of a model
group (parallel/mesh.py), keeping the parameters, their AdamW moments and
the EMA replicated (the opposite trade from parallel/tp.py):

  * the split: a UNet activation (B, C, H, W) on model rank j holds rows
    [j*H/M, (j+1)*H/M). A level is split only where M divides its height
    (and a stride-2 downsample into it sees an even number of local rows);
    from the first level that cannot be split (the flagship's 2x2 at M = 4)
    the activation is all-gathered, the deeper levels and their skips run
    replicated, and the up path slices back where splitting resumes
    (`split_levels`; rank 0 prints the levels in one `sp:` line);
  * 3x3 convolutions (stride 1, and the stride-2 Downsample) exchange one
    halo row with each neighbour, zeros at the image's edges; the backward
    sends the halo rows' gradients back and adds them. The Upsample's
    nearest x2 is local before its conv; 1x1 convolutions and the time
    embedding are local or replicated;
  * GroupNorm runs kernels 2 and 2b in their split modes
    (ops/groupnorm.py:group_norm_split and group_norm_split_backward), two
    launches a pass with one all-reduce of a (2, B*G) fp32 tensor over the
    model group between them: the forward's per-(image, group) sums of x
    and x^2 over the local rows, then the local rows normalised with the
    statistics over the whole image's count; the backward's per-group sums
    of gamma * dy and gamma * dy * x^ from the saved x and global
    statistics, then dx. CPU tensors take the passes' plain versions. Norms
    at replicated levels and inside attention run kernel 2 whole;
  * attention all-gathers the block's input over the model group, runs the
    block whole (kernel 4 where models/unet.attention_route says "kernel")
    and keeps the local rows;
  * the UNet takes whole images: conv_in reads its rows (and halo) of the
    input on each rank, and conv_out's rows are all-gathered, so the
    output is whole. The image-sized work around the UNet (timestep draws,
    the degrade, the shift, the reverse loop's carries, captured
    trajectories) stays whole on every rank of the model group: kernels 1
    and 3 select exactly k pixels of a whole image.

Gradients: each rank's backward yields its rows' share of every parameter's
gradient. Where a region runs replicated, its gradient enters through the
slice back into the split layout, which passes only the rank's own rows, and
leaves through the gather, whose backward sums the full-tensor gradients
over the group and keeps the rank's rows; the halo, statistics and gather
backwards carry every cross-rank term. The shares sum to the data rank's
gradient; DDP over all D x M ranks averages them, so the train step scales
its loss by M before the backward (train/step.py).

`split_module` converts a built UNet in place (module classes swap, the
parameter names stay); `validate_spatial` raises the JAX package's two
errors with its words.
"""

from __future__ import annotations

import functools
import json
from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from masked_diffusion_tpu_torch.models.unet import (
    AttentionBlock,
    Downsample,
    GroupNormAct,
    ResnetBlock,
    Upsample,
)
from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_split, group_norm_split_backward
from masked_diffusion_tpu_torch.parallel.mesh import (
    MeshPlan,
    PlanRef,
    all_gather_list,
    all_gather_rows,
    all_reduce_sum,
)
from masked_diffusion_tpu_torch.parallel.tp import gather_from_group

#: what runs where on split levels, for the `sp:` line
ROUTES = {"conv3x3": "halo exchange of one row a side",
          "group_norm": "kernels 2/2b in split mode around an all-reduce of fp32 sums",
          "attention": "block input all-gathered, the block whole, local rows kept",
          "unet_io": "conv_in reads its rows of the whole input; conv_out all-gathered"}


def validate_spatial(plan: MeshPlan, height: int) -> None:
    """Fail fast on topologies spatial partitioning cannot serve: a model
    axis of 1, or a height the model axis does not divide."""
    m = plan.model_size
    if m <= 1:
        raise ValueError(
            "--mesh_spatial shards image height over the 'model' mesh axis, "
            f"but the mesh has model={m}; set --mesh_model > 1 (e.g. "
            "--mesh_data 4 --mesh_model 2 on 8 chips)"
        )
    if height % m != 0:
        raise ValueError(
            f"--mesh_spatial needs image height {height} divisible by the "
            f"model axis ({m}); pick a mesh whose model size divides H"
        )


def level_heights(height: int, n_levels: int) -> List[int]:
    """Each UNet level's height: stride-2 convolutions with padding 1."""
    heights = [height]
    for _ in range(n_levels - 1):
        heights.append((heights[-1] + 1) // 2)
    return heights


def split_levels(height: int, n_levels: int, model_size: int) -> Tuple[bool, ...]:
    """Whether each level's activations are split over model_size ranks."""
    heights = level_heights(height, n_levels)
    split = [heights[0] % model_size == 0]
    for prev, h in zip(heights, heights[1:]):
        split.append(split[-1] and h % model_size == 0 and (prev // model_size) % 2 == 0)
    return tuple(split)


class _HaloRows(torch.autograd.Function):
    """(B, C, h, W) local rows -> (B, C, h + 2, W): the row above from the
    previous rank and the row below from the next, zeros at the image's
    edges. The backward returns each halo row's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, ref):
        plan = ref.plan
        ctx.ref = ref
        j, m = plan.model_rank, plan.model_size
        parts = all_gather_list(torch.cat([x[:, :, :1], x[:, :, -1:]], 2), plan.model_group, m)
        zero = torch.zeros_like(x[:, :, :1])
        top = parts[j - 1][:, :, 1:2] if j > 0 else zero
        bottom = parts[j + 1][:, :, :1] if j < m - 1 else zero
        return torch.cat([top, x, bottom], 2)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.ref.plan
        j, m = plan.model_rank, plan.model_size
        parts = all_gather_list(torch.cat([g[:, :, :1], g[:, :, -1:]], 2), plan.model_group, m)
        dx = g[:, :, 1:-1].clone()
        if j > 0:  # the previous rank's bottom halo is this rank's first row
            dx[:, :, :1] += parts[j - 1][:, :, 1:2]
        if j < m - 1:  # the next rank's top halo is this rank's last row
            dx[:, :, -1:] += parts[j + 1][:, :, :1]
        return dx, None


class _GatherRows(torch.autograd.Function):
    """Local rows -> the whole activation, entering a replicated region.
    Its gradient arrives as this rank's share of the whole tensor's: the
    backward sums the shares over the group and keeps the local rows."""

    @staticmethod
    def forward(ctx, x, ref):
        plan = ref.plan
        ctx.ref, ctx.n = ref, x.shape[2]
        return all_gather_rows(x, 2, plan.model_group, plan.model_size)

    @staticmethod
    def backward(ctx, g):
        plan = ctx.ref.plan
        g = all_reduce_sum(g, plan.model_group)
        return g.narrow(2, plan.model_rank * ctx.n, ctx.n).contiguous(), None


class _SliceRows(torch.autograd.Function):
    """The whole activation -> this rank's rows, leaving a replicated
    region; the backward passes only those rows' gradient (zeros elsewhere)."""

    @staticmethod
    def forward(ctx, x, ref):
        plan = ref.plan
        n = x.shape[2] // plan.model_size
        ctx.start, ctx.shape = plan.model_rank * n, x.shape
        return x.narrow(2, ctx.start, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full.narrow(2, ctx.start, g.shape[2]).copy_(g)
        return full, None


class HaloConv2d(nn.Conv2d):
    """A 3x3 convolution (stride 1 or 2) on split rows, with a halo row a side."""

    sp: PlanRef

    def forward(self, x):
        x = _HaloRows.apply(x, self.sp)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


class InputConv(nn.Conv2d):
    """conv_in on whole images: each rank convolves its rows, reading its
    halo rows from the whole input (zeros at the edges): no exchange."""

    sp: PlanRef

    def forward(self, x):
        plan = self.sp.plan
        n = x.shape[2] // plan.model_size
        rows = F.pad(x, (0, 0, 1, 1)).narrow(2, plan.model_rank * n, n + 2)
        return F.conv2d(rows, self.weight, self.bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


class OutputConv(HaloConv2d):
    """conv_out on split rows, all-gathered: the UNet's output is whole. Its
    backward keeps the local rows of the (identical) output gradient."""

    def forward(self, x):
        return gather_from_group(super().forward(x), 2, self.sp)


class _SplitGroupNorm(torch.autograd.Function):
    """GroupNorm(+SiLU) of split rows with the whole image's statistics:
    ops/groupnorm.py's split pair around an all-reduce over the model group,
    forward and backward. dscale and dbias are the rank's rows' share. Only
    x and the fp32 statistics are kept for the backward, as kernel 2 keeps
    them; a recomputing forward (--remat) runs the pair again."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu, ref):
        plan = ref.plan
        y, mean, rstd = group_norm_split(x, scale, bias, groups, eps, silu,
                                         functools.partial(all_reduce_sum, group=plan.model_group),
                                         plan.model_size)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.groups, ctx.silu, ctx.ref = groups, silu, ref
        return y

    @staticmethod
    def backward(ctx, grad):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        plan = ctx.ref.plan
        dx, dscale, dbias = group_norm_split_backward(
            x, scale, bias, grad, mean, rstd, ctx.groups, ctx.silu,
            functools.partial(all_reduce_sum, group=plan.model_group), plan.model_size)
        return dx, dscale, dbias, None, None, None, None


class SplitGroupNormAct(GroupNormAct):
    sp: PlanRef

    def forward(self, x):
        return _SplitGroupNorm.apply(x, self.weight, self.bias, self.num_groups, self.eps,
                                     self.silu, self.sp)


class SplitAttentionBlock(AttentionBlock):
    """The block on the gathered activation; the rank keeps its rows."""

    sp: PlanRef

    def forward(self, x):
        return _SliceRows.apply(super().forward(_GatherRows.apply(x, self.sp)), self.sp)


class GatheringDownsample(Downsample):
    """From the last split level into a replicated one: gather, then the
    stride-2 conv on the whole activation."""

    sp: PlanRef

    def forward(self, x):
        return self.conv(_GatherRows.apply(x, self.sp))


class SlicingUpsample(Upsample):
    """From a replicated level into a split one: the whole upsample, then
    the rank's rows."""

    sp: PlanRef

    def forward(self, x):
        return _SliceRows.apply(super().forward(x), self.sp)


def _swap(module: nn.Module, cls, ref: PlanRef) -> None:
    module.__class__ = cls
    module.sp = ref


def _split_resnet(res: ResnetBlock, ref: PlanRef) -> None:
    for norm in (res.norm1, res.norm2):
        _swap(norm, SplitGroupNormAct, ref)
    for conv in (res.conv1, res.conv2):
        _swap(conv, HaloConv2d, ref)


def _split_level(blocks, ref: PlanRef) -> None:
    """The resnets and attentions of one split level."""
    for res in blocks.resnets:
        _split_resnet(res, ref)
    for attn in blocks.attentions:
        _swap(attn, SplitAttentionBlock, ref)


_announced = set()


def split_module(model: nn.Module, plan: MeshPlan) -> Tuple[bool, ...]:
    """Convert a built UNet2D in place for `plan`'s model group (after
    validate_spatial on its height). Returns the levels' split flags
    (model.sp_levels); global rank 0 prints them once as an `sp:` line."""
    cfg = model.config
    validate_spatial(plan, cfg.sample_size)
    ref, n = PlanRef(plan), len(cfg.block_out_channels)
    levels = split_levels(cfg.sample_size, n, plan.model_size)
    _swap(model.conv_in, InputConv, ref)
    for i, blk in enumerate(model.down_blocks):
        if levels[i]:
            _split_level(blk, ref)
        for down in blk.downsamplers:
            if levels[i + 1]:
                _swap(down.conv, HaloConv2d, ref)
            elif levels[i]:
                _swap(down, GatheringDownsample, ref)
    if levels[n - 1]:
        _split_level(model.mid_block, ref)
    for k, blk in enumerate(model.up_blocks):
        level = n - 1 - k
        if levels[level]:
            _split_level(blk, ref)
        for up in blk.upsamplers:  # into level - 1
            if levels[level]:
                _swap(up.conv, HaloConv2d, ref)
            elif levels[level - 1]:
                _swap(up, SlicingUpsample, ref)
    _swap(model.conv_norm_out, SplitGroupNormAct, ref)
    _swap(model.conv_out, OutputConv, ref)
    model.sp_levels = levels
    key = (cfg.sample_size, n, plan.model_size)
    if plan.rank == 0 and key not in _announced:
        _announced.add(key)
        heights = level_heights(cfg.sample_size, n)
        print("sp: " + json.dumps({
            "model_size": plan.model_size, "height": cfg.sample_size,
            "levels": [{"height": h, "split": s, "rows_a_rank": h // plan.model_size if s else h}
                       for h, s in zip(heights, levels)],
            "routes": ROUTES}), flush=True)
    return levels
