"""The kernels' launch counts, read and added as one table.

Every wrapper of a CUDA kernel counts its launches in its `.launches`
attribute, where it launches (the split GroupNorm wrappers a launch pair
each); the tiny-head wrappers count their fp32 kernels' launches apart too,
in two counters named like wrappers. A CUDA graph replays what it captured without calling the
wrappers, so train/step.py:TrainEpoch reads the counts
around a capture (`snapshot`, `since`), sets them back (the capture ran
nothing) and adds the captured counts on every replay (`add`): the counts
stay those of the kernels that ran.
"""

from __future__ import annotations

from typing import Dict


def wrappers() -> Dict[str, object]:
    """The launch-counted wrappers of every kernel, by name."""
    from masked_diffusion_tpu_torch.ops.fused_degrade import (
        fused_degrade_update,
        fused_degrade_update_sharded,
    )
    from masked_diffusion_tpu_torch.ops.groupnorm import (
        group_norm_silu,
        group_norm_silu_backward,
        group_norm_split,
        group_norm_split_backward,
    )
    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks, exact_count_masks_sharded
    from masked_diffusion_tpu_torch.ops.tinyhead_attention import (
        tinyhead_attention,
        tinyhead_attention_backward,
        tinyhead_attention_backward_fp32,
        tinyhead_attention_fp32,
    )

    return {f.__name__: f for f in (fused_degrade_update, group_norm_silu,
                                    group_norm_silu_backward, exact_count_masks,
                                    tinyhead_attention, tinyhead_attention_backward,
                                    fused_degrade_update_sharded, exact_count_masks_sharded,
                                    group_norm_split, group_norm_split_backward,
                                    tinyhead_attention_fp32, tinyhead_attention_backward_fp32)}


def snapshot() -> Dict[str, int]:
    return {name: fn.launches for name, fn in wrappers().items()}


def since(before: Dict[str, int]) -> Dict[str, int]:
    """The launches counted after `before` was taken."""
    return {name: n - before[name] for name, n in snapshot().items()}


def set_to(counts: Dict[str, int]) -> None:
    for name, fn in wrappers().items():
        fn.launches = counts[name]


def add(counts: Dict[str, int]) -> None:
    for name, fn in wrappers().items():
        fn.launches += counts.get(name, 0)
