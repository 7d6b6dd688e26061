"""Exact-k random pixel masks: the CUDA kernel and its plain PyTorch version.

Counterpart of masked_diffusion_tpu/ops/pallas/kmask.py:
exact_count_masks_pallas. The kernel is csrc/kmask.cu (its header says what
it computes, how it differs from the TPU kernel on ties, and what bounds
it): a cluster of CTAs per image, keys in registers at every H*W up to
256 * 256, and the radix select of csrc/exact_k.cuh, launched on the plan
of ops/fused_degrade.py:exact_k_plan. The plain version is the same law in
tensor ops: composite keys (each draw's low ceil(log2 HW) bits replaced by
the pixel index), then the radix select of
ops/fused_degrade.py:exact_k_degrade.

`exact_count_masks` is the wrapper the training step's indexing mode calls.
CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
`exact_count_masks_sharded` is its data-parallel form (one launch per rank
on its rows, the generator folded with the rank: ops/shard.py), through
which the train step reaches it, with a 1-rank plan in one process.
Random bits are uint32 values carried in int64 tensors, as in
ops/fused_degrade.py; the card's draws are
ops/fused_degrade.py:philox_kmask_bits at `philox_seed(generator)`, or at
the (seed, offset) that a `seeds` tensor holds on the device: the kernel
reads that pair itself (csrc/kmask.cu:mdt_kmask_seeded), so a CUDA graph
that captured the launch draws new masks whenever the tensor is rewritten
(train/step.py:make_train_epoch).
"""

from __future__ import annotations

from typing import Optional

import torch

from masked_diffusion_tpu_torch.ops import build
from masked_diffusion_tpu_torch.ops.fused_degrade import (
    MAX_HW,
    ExactKPlan,
    device_plan,
    exact_k_degrade,
    philox_kmask_bits,
    uint32_to_int32,
)
from masked_diffusion_tpu_torch.ops.shard import data_parallel_kernel, fold_generator


def exact_count_masks_plain(bits: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(B, HW) keep-masks with exactly clip(counts[i], 0, HW) zeros.

    bits: int64 (B, HW) uint32 draws; counts: (B,) integers. Returns float32
    (B, HW): 0 on the counts[i] pixels with the smallest composite keys."""
    degrade = exact_k_degrade(bits, counts.to(torch.int64)[:, None])
    return (~degrade).to(torch.float32)


def philox_seed(generator: torch.Generator):
    """The (seed, offset) of the kernel's Philox draws: two draws of the
    CPU generator, below 2**62 (so an int64 `seeds` tensor holds them)."""
    seed, offset = torch.randint(0, 2**62, (2,), generator=generator).tolist()
    return seed, offset


def _check(batch, height, width, counts, bits, seeds=None):
    hw = height * width
    if hw > MAX_HW:
        raise ValueError(
            f"exact_count_masks: {height}x{width} exceeds the kernel's bound of "
            f"{MAX_HW} pixels per image"
        )
    if counts.dtype != torch.int32 or tuple(counts.shape) != (batch,):
        raise TypeError(
            f"counts must be an int32 ({batch},) tensor, got {counts.dtype} "
            f"{tuple(counts.shape)}"
        )
    if bits is not None:
        if bits.dtype != torch.int64 or tuple(bits.shape) != (batch, hw):
            raise TypeError(
                f"bits must be an int64 ({batch}, {hw}) tensor of uint32 values, "
                f"got {bits.dtype} {tuple(bits.shape)}"
            )
        if bits.device != counts.device:
            raise ValueError(f"bits is on {bits.device}, counts on {counts.device}")
    if seeds is not None:
        if bits is not None:
            raise ValueError("give bits or seeds, not both")
        if seeds.dtype != torch.int64 or tuple(seeds.shape) != (2,):
            raise TypeError(f"seeds must be an int64 (2,) tensor (seed, offset), got "
                            f"{seeds.dtype} {tuple(seeds.shape)}")
        if seeds.device != counts.device or not seeds.is_contiguous():
            raise ValueError(f"seeds must be contiguous on counts' device {counts.device}")


def exact_count_masks(
    batch: int,
    height: int,
    width: int,
    counts: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    seeds: Optional[torch.Tensor] = None,
    launch_plan: Optional[ExactKPlan] = None,
) -> torch.Tensor:
    """(B, 1, H, W) float32 keep-masks on counts' device with exactly
    counts[i] zeros, placed uniformly at random.

    counts: int32 (B,). Draws come from `bits` (int64 (B, H*W) uint32 values)
    when given; else from Philox at the (seed, offset) of `seeds` (an int64
    (2,) tensor on counts' device, which the kernel reads on the card and
    the plain version through philox_kmask_bits); else from Philox on the
    card at philox_seed(generator) (a CPU torch.Generator; a fresh unseeded
    one when None), or, for CPU tensors, from torch.randint on that
    generator. The kernel runs `launch_plan`, by default exact_k_plan for
    the batch on counts' card; a plan the kernel refuses raises."""
    _check(batch, height, width, counts, bits, seeds)
    hw = height * width
    if bits is None and seeds is None and generator is None:
        generator = torch.Generator()
    if counts.device.type == "cpu":
        if seeds is not None:
            bits = philox_kmask_bits(*seeds.tolist(), batch, hw)
        elif bits is None:
            bits = torch.randint(0, 2**32, (batch, hw), generator=generator,
                                 dtype=torch.int64)
        return exact_count_masks_plain(bits, counts).reshape(batch, 1, height, width)
    if counts.device.type != "cuda":
        raise RuntimeError(f"exact_count_masks: no kernel for {counts.device}")

    seed = offset = 0
    if bits is None and seeds is None:
        seed, offset = philox_seed(generator)
    lib = build.load_library()
    cnt = counts.contiguous()
    bits32 = uint32_to_int32(bits).contiguous() if bits is not None else None
    out = torch.empty((batch, 1, height, width), dtype=torch.float32, device=cnt.device)
    if launch_plan is None:
        launch_plan = device_plan(batch, hw, cnt.device, out)
    with torch.cuda.device(cnt.device):
        stream = torch.cuda.current_stream().cuda_stream
        if seeds is not None:
            code = lib.mdt_kmask_seeded(cnt.data_ptr(), seeds.data_ptr(), out.data_ptr(),
                                        batch, hw, *launch_plan, stream)
        else:
            code = lib.mdt_kmask(
                cnt.data_ptr(), bits32.data_ptr() if bits32 is not None else None,
                seed, offset, out.data_ptr(), batch, hw, *launch_plan, stream,
            )
    build.check(lib, code, "exact_count_masks")
    exact_count_masks.launches += 1
    return out


#: kernel launches since the count was last set to 0 (the plain path adds none)
exact_count_masks.launches = 0


def exact_count_masks_sharded(
    batch: int,
    height: int,
    width: int,
    counts: torch.Tensor,
    *,
    plan,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
    seeds: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Data-parallel form of exact_count_masks (JAX
    exact_count_masks_pallas_sharded, ops/pallas/kmask.py:122): `batch` is
    the GLOBAL batch; counts (and `bits`) hold this rank's batch // N rows.
    The single-device call on the rank's rows draws from `generator` folded
    with plan.rank (ops/shard.py:fold_generator; rank 0 draws from it
    as it is), or from `seeds`, the rank's own (seed, offset) on the device
    (the caller folded them: kmask_seeds). Returns the rank's
    (batch // N, 1, H, W) masks."""

    if bits is None and seeds is None and generator is None:
        generator = torch.Generator()  # as the single-device call, then folded

    def fn(gen, cnt, bits_rows):
        masks = exact_count_masks(cnt.shape[0], height, width, cnt, generator=gen,
                                  bits=bits_rows, seeds=seeds)
        if cnt.device.type == "cuda":
            exact_count_masks_sharded.launches += 1
        return masks

    return data_parallel_kernel(fn, plan, fold_generator)(batch, generator, counts, bits)


#: kernel launches through the sharded form since the count was last set to 0
exact_count_masks_sharded.launches = 0


def kmask_seeds(generator: torch.Generator, plan) -> tuple:
    """The (seed, offset) that exact_count_masks_sharded on `plan` would draw
    from `generator`: philox_seed of the generator folded with the plan's
    data rank. For a `seeds` tensor that stands in for the generator."""
    return philox_seed(fold_generator(generator, plan.data_rank))
