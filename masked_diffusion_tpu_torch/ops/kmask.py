"""Exact-k random pixel masks: the CUDA kernel and its plain PyTorch version.

Counterpart of masked_diffusion_tpu/ops/pallas/kmask.py:
exact_count_masks_pallas. The kernel is csrc/kmask.cu (its header says what
it computes, how it differs from the TPU kernel on ties, and what bounds it).
The plain version is the same law in tensor ops: composite keys (each draw's
low ceil(log2 HW) bits replaced by the pixel index), then the MSB-first
threshold scan of ops/fused_degrade.py:exact_k_degrade.

`exact_count_masks` is the wrapper the training step's indexing mode calls.
CPU tensors take the plain version; CUDA tensors launch the kernel or raise.
`exact_count_masks_sharded` is its data-parallel form (one launch per rank
on its rows, the generator folded with the rank: ops/shard.py), through
which the train step reaches it, with a 1-rank plan in one process.
Random bits are uint32 values carried in int64 tensors, as in
ops/fused_degrade.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from masked_diffusion_tpu_torch.ops import build
from masked_diffusion_tpu_torch.ops.fused_degrade import (
    MAX_HW,
    REGISTER_HW,
    exact_k_degrade,
    uint32_to_int32,
)
from masked_diffusion_tpu_torch.ops.shard import data_parallel_kernel, fold_generator


def exact_count_masks_plain(bits: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(B, HW) keep-masks with exactly clip(counts[i], 0, HW) zeros.

    bits: int64 (B, HW) uint32 draws; counts: (B,) integers. Returns float32
    (B, HW): 0 on the counts[i] pixels with the smallest composite keys."""
    degrade = exact_k_degrade(bits, counts.to(torch.int64)[:, None])
    return (~degrade).to(torch.float32)


def _check(batch, height, width, counts, bits):
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


def exact_count_masks(
    batch: int,
    height: int,
    width: int,
    counts: torch.Tensor,
    *,
    generator: Optional[torch.Generator] = None,
    bits: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, 1, H, W) float32 keep-masks on counts' device with exactly
    counts[i] zeros, placed uniformly at random.

    counts: int32 (B,). Draws come from `bits` (int64 (B, H*W) uint32 values)
    when given; otherwise from Philox on the card at a (seed, offset) drawn
    from `generator` (a CPU torch.Generator; a fresh unseeded one when None),
    or, for CPU tensors, from torch.randint on that generator."""
    _check(batch, height, width, counts, bits)
    hw = height * width
    if bits is None and generator is None:
        generator = torch.Generator()
    if counts.device.type == "cpu":
        if bits is None:
            bits = torch.randint(0, 2**32, (batch, hw), generator=generator,
                                 dtype=torch.int64)
        return exact_count_masks_plain(bits, counts).reshape(batch, 1, height, width)
    if counts.device.type != "cuda":
        raise RuntimeError(f"exact_count_masks: no kernel for {counts.device}")

    seed = offset = 0
    if bits is None:
        seed, offset = torch.randint(0, 2**62, (2,), generator=generator).tolist()
    lib = build.load_library()
    cnt = counts.contiguous()
    bits32 = uint32_to_int32(bits).contiguous() if bits is not None else None
    out = torch.empty((batch, 1, height, width), dtype=torch.float32, device=cnt.device)
    keys = None
    if hw > REGISTER_HW and bits is None:
        keys = torch.empty((batch, hw), dtype=torch.int32, device=cnt.device)
    with torch.cuda.device(cnt.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_kmask(
            cnt.data_ptr(), bits32.data_ptr() if bits32 is not None else None,
            seed, offset, out.data_ptr(), keys.data_ptr() if keys is not None else None,
            batch, hw, stream,
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
) -> torch.Tensor:
    """Data-parallel form of exact_count_masks (JAX
    exact_count_masks_pallas_sharded, ops/pallas/kmask.py:122): `batch` is
    the GLOBAL batch; counts (and `bits`) hold this rank's batch // N rows.
    The single-device call on the rank's rows draws from `generator` folded
    with plan.rank (ops/shard.py:fold_generator; rank 0 draws from it
    as it is). Returns the rank's (batch // N, 1, H, W) masks."""

    if bits is None and generator is None:
        generator = torch.Generator()  # as the single-device call, then folded

    def fn(gen, cnt, bits_rows):
        masks = exact_count_masks(cnt.shape[0], height, width, cnt, generator=gen,
                                  bits=bits_rows)
        if cnt.device.type == "cuda":
            exact_count_masks_sharded.launches += 1
        return masks

    return data_parallel_kernel(fn, plan, fold_generator)(batch, generator, counts, bits)


#: kernel launches through the sharded form since the count was last set to 0
exact_count_masks_sharded.launches = 0
