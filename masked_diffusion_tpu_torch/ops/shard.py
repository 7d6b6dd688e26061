"""The data-parallel harness of the mask kernels.

Counterpart of masked_diffusion_tpu/ops/pallas/shard.py:data_parallel_kernel,
which shard_maps a Pallas kernel over the mesh's 'data' axis. Under torchrun
each rank is a process that holds only its own rows, so the harness's three
duties become:

  * one kernel launch per rank over its LOCAL rows (the caller's tensors);
  * the rank folded into the kernel's seed (`fold_seed`, or
    `fold_generator` for a wrapper that draws from a generator): a shared seed
    would give local image i on every rank the same mask, correlated
    sampling across the global batch. Streams are therefore not those of
    the single-device call over the global batch (distribution-identical,
    deterministic per (seed, rank));
  * the global batch must divide the number of ranks, with the JAX
    harness's error message (parallel/mesh.py:local_rows).

On a data x model grid (parallel/mesh.py) "the rank" is the DATA rank: the
M ranks of a model group hold the same rows and draw the same masks, as the
JAX harness's shard_map over 'data' replicates over 'model'.

Used by ops/fused_degrade.py:fused_degrade_update_sharded and
ops/kmask.py:exact_count_masks_sharded, each a per-rank launch of the
single-device kernel (csrc/fused_degrade.cu, csrc/kmask.cu) on the folded
seed: no second kernel. They are the only route to those kernels from the
sampling loop and the train step, which give them a 1-rank plan when they
run as one process: the fold is the identity at rank 0, so that route is
bitwise the single-device call.
"""

from __future__ import annotations

from typing import Optional

import torch

from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan, local_rows

_MASK64 = (1 << 64) - 1


def _mix64(z: int) -> int:
    """SplitMix64's finaliser: a bijection of 64-bit words."""
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9 & _MASK64
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & _MASK64
    return z ^ (z >> 31)


def fold_seed(seed: int, rank: int) -> int:
    """The seed rank `rank` draws from in place of the shared `seed`: `seed`
    itself for rank 0 (so every single-process path keeps its stream
    bitwise), otherwise a 63-bit mix of (seed, rank) that differs per rank."""
    if rank == 0:
        return seed
    return _mix64((seed & _MASK64) ^ _mix64(rank * 0x9E3779B97F4A7C15 & _MASK64)) >> 1


def step_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of draw stream `index` of epoch `epoch` in a run seeded with
    `seed`: a 63-bit mix of the three. Each step's stream is a function of
    (seed, epoch, index) alone, as the JAX trainer's split chain is of
    (epoch, i), so a run resumed inside an epoch draws what the
    uninterrupted run drew without replaying the steps it skips."""
    z = _mix64((seed + 0x9E3779B97F4A7C15) & _MASK64)
    z = _mix64(z ^ (epoch * 0xBF58476D1CE4E5B9 & _MASK64))
    return _mix64(z ^ (index * 0x94D049BB133111EB & _MASK64)) >> 1


def fold_generator(generator: Optional[torch.Generator], rank: int):
    """The CPU generator rank `rank` draws from in place of the shared
    `generator`: the generator itself for rank 0 (and for None), otherwise
    a fresh one seeded with one draw of it folded with the rank."""
    if rank == 0 or generator is None:
        return generator
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator().manual_seed(fold_seed(seed, rank))


def data_parallel_kernel(fn, plan: MeshPlan, fold=fold_seed):
    """Wrap fn(key, *local_args) into call(batch, key, *local_args) for one
    rank of `plan`: `batch` is the global batch, which must divide the
    ranks; every arg (None passes through) holds this rank's batch // N
    rows; fn gets fold(key, rank), the key (a seed, or a generator with
    fold_generator) folded with the plan's data rank."""

    def call(batch: int, key, *args):
        rows = local_rows(batch, plan)
        per = rows.stop - rows.start
        for a in args:
            if a is not None and a.shape[0] != per:
                raise ValueError(
                    f"data rank {plan.data_rank} of {plan.data_size}: an argument has "
                    f"{a.shape[0]} rows, not this rank's {per} of the global batch {batch}")
        return fn(fold(key, plan.data_rank), *args)

    return call
