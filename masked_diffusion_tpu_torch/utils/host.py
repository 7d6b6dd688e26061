"""Multi-process write discipline on torch.distributed.

Counterpart of masked_diffusion_tpu/utils/host.py (which is written on
jax.distributed, so the port has its own). The reference gates every
artifact write behind `accelerator.is_main_process`
(trainer_masked_mean_shift.py:242); the port's policy:

  * ONLY rank 0 writes files: run-directory trees, option.ini, metrics
    JSONL, PNG grids, checkpoints;
  * results computed on every rank's rows are brought to every rank with
    `fetch`, which is COLLECTIVE: call it before any rank-0 gate, never
    inside one;
  * the run timestamp is rank 0's clock, broadcast (`synced_timestamp`), so
    every rank agrees on the result-tree path.

On a data x model grid (parallel/mesh.py) "rank 0" is the global rank 0,
and `gather`, `fetch` and `mean_over_ranks` take the plan's data group
(`group=plan.data_group`): the M ranks of a model group hold the same rows,
so the global batch is one rank of each model group, concatenated in data
rank order.

Without a process group every function is its single-process self.
"""

from __future__ import annotations

import datetime
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def is_main_process() -> bool:
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (a no-op for one process)."""
    if process_count() > 1:
        dist.barrier()


def _comm_device() -> torch.device:
    """Where collective tensors live: the rank's card under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _group_size(group) -> int:
    return dist.get_world_size(group) if _live() else 1


def mean_over_ranks(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise mean of x over the ranks of `group` (None: every
    rank), on x's device (collective when multi-process)."""
    n = _group_size(group)
    if n <= 1:
        return x
    y = x.detach().to(_comm_device(), copy=True)
    dist.all_reduce(y, group=group)  # SUM: gloo has no AVG
    return (y / n).to(x.device)


def any_flag(local: bool) -> bool:
    """A host flag OR-ed over the ranks (collective when multi-process): the
    preemption flag, which SIGTERM sets on each rank at its own moment, so
    every rank acts on it at the same step."""
    if process_count() <= 1:
        return bool(local)
    flag = torch.tensor([int(bool(local))], dtype=torch.int32, device=_comm_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of a batch-major tensor, concatenated in the order
    of the ranks of `group` (None: every rank), on every rank: x itself for
    one rank, else on the collectives' device (the CPU under gloo). Shards
    may differ in length: each is padded to the longest for one all_gather
    of equal tensors, then trimmed. COLLECTIVE over the group."""
    n = _group_size(group)
    if n <= 1:
        return x
    dev = _comm_device()
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(rows) for _ in range(n)]
    dist.all_gather(sizes, rows, group=group)
    sizes = [int(s.item()) for s in sizes]
    longest = max(sizes)
    local = x.detach().to(dev).contiguous()
    if local.shape[0] < longest:
        pad = local.new_zeros((longest - local.shape[0],) + tuple(local.shape[1:]))
        local = torch.cat([local, pad])
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def fetch(x: torch.Tensor, group=None) -> np.ndarray:
    """gather(x, group) as numpy on every rank. COLLECTIVE over the group."""
    return gather(x, group).detach().cpu().numpy()


def synced_timestamp() -> Tuple[str, str]:
    """(date, time) strings agreed across ranks: rank 0's wall clock,
    broadcast when more than one process is live."""
    now = datetime.datetime.now()
    if process_count() > 1:
        stamp = torch.tensor([int(now.timestamp())], dtype=torch.int64, device=_comm_device())
        dist.broadcast(stamp, src=0)
        now = datetime.datetime.fromtimestamp(int(stamp.item()))
    return now.strftime("%Y_%m_%d"), now.strftime("%H_%M_%S")
