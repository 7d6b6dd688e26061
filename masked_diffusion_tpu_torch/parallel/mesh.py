"""Process group and data-parallel plan.

Counterpart of masked_diffusion_tpu/parallel/mesh.py. The reference trains
data-parallel with DDP/NCCL under HF Accelerate (gpuMulti_config.yaml,
num_processes=4); the JAX package shards the batch over a 'data' mesh axis.
The port does what the reference does: one process per rank, launched by
torchrun,

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m masked_diffusion_tpu_torch.cli.main_train_masked --mesh_data N ...

with the JAX package's batch semantics: --batch_size is the GLOBAL batch,
rank r takes rows [r*B/N, (r+1)*B/N) of the same global batch
(put_global_batch), parameters, EMA and optimizer state are the same on every
rank, and only rank 0 writes files (utils/host.py).

Backend rule (init_distributed), one `dist:` line printed by rank 0:

  nccl  --device cuda without an index: each rank has a card of its own,
        rank r runs on cuda:LOCAL_RANK. More ranks on a node than cards
        (LOCAL_WORLD_SIZE > torch.cuda.device_count()) raise.
  gloo  --device cuda:I, an index: the caller asks every rank to share that
        card; or --device cpu. NCCL refuses two ranks on one device; gloo
        carries CUDA tensors for DDP's all-reduce and broadcast through host
        memory, so a shared card is for checking the path, not for speed.

Tensor and spatial parallelism (--mesh_model M > 1; parallel/tp.py,
parallel/sp.py) make the ranks a data x model grid, as the JAX package's
('data', 'model') mesh: WORLD_SIZE = D x M, and rank r sits at data rank
r // M and model rank r % M, so a model group is M consecutive ranks (one
node's cards under NCCL). The M ranks of a model group hold the same rows
of the global batch: rows, local_rows and the seed folding of ops/shard.py
take the DATA rank, so they draw the same timesteps, masks and shifts.
make_mesh builds both kinds of group (`data_group`: the D ranks that share
a model rank; `model_group`: the M ranks that share a data rank); with M =
1 the data group is the default (world) group and there is no model group.
`all_gather_rows` and `all_reduce_sum` are the groups' collectives, staged
through host memory under gloo.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
from typing import Any, List, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The layout of this process: a grid of `data_size` x `model_size`
    ranks, this one global `rank`, running on `device`. `data_group` and
    `model_group` are torch.distributed process groups (None: the default
    group, and no model group when model_size is 1); `spatial` says that the
    model axis splits activations (parallel/sp.py) rather than parameters
    (parallel/tp.py)."""

    device: torch.device
    data_size: int = 1
    rank: int = 0
    model_size: int = 1
    data_group: Optional[Any] = None
    model_group: Optional[Any] = None
    spatial: bool = False

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    @property
    def world_size(self) -> int:
        return self.data_size * self.model_size


class PlanRef:
    """A plan held by modules (parallel/tp.py, parallel/sp.py) that
    copy.deepcopy shares instead of copying: process groups cannot be
    copied, and an EMA or sampling copy of a model runs on the same ranks."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan

    def __deepcopy__(self, memo):
        return self


def _world_from_env() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def init_distributed(device="cuda", multihost: bool = False) -> torch.device:
    """Join torchrun's process group when WORLD_SIZE > 1 (RANK, WORLD_SIZE,
    LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT from the
    environment) and return this rank's device. Does nothing but return
    `device` for a single process, unless `multihost` (--multihost True)
    asks for nodes that torchrun did not start: that raises. It initialises
    nothing when the group already exists: the group it makes lives until
    the process exits (an atexit hook destroys it), so a second entry point
    in the same process reuses it; a group destroyed and made again in one
    process can hang gloo's first collective. The backend follows the
    module's rule; rank 0 prints it, the world size and every rank's device
    as one `dist:` line."""
    device = torch.device(device)
    world = _world_from_env()
    if world <= 1:
        if multihost:
            raise RuntimeError(
                "--multihost True but WORLD_SIZE is 1: start the processes of every node "
                "with python -m torch.distributed.run --nnodes <nodes> --node_rank <rank> "
                "--rdzv_endpoint <host:port> --nproc_per_node <ranks a node> ...")
        return device
    for var in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(
                f"WORLD_SIZE={world} but {var} is not set: launch with "
                "python -m torch.distributed.run (torchrun)")
    local_rank = int(os.environ["LOCAL_RANK"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    own_card = device.type == "cuda" and device.index is None
    if own_card:
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                f"{local_world} ranks on this node but {cards} CUDA card(s): start at most "
                f"{cards} ranks a node, or ask them to share one card with --device cuda:0")
        device = torch.device("cuda", local_rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device
    backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=world)
    atexit.register(_destroy_at_exit)
    devices = [None] * world
    dist.all_gather_object(devices, str(device))
    if dist.get_rank() == 0:
        cards = ("one card per rank" if own_card else
                 "the ranks share a card" if device.type == "cuda" else "CPU")
        print("dist: " + json.dumps({"backend": backend, "world_size": world,
                                     "devices": devices, "cards": cards}), flush=True)
    return device


def _destroy_at_exit() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(data: int, model: int, device: torch.device, spatial: bool = False) -> MeshPlan:
    """The plan of --mesh_data/--mesh_model/--mesh_spatial on this rank's
    `device` (what init_distributed returned). data=-1 means WORLD_SIZE / M
    (WORLD_SIZE is 1 without a process group); D x M must equal WORLD_SIZE,
    else a ValueError names both. With M > 1 every rank builds every group
    (dist.new_group is collective), in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1:
        raise ValueError(f"--mesh_model {model}: the model axis needs at least 1 rank")
    if data == -1 and world % model == 0:
        data = world // model
    if data * model != world:
        if model == 1:
            raise ValueError(
                f"--mesh_data {data} but WORLD_SIZE is {world}: launch {data} processes with "
                f"python -m torch.distributed.run --nproc_per_node {data} ...")
        need = f"{data * model} ranks" if data > 0 else f"a multiple of {model} ranks"
        raise ValueError(
            f"--mesh_data {data} x --mesh_model {model} needs {need} but WORLD_SIZE is "
            f"{world}: launch D x M processes with python -m torch.distributed.run "
            f"--nproc_per_node <D x M> ... --mesh_data D --mesh_model {model}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    data_group = model_group = None
    if model > 1:
        data_group, model_group = _grid_groups(data, model, rank)
    return MeshPlan(device=torch.device(device), data_size=data, rank=rank, model_size=model,
                    data_group=data_group, model_group=model_group, spatial=bool(spatial))


# (data, model) -> (default group, this rank's data group, its model group):
# a second plan of the same grid in one process (another entry point, the
# CLI called again) reuses the groups: under NCCL each new group would
# connect a communicator of its own, with its own device memory
_GROUPS: dict = {}


def _grid_groups(data: int, model: int, rank: int):
    """This rank's (data group, model group) of a data x model grid, made
    once a process (dist.new_group is collective: every rank makes every
    group, in the same order)."""
    world = dist.group.WORLD
    cached = _GROUPS.get((data, model))
    if cached is not None and cached[0] is world:
        return cached[1:]
    data_group = model_group = None
    for d in range(data):
        group = dist.new_group([d * model + j for j in range(model)])
        if d == rank // model:
            model_group = group
    for j in range(model):
        group = dist.new_group([d * model + j for d in range(data)])
        if j == rank % model:
            data_group = group
    _GROUPS[(data, model)] = (world, data_group, model_group)
    return data_group, model_group


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """A copy of x where the group's collectives take it: the CPU under
    gloo (bf16 and fp16 widened to fp32, exactly), else x's device."""
    if dist.get_backend(group) == "gloo":
        x = x.detach().to("cpu", torch.float32 if x.dtype in (torch.bfloat16, torch.float16)
                          else x.dtype)
    return x.detach().clone(memory_format=torch.contiguous_format)


def all_gather_list(x: torch.Tensor, group, size: int) -> List[torch.Tensor]:
    """Every rank's x of the group, in group-rank order, on x's device and
    in its dtype. COLLECTIVE over the group."""
    buf = _staged(x, group)
    parts = [torch.empty_like(buf) for _ in range(size)]
    dist.all_gather(parts, buf, group=group)
    return [p.to(x.device, x.dtype) for p in parts]


def all_gather_rows(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The group's x concatenated along `dim` in group-rank order.
    COLLECTIVE over the group."""
    return torch.cat(all_gather_list(x, group, size), dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's x, a new tensor on x's device. COLLECTIVE."""
    buf = _staged(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device, x.dtype)


@torch.no_grad()
def place_model(model: torch.nn.Module, plan: MeshPlan, min_features: int = 256):
    """Put a built UNet on the plan's model axis, in place, and return it:
    with model_size > 1, every rank first takes global rank 0's parameters
    (a broadcast, as DDP's construction does), then the model is split over
    image height (plan.spatial: parallel/sp.py:split_module) or its wide
    layers channel-sharded (parallel/tp.py:shard_module, --tp_min_features
    `min_features`). A model placed already, or a plan without a model axis,
    is left as it is. COLLECTIVE when it converts."""
    if plan.model_size <= 1 or hasattr(model, "tp_sharded") or hasattr(model, "sp_levels"):
        return model
    tensors = list(model.state_dict().values())
    for dtype in {t.dtype for t in tensors}:  # one broadcast a dtype
        group = [t for t in tensors if t.dtype == dtype]
        flat = _staged(torch.cat([t.reshape(-1) for t in group]), None)
        dist.broadcast(flat, src=0)
        flat = flat.to(group[0].device, dtype)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
    if plan.spatial:
        from masked_diffusion_tpu_torch.parallel.sp import split_module

        split_module(model, plan)
    else:
        from masked_diffusion_tpu_torch.parallel.tp import shard_module

        shard_module(model, plan, min_features)
    return model


def local_rows(batch: int, plan: MeshPlan) -> slice:
    """This rank's rows [d*B/D, (d+1)*B/D) of a global batch of `batch`
    rows, d its data rank (every rank of a model group holds the same
    rows); raises the JAX harness's error when D does not divide it."""
    n = plan.data_size
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by mesh axis data={n}")
    per = batch // n
    return slice(plan.data_rank * per, (plan.data_rank + 1) * per)


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= n (the sampling batches' round-up)."""
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple

