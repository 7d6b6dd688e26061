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

Tensor and spatial parallelism (--mesh_model > 1, --mesh_spatial) are not
ported and are refused.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The data-parallel layout of this process: `data_size` ranks, this
    one `rank`, running on `device`."""

    device: torch.device
    data_size: int = 1
    rank: int = 0


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


def make_mesh(data: int, model: int, device: torch.device) -> MeshPlan:
    """The data-parallel plan of --mesh_data/--mesh_model on this rank's
    `device` (what init_distributed returned). data=-1 means WORLD_SIZE (1
    without a process group); any other value must equal it. model > 1
    (tensor parallelism) is refused."""
    if model != 1:
        raise NotImplementedError(
            f"not yet ported: --mesh_model {model} (tensor/spatial parallelism over "
            "multi-GPU); the port is data-parallel only (--mesh_data)")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data == -1:
        data = world
    if data != world:
        raise ValueError(
            f"--mesh_data {data} but WORLD_SIZE is {world}: launch {data} processes with "
            f"python -m torch.distributed.run --nproc_per_node {data} ...")
    rank = dist.get_rank() if dist.is_initialized() else 0
    return MeshPlan(data_size=data, rank=rank, device=torch.device(device))


def local_rows(batch: int, plan: MeshPlan) -> slice:
    """This rank's rows [r*B/N, (r+1)*B/N) of a global batch of `batch`
    rows; raises the JAX harness's error when N does not divide it."""
    n = plan.data_size
    if batch % n:
        raise ValueError(f"batch {batch} not divisible by mesh axis data={n}")
    per = batch // n
    return slice(plan.rank * per, (plan.rank + 1) * per)


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= n (the sampling batches' round-up)."""
    if multiple <= 1:
        return n
    return -(-n // multiple) * multiple

