"""Training checkpoints: the full state a run resumes from.

Counterpart of masked_diffusion_tpu/io/checkpoint.py (orbax there; this
module needs neither orbax nor safetensors). One checkpoint is a directory

    checkpoint-epoch-N/
      unet/, unet_ema/   the export layout of io/weights.py (config.json and
                         diffusion_pytorch_model.safetensors), which the
                         port's --method sample and the JAX package's
                         io/import_torch.py read
      optimizer/         optimizer.safetensors (train/optim.py's
                         Optimizer.state_dict tensors, by parameter name)
                         and optimizer.json (its counters and
                         hyperparameters)
      meta.json          epoch, global_step, `items` (the folders a complete
                         checkpoint holds) and the caller's extra keys
      history.npz        the loss and LR curves (loss_mean_epoch, lr_list,
                         as the JAX package writes them)

Commit is atomic: the whole directory is written under a staging name
beside it, `checkpoint-epoch-N.tmp-<hex>`, and renamed into place, so a name
`checkpoint-epoch-N` is either absent or complete. Saving an epoch that
already has a checkpoint (a post-mortem after a cadence save, a rerun)
replaces it: the old one is renamed to `.old-<hex>`, the new one into its
place, then the old one is removed.

Retention (`keep_last` > 0) follows the JAX package's rules: only complete
checkpoints count toward the quota, the checkpoint just saved is protected
by its path (never inferred from the highest epoch), and crashed garbage (an
incomplete checkpoint, or a staging directory of a write that never
committed) is always deleted. It runs after the new checkpoint commits, so
that one counts toward the quota.

`async_save` copies every tensor to host memory before it returns (the
caller may then mutate the parameters in place) and writes, commits and
prunes in a background thread. Every save first waits for the one before;
`wait_for_async_saves` drains the last before the process exits.

Only one process writes (the trainer calls this on rank 0), and always the
one-process layout: under tensor parallelism the trainer gathers the
sharded tensors over the model group first (parallel/tp.py:gather_state),
and a restore cuts each rank's slices from these files (scatter_state), so
a checkpoint of any mesh restores under any other.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from masked_diffusion_tpu_torch.io import weights

CKPT_RE = re.compile(r"checkpoint-(?:epoch-)?(\d+)$")
# a write that never committed, or a replaced checkpoint never removed
_STAGED_RE = re.compile(r"checkpoint-(?:epoch-)?\d+\.(?:tmp|old)-[0-9a-f]+$")
OPTIMIZER_TENSORS = "optimizer.safetensors"
OPTIMIZER_SCALARS = "optimizer.json"
_ITEM_FILES = {
    "unet": (weights.WEIGHTS_NAME, "config.json"),
    "unet_ema": (weights.WEIGHTS_NAME, "config.json"),
    "optimizer": (OPTIMIZER_TENSORS, OPTIMIZER_SCALARS),
}

# the background writer: one thread, made at the first async save
_EXECUTOR: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []

OptimizerState = Tuple[Dict[str, torch.Tensor], dict]


def wait_for_async_saves() -> None:
    """Block until every async save has committed (and pruned); raises the
    error of one that failed. Call before the process exits
    (Trainer.train does, in its finally block)."""
    while _PENDING:
        _PENDING.pop(0).result()


def _to_host(tensors: Optional[Dict[str, torch.Tensor]]):
    """A host copy of every tensor, complete when this returns: a copy from
    the card is a blocking one, and a CPU tensor is cloned, so the caller's
    next in-place update cannot reach what is written."""
    if tensors is None:
        return None
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def save_checkpoint(
    checkpoint_dir: str,
    epoch: int,
    global_step: int,
    model_sd: Dict[str, torch.Tensor],
    ema_sd: Optional[Dict[str, torch.Tensor]] = None,
    optimizer_state: Optional[OptimizerState] = None,
    extra_meta: Optional[dict] = None,
    history: Optional[dict] = None,
    keep_last: int = 0,
    async_save: bool = False,
    config: Optional[dict] = None,
    ema_config: Optional[dict] = None,
) -> str:
    """Write checkpoint-epoch-{epoch}/ under checkpoint_dir and return its
    path. `optimizer_state` is Optimizer.state_dict()'s (tensors, scalars);
    `history` maps names to sequences for history.npz; `config` and
    `ema_config` are the unet/ and unet_ema/ config.json. `keep_last` > 0
    prunes to the newest keep_last complete checkpoints once this one has
    committed. With `async_save` the write runs in a background thread
    after the host copies."""
    wait_for_async_saves()
    path = os.path.abspath(os.path.join(checkpoint_dir, f"checkpoint-epoch-{epoch}"))
    os.makedirs(checkpoint_dir, exist_ok=True)
    model_sd, ema_sd = _to_host(model_sd), _to_host(ema_sd)
    if optimizer_state is not None:
        optimizer_state = (_to_host(optimizer_state[0]), json.loads(json.dumps(optimizer_state[1])))
    items = ["unet"] + (["unet_ema"] if ema_sd is not None else [])
    items += ["optimizer"] if optimizer_state is not None else []
    meta = {"epoch": int(epoch), "global_step": int(global_step), "items": items,
            **(extra_meta or {})}
    history = None if not history else {k: np.asarray(v) for k, v in history.items()}

    def write() -> None:
        staged = f"{path}.tmp-{uuid.uuid4().hex[:12]}"
        try:
            os.makedirs(staged)
            weights.save_checkpoint(staged, model_sd, config or {}, ema_sd=ema_sd,
                                    ema_config=ema_config, meta=meta)
            if optimizer_state is not None:
                folder = os.path.join(staged, "optimizer")
                os.makedirs(folder)
                weights.write_safetensors(os.path.join(folder, OPTIMIZER_TENSORS),
                                          optimizer_state[0])
                with open(os.path.join(folder, OPTIMIZER_SCALARS), "w") as f:
                    json.dump(optimizer_state[1], f, indent=2)
            if history is not None:
                np.savez(os.path.join(staged, "history.npz"), **history)
            _commit(staged, path)
        except BaseException:
            shutil.rmtree(staged, ignore_errors=True)
            raise
        if keep_last and keep_last > 0:
            _prune_checkpoints(checkpoint_dir, keep_last, protect=path)

    if async_save:
        global _EXECUTOR
        if _EXECUTOR is None:
            _EXECUTOR = ThreadPoolExecutor(max_workers=1, thread_name_prefix="checkpoint")
        _PENDING.append(_EXECUTOR.submit(write))
    else:
        write()
    return path


def _commit(staged: str, path: str) -> None:
    """Rename the staged directory to `path`, replacing a checkpoint there."""
    old = None
    if os.path.exists(path):
        old = f"{path}.old-{uuid.uuid4().hex[:12]}"
        os.replace(path, old)
    os.replace(staged, path)
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def _prune_checkpoints(checkpoint_dir: str, keep_last: int,
                       protect: Optional[str] = None) -> None:
    """Delete stale checkpoints, keeping the newest keep_last COMPLETE ones
    (by epoch suffix). Incomplete checkpoints and staging directories are
    crashed-save garbage and always go, except `protect` (the checkpoint
    being saved, named by its path) and its staging directory."""
    protect = os.path.abspath(protect) if protect else None
    protect_prefix = os.path.basename(protect) + "." if protect else None
    complete, garbage = [], []
    for d in os.listdir(checkpoint_dir):
        full = os.path.abspath(os.path.join(checkpoint_dir, d))
        if not os.path.isdir(full):
            continue
        m = CKPT_RE.search(d)
        if m:
            (complete if is_complete_checkpoint(full) else garbage).append(
                (int(m.group(1)), full))
        elif _STAGED_RE.search(d) and not (protect_prefix and d.startswith(protect_prefix)):
            garbage.append((-1, full))
    complete.sort()
    for _, full in complete[:-keep_last] + garbage:
        if full != protect:
            shutil.rmtree(full, ignore_errors=True)


def load_checkpoint(path: str):
    """(model state dict, EMA state dict or None, (optimizer tensors,
    scalars) or None, meta) of a checkpoint, on the CPU. meta holds
    meta.json (or the epoch parsed from the name) and, from history.npz,
    meta['history'] as lists."""
    path = os.path.abspath(path)
    model_sd, ema_sd, _ = weights.load_checkpoint(path)
    optimizer_state = None
    folder = os.path.join(path, "optimizer")
    if os.path.isfile(os.path.join(folder, OPTIMIZER_TENSORS)):
        tensors = weights.read_safetensors(os.path.join(folder, OPTIMIZER_TENSORS))
        with open(os.path.join(folder, OPTIMIZER_SCALARS)) as f:
            scalars = json.load(f)
        optimizer_state = ({k: torch.from_numpy(np.array(v)) for k, v in tensors.items()},
                           scalars)
    meta: dict = {}
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    else:
        m = CKPT_RE.search(os.path.basename(path))
        if m:
            meta = {"epoch": int(m.group(1)), "global_step": 0}
    hist_path = os.path.join(path, "history.npz")
    if os.path.exists(hist_path):
        with np.load(hist_path) as h:
            meta["history"] = {k: h[k].tolist() for k in h.files}
    return model_sd, ema_sd, optimizer_state, meta


def _item_complete(path: str, item: str) -> bool:
    folder = os.path.join(path, item)
    return os.path.isdir(folder) and all(
        os.path.isfile(os.path.join(folder, f)) for f in _ITEM_FILES.get(item, ()))


def is_complete_checkpoint(path: str) -> bool:
    """True when every folder meta.json's `items` names holds its files.
    Without `items` (meta.json absent or older): unet/ complete and no
    entry left by an unfinished write (a name holding "tmp": this module's
    staging names, or orbax's in a checkpoint of the JAX package)."""
    meta_path = os.path.join(path, "meta.json")
    items = None
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                items = json.load(f).get("items")
        except (OSError, ValueError):
            return False  # a truncated meta.json
    if items:
        return all(_item_complete(path, item) for item in items)
    if not _item_complete(path, "unet"):
        return False
    try:
        entries = os.listdir(path)
    except OSError:
        return False
    return not any("tmp" in e for e in entries)


def find_resume_checkpoint(output_dir: str, resume_from: str = "latest") -> Optional[str]:
    """Resolve --resume_from_checkpoint: 'latest' is the complete
    checkpoint-* of output_dir with the highest number (None when there is
    none); any other value is a path, returned when it is a directory."""
    if resume_from not in ("latest", "True", True):
        return resume_from if os.path.isdir(str(resume_from)) else None
    if not os.path.isdir(output_dir):
        return None
    found = []
    for d in os.listdir(output_dir):
        m = CKPT_RE.search(d)
        full = os.path.join(output_dir, d)
        if m and os.path.isdir(full) and is_complete_checkpoint(full):
            found.append((int(m.group(1)), d))
    if not found:
        return None
    return os.path.join(output_dir, max(found)[1])
