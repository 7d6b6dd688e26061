"""Training orchestration: the host-side shell around the train step.

Counterpart of masked_diffusion_tpu/train/trainer.py: epoch loop,
per-epoch timestep curriculum, metrics fetched once per epoch, the
non-finite-loss guard, the metrics JSONL, the save cadence
(trainer.py:625-648): the loss curve (train/loss/loss.png, when matplotlib
is installed), the train visuals (one forward on the epoch's last batch,
train/step.py:make_train_visuals_fn), the EMA sample and a checkpoint
(io/checkpoint.py: checkpoint-epoch-N/{unet,unet_ema,optimizer}/, meta.json
and history.npz), which the port's `--method sample` serves and `restore`
resumes from; and preemption (trainer.py:383-456, 583-592). The EMA sample
follows --sampling: 'base' (the default) samples with trajectory capture
and writes the result grids, one trajectory grid per captured field and
item (train/image/sample_all_t/) and the trajectory means (the metrics
JSONL); 'momentum' writes the result grids, and the trajectory grids too
under --capture_trajectory. With --interpolation_shift the cadence also
renders the interpolation sweep (sample/interpolation.py, trainer.py:646-650,
916-948), whether or not EMA is on: the EMA weights when --use_ema, else the
raw ones, seeded from seed + epoch + 1, one `ema_interpolation_NNNNN.png`
grid with global normalisation.

  shuffle     np.random.default_rng([seed, epoch]), as trainer.py:477, so
              batch membership equals the JAX trainer's; the same on every
              rank
  curriculum  schedule.timesteps_for_epoch(epoch, epoch_total, scale)
  data        the whole (subset) dataset on the device once; each epoch's
              index rows cross in one transfer, so a step makes no host sync
  seeds       a CPU torch.Generator per step, seeded from (seed, epoch,
              step index) (ops/shard.py:step_seed; the cadence's visuals
              pass has an index of its own) and folded with the rank
              (ops/shard.py:fold_seed; rank 0 keeps the single-process
              stream)

Resume (`restore`, then `train(epoch_start, epoch_length, resume_step,
global_step)`): params, EMA, the optimizer's state, the step counter (which
drives the EMA warmup) and the loss and LR history come back; the resumed
epoch skips its first resume_step batches without drawing for them (every
step's stream is its own), so the continued run equals the uninterrupted
one bitwise where the device is deterministic. A checkpoint that lacks the
EMA (with EMA on) or the optimizer state is refused.

Preemption: SIGTERM sets a flag (the handler lives for the call of train).
One process stops after the step in flight; with more ranks every rank stops
at the end of the epoch in which any rank saw the signal (the flag rides in
the epoch's metrics collective). A cut epoch's partial loss mean is left out
of loss_mean_epoch, and its step losses go into the checkpoint's history so
that the resumed epoch's mean is the uninterrupted one. Then a synchronous
checkpoint is saved (meta.json "preempted": true) and train returns. Cadence
checkpoints carry the history and honour --keep_last_checkpoints and
--async_checkpoints; the non-finite post-mortem is synchronous and never
prunes. In-flight async writes are drained before train returns.

Data-parallel (a parallel/mesh.MeshPlan of N > 1 ranks, under torchrun):
--batch_size is the global batch and rank r trains on rows
[r*B/N, (r+1)*B/N) of each (train/step.py wraps the model in DDP); the
logged metrics are the mean over the ranks, taken in the epoch's one fetch;
the cadence samples the global (rounded-up) latent batch, each rank its rows,
gathered to every rank (the trajectory images are rank 0's, its means
averaged over the ranks: sample/loop.py), and the visuals pass runs on each
rank's rows of the last batch, gathered; only rank 0 writes files, after a
barrier. Inside an accumulation window a checkpoint keeps every rank's own
gradient sum (DDP has not reduced them yet), and a restore gives each rank
its own.

The model comes from models/factory.build_model_from_config: the default
factory or a zoo name (--model unet1..unet6), with the switches --remat
(the down and up paths' ResnetBlocks recomputed in the backward),
--attention_chunk and --tinyhead_attention (the attention's route,
models/unet.py). The cadence's sampler takes --encoder_reuse
(sample/loop.py); the interpolation sweep ignores it, as JAX's does.

Profiling (--profile_dir, trainer.py:419-421, 533): one epoch is traced,
epoch_start + 1 when the call trains more than one (epoch_start's compiles
and autotuning stay out), else epoch_start; the window wraps that epoch's
step loop only (utils/profiling.trace), each step inside a
`train_step epoch E step I` range, so the metrics fetch, the save cadence
and checkpoint writes stay outside. Every rank writes its own
trace_rank{r}.json. The returned rates leave the traced epoch out.

Tensor and spatial parallelism (a plan with model_size M > 1, the JAX
trainer's _place_state and _batch_sharding): the model is placed on the
model axis at construction (parallel/mesh.py:place_model: channel-sharded,
or split over image height with --mesh_spatial, which validate_spatial
checks first), before the optimizer is built, so AdamW's moments and the
EMA copy follow it. The M ranks of a model group train on the same rows
with the same draws (the data rank's), and the cadence samples them alike.
Checkpoints hold the one-process layout: the sharded tensors are gathered
over the model group before rank 0 writes (parallel/tp.py:gather_state, a
collective every rank makes, async saves too), and a restore cuts each
rank's slices from the files (scatter_state), so a checkpoint of any mesh
restores under any other. Inside an accumulation window the gradient sums
are stacked by data rank, as under data parallelism (under SP each rank's
share is summed over its model group first).

Not ported yet, and refused at construction when a flag asks for it:
--epoch_scan true (the TPU's whole-epoch lax.scan; its CUDA counterpart
would be a graphed step); so are the sampling modes the cadence's samplers
refuse (sample/loop.py:validate_modes,
sample/interpolation.py:validate_interpolation_modes).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import signal
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import Config, validate_sampling_modes
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset
from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io
from masked_diffusion_tpu_torch.io.weights import diffusers_config_from_unet, unet_config_meta
from masked_diffusion_tpu_torch.models.factory import build_model_from_config
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule, build_schedule
from masked_diffusion_tpu_torch.ops.shard import fold_seed, step_seed
from masked_diffusion_tpu_torch.parallel import tp
from masked_diffusion_tpu_torch.parallel.mesh import (
    MeshPlan,
    all_reduce_sum,
    local_rows,
    place_model,
    round_up,
)
from masked_diffusion_tpu_torch.parallel.sp import validate_spatial
from masked_diffusion_tpu_torch.sample.interpolation import (
    make_interpolation_sample_fn,
    validate_interpolation_modes,
)
from masked_diffusion_tpu_torch.sample.latent import latent_initial
from masked_diffusion_tpu_torch.sample.loop import make_sample_fn, validate_modes
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
    make_train_visuals_fn,
)
from masked_diffusion_tpu_torch.utils import host, profiling
from masked_diffusion_tpu_torch.utils.grids import (
    save_image_grid,
    save_multi_index_image_grid,
    save_png,
)

__all__ = ["Trainer", "build_model_from_config", "unported_options"]


def unported_options(cfg: Config) -> List[str]:
    """The flags of cfg that ask for something the port has not yet."""
    asked = []
    if cfg.epoch_scan:
        asked.append("--epoch_scan")
    return asked


def _ckpt_meta(model, cfg: Config) -> dict:
    """meta.json's topology and EMA hyperparameters (trainer.py:_unet_meta),
    so masked_diffusion_tpu.io tooling reads the checkpoint as its own."""
    meta = {"unet_config": unet_config_meta(model.config)}
    if cfg.use_ema:
        meta["ema"] = {
            "decay": cfg.ema_max_decay,
            "min_decay": 0.0,
            "use_ema_warmup": True,
            "inv_gamma": cfg.ema_inv_gamma,
            "power": cfg.ema_power,
            "update_after_step": 0,
        }
    return meta


#: the draw-stream index of the cadence's visuals pass (steps count from 0)
VISUALS_INDEX = -1


class Trainer:
    def __init__(
        self,
        cfg: Config,
        dataset: InMemoryDataset,
        dataset_hist=None,
        visualizer=None,
        model: Optional[torch.nn.Module] = None,
        schedule: Optional[MaskSchedule] = None,
        device="cuda",
        plan: Optional[MeshPlan] = None,
    ):
        asked = unported_options(cfg)
        if asked:
            raise NotImplementedError(f"not yet ported: {', '.join(asked)}")
        # silently-broken mode couplings fail here, not at the first save
        # cadence (config.py:validate_sampling_modes); so do sampling modes
        # the cadence's sampler refuses
        if cfg.use_ema:
            validate_modes(cfg)
        else:
            validate_sampling_modes(cfg)
        if cfg.interpolation_shift is not None:
            validate_interpolation_modes(cfg)

        self.cfg = cfg
        self.dataset = dataset
        self.dataset_hist = dataset_hist
        self.visualizer = visualizer
        self.device = torch.device(device)
        self.plan = plan or MeshPlan(device=self.device)
        if cfg.mesh_spatial:
            validate_spatial(self.plan, cfg.data_size)
            self.plan = dataclasses.replace(self.plan, spatial=True)
        local_rows(cfg.batch_size, self.plan)  # the global batch divides the ranks
        self.schedule = schedule or build_schedule(
            cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
            cfg.select_degrade_pixel, cfg.ddpm_schedule_base,
        )
        cfg.updated_ddpm_num_steps = self.schedule.num_steps
        if model is None:
            torch.manual_seed(cfg.seed)
            model = build_model_from_config(cfg)
        self.model = place_model(model.to(self.device), self.plan, cfg.tp_min_features)
        self._ckpt_meta = _ckpt_meta(self.model, cfg)

        steps_per_epoch = dataset.num_batches(cfg.batch_size)
        total_steps = max(1, steps_per_epoch * cfg.num_epochs)
        self.lr_schedule = build_lr_schedule(
            cfg.lr_scheduler, cfg.lr,
            cfg.lr_warmup_steps * cfg.gradient_accumulation_steps,
            total_steps, cfg.lr_cycle,
        )
        names, params = zip(*self.model.named_parameters())
        optimizer = build_optimizer(cfg.optim, params, self.lr_schedule, 1.0,
                                    cfg.gradient_accumulation_steps, names=names)
        if getattr(self.model, "tp_sharded", ()):
            optimizer.set_tensor_parallel(self.model.tp_sharded, self.plan.model_group)
        self.state = create_train_state(self.model, optimizer, use_ema=cfg.use_ema,
                                        plan=self.plan)
        self._step_cache: Dict[tuple, callable] = {}
        self._visuals_cache: Dict[tuple, callable] = {}
        self._data_dev: Optional[torch.Tensor] = None
        self._last_batch: Optional[torch.Tensor] = None  # this rank's rows, on the device
        self.loss_mean_epoch: List[float] = []
        self.lr_list: List[float] = []
        self.global_step = 0
        self.timesteps_used_epoch = None
        # the step losses of an epoch a preemption cut, from restore: the
        # resumed epoch's mean covers them too
        self._cut_epoch_losses: List[float] = []
        self._preempt_requested = False

    # ------------------------------------------------------------------ resume
    def restore(self, path: str) -> int:
        """Full-state resume from a checkpoint of io/checkpoint.py: params,
        EMA, the optimizer's state, TrainState.step (the EMA warmup) and the
        loss and LR history, onto this trainer's device (every rank loads
        the same files). Returns the restored global step. Raises when the
        checkpoint lacks the EMA (with EMA on) or the optimizer state."""
        model_sd, ema_sd, opt_state, meta = ckpt_io.load_checkpoint(path)
        missing = [name for name, expected, got in (
            ("unet_ema", self.state.ema_model, ema_sd),
            ("optimizer", self.state.optimizer, opt_state)) if expected is not None and got is None]
        if missing:
            raise ValueError(
                f"checkpoint {path} is missing {missing}; resuming would silently "
                "re-initialize that state. Use --method sample for params-only "
                "checkpoints, or point at a complete checkpoint.")
        tensors, scalars = opt_state
        if scalars["mini_step"] > 0:
            ranks = scalars.get("grad_ranks", 1)
            if ranks != self.plan.data_size:
                raise ValueError(
                    f"checkpoint {path} was taken inside an accumulation window on {ranks} "
                    f"data rank(s); its gradient sums resume only on as many, not "
                    f"{self.plan.data_size}")
            if ranks > 1:  # every data rank's own sum, stacked by data rank
                tensors = {k: v[self.plan.data_rank] if k.endswith(".grad") else v
                           for k, v in tensors.items()}
            if self.plan.spatial:  # the model group's first rank carries the sum
                m = self.plan.model_size
                tensors = {k: (v * m if self.plan.model_rank == 0 else torch.zeros_like(v))
                           if k.endswith(".grad") else v for k, v in tensors.items()}
        self.model.load_state_dict(tp.scatter_state(model_sd, self.model, self.plan))
        if self.state.ema_model is not None:
            self.state.ema_model.load_state_dict(
                tp.scatter_state(ema_sd, self.model, self.plan))
        self.state.optimizer.load_state_dict(
            tp.scatter_state(tensors, self.model, self.plan), scalars)
        global_step = int(meta.get("global_step", 0))
        self.state.step = global_step
        self.global_step = global_step
        hist = meta.get("history", {})
        self.loss_mean_epoch = [float(v) for v in hist.get("loss_mean_epoch", [])]
        self.lr_list = [float(v) for v in hist.get("lr_list", [])]
        self._cut_epoch_losses = [float(v) for v in hist.get("cut_epoch_losses", [])]
        return global_step

    def _get_step_fn(self, used: np.ndarray):
        key = tuple(int(t) for t in used)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.model, self.schedule, self.cfg, self.state.optimizer, used,
                self.lr_schedule, self.device, self.plan,
            )
        return self._step_cache[key]

    def _get_visuals_fn(self, used: np.ndarray):
        key = tuple(int(t) for t in used)
        if key not in self._visuals_cache:
            self._visuals_cache[key] = make_train_visuals_fn(
                self.model, self.schedule, self.cfg, used, self.device, self.plan)
        return self._visuals_cache[key]

    # ------------------------------------------------------------------ train
    def _step_generator(self, epoch: int, index: int) -> torch.Generator:
        """The CPU generator of draw stream `index` of `epoch` on this rank."""
        seed = step_seed(self.cfg.seed, epoch, index)
        return torch.Generator().manual_seed(fold_seed(seed, self.plan.data_rank))

    def train(self, epoch_start: int = 0, epoch_length: Optional[int] = None,
              resume_step: int = 0, global_step: Optional[int] = None, dirs=None,
              visualizer=None) -> Dict:
        """Train epochs epoch_start .. epoch_start + epoch_length - 1, the
        first from its batch resume_step on, counting global steps from
        global_step (default: this trainer's count). Returns
        {"loss_mean_epoch", "last_metrics", "ms_per_step", "images_per_sec",
        "checkpoints", "preempted"}; the rates leave out the first epoch
        (compiles and autotuning) when there is more than one, and the
        traced epoch of --profile_dir where another is left. SIGTERM during
        the call preempts (the module docstring)."""
        if global_step is not None:
            self.global_step = global_step
        self._preempt_requested = False

        def on_sigterm(*_):
            self._preempt_requested = True

        try:
            previous = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread: run unprotected
            previous = None
        try:
            return self._train_epochs(epoch_start, epoch_length, resume_step, dirs,
                                      visualizer or self.visualizer)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
            # a drain error must not mask an exception already in flight
            unwinding = sys.exc_info()[0] is not None
            try:
                ckpt_io.wait_for_async_saves()
            except Exception as err:
                if not unwinding:
                    raise
                print(f"WARNING: an async checkpoint write failed while unwinding another "
                      f"exception: {err}", flush=True)

    def _train_epochs(self, epoch_start, epoch_length, resume_step, dirs, visualizer) -> Dict:
        cfg = self.cfg
        epoch_length = cfg.num_epochs if epoch_length is None else epoch_length
        # the curriculum and the cadence follow the configured total, never
        # the loop bounds, so a resumed run sees the uninterrupted run's
        epoch_total = max(cfg.num_epochs, epoch_start + epoch_length)
        # one process acts on SIGTERM after the step in flight; ranks only at
        # an epoch's end, once they agree (acting alone would desynchronize
        # their collectives)
        single = self.plan.world_size <= 1
        # the first epoch after epoch_start's compiles (trainer.py:421)
        profile_epoch = epoch_start + 1 if epoch_length > 1 else epoch_start
        if self._data_dev is None:
            self._data_dev = torch.from_numpy(self.dataset.data).to(self.device)
        last_metrics: Dict[str, float] = {}
        timed: List[tuple] = []  # (seconds, steps, traced) per epoch
        checkpoints: List[str] = []
        preempted = False
        for epoch in range(epoch_start, epoch_start + epoch_length):
            t_start = time.perf_counter()
            rng = np.random.default_rng([cfg.seed, epoch])
            used = self.schedule.timesteps_for_epoch(
                epoch, epoch_total, cfg.scheduler_num_scale_timesteps
            )
            self.timesteps_used_epoch = used
            step_fn = self._get_step_fn(used)

            # the shuffle is drawn whole; a resumed epoch skips the batches
            # its preempted run trained
            rows = list(self.dataset.epoch_index_batches(rng, cfg.batch_size))
            first = resume_step if epoch == epoch_start else 0
            carried = self._cut_epoch_losses if first else []
            self._cut_epoch_losses = []
            losses = []
            traced = cfg.profile_dir if epoch == profile_epoch else None
            if rows[first:]:
                # one host->device transfer of the epoch's index rows, this
                # rank's columns of each global batch
                sel = np.stack(rows[first:])[:, local_rows(cfg.batch_size, self.plan)]
                sel = torch.as_tensor(sel, device=self.device)
                with profiling.trace(traced, self.plan.rank, self.device):
                    for i in range(first, len(rows)):
                        with (torch.profiler.record_function(f"train_step epoch {epoch} step {i}")
                              if traced else contextlib.nullcontext()):
                            self._last_batch = self._data_dev[sel[i - first]]
                            losses.append(step_fn(self.state, self._last_batch,
                                                  self._step_generator(epoch, i)))
                        self.global_step += 1
                        if single and self._preempt_requested:
                            break
            stop = self._preempt_requested
            if losses:
                # host sync once per epoch, as ONE stacked transfer of the
                # steps' metrics, their mean over the ranks with the
                # preemption flag OR-ed in (one collective)
                keys = list(losses[0].keys())
                mat = torch.stack([torch.stack([m[k] for k in keys]) for m in losses])
                flat = torch.cat([mat.flatten(), mat.new_tensor([float(stop)])])
                flat = host.mean_over_ranks(flat).cpu()
                stop = bool(flat[-1] > 0)
                losses = [{k: float(v) for k, v in zip(keys, row)}
                          for row in flat[:-1].view(mat.shape).numpy()]
            else:
                stop = host.any_flag(stop)
            epoch_time = time.perf_counter() - t_start
            timed.append((epoch_time, len(losses), bool(traced)))

            # a non-finite loss poisons params, EMA and every later
            # checkpoint: save a post-mortem checkpoint and stop
            if losses and not all(np.isfinite(m["train_loss"]) for m in losses):
                if dirs is not None:
                    self._save_checkpoint(dirs, epoch, {"non_finite_loss": True})
                raise FloatingPointError(
                    f"non-finite train loss at epoch {epoch} "
                    f"(global step {self.global_step}); post-mortem checkpoint saved"
                )
            step_losses = carried + [m["train_loss"] for m in losses]
            self.loss_mean_epoch.append(statistics.mean(step_losses) if step_losses else 0.0)
            self.lr_list.extend(m.get("lr", 0.0) for m in losses)
            last_metrics = losses[-1] if losses else {}

            if stop:
                hist = self._history()
                if self.global_step % max(1, len(rows)):
                    # a cut epoch: the resumed run re-enters it and takes the
                    # mean over all of its steps
                    self.loss_mean_epoch.pop()
                    hist = self._history(cut_epoch_losses=step_losses)
                if dirs is not None:
                    checkpoints.append(self._save_checkpoint(
                        dirs, epoch, {"preempted": True}, hist, cfg.keep_last_checkpoints))
                if host.is_main_process():
                    print(f"SIGTERM: resumable checkpoint saved at epoch {epoch} (global step "
                          f"{self.global_step}); exiting cleanly", flush=True)
                preempted = True
                break

            if visualizer is not None and losses:
                visualizer.plot_current_losses(
                    epoch,
                    {
                        **last_metrics,
                        "epoch_time_s": epoch_time,
                        "steps_per_sec": len(losses) / max(epoch_time, 1e-9),
                        "imgs_per_sec": len(losses) * cfg.batch_size / max(epoch_time, 1e-9),
                    },
                    "value",
                )

            if dirs is not None and self._on_save_cadence(epoch, epoch_start, epoch_length):
                # the sampling and the visuals pass end in collectives: every
                # rank runs them; the writes inside are rank 0's
                if host.is_main_process():
                    self._save_learning_curve(dirs)
                self._save_train_visuals(dirs, epoch, used,
                                         self._step_generator(epoch, VISUALS_INDEX), visualizer)
                if cfg.use_ema:
                    # --sampling dispatch (trainer_masked_mean_shift.py:254-260)
                    if cfg.sampling == "base":
                        self._save_ema_sample(dirs, epoch, visualizer)
                    else:
                        self._save_ema_momentum_sample(dirs, epoch, visualizer)
                # independent of EMA: the raw weights when it is off
                if cfg.interpolation_shift is not None:
                    self._save_interpolation_sample(dirs, epoch, visualizer)
                checkpoints.append(self._save_checkpoint(
                    dirs, epoch, None, self._history(), cfg.keep_last_checkpoints,
                    cfg.async_checkpoints))

        steady = timed[1:] if len(timed) > 1 else timed
        steady = [t for t in steady if not t[2]] or steady
        seconds = sum(t for t, _, _ in steady)
        steps = sum(n for _, n, _ in steady)
        return {
            "loss_mean_epoch": self.loss_mean_epoch,
            "last_metrics": last_metrics,
            "ms_per_step": 1e3 * seconds / max(steps, 1),
            "images_per_sec": steps * cfg.batch_size / max(seconds, 1e-9),
            "checkpoints": checkpoints,
            "preempted": preempted,
        }

    def _on_save_cadence(self, epoch: int, epoch_start: int, epoch_length: int) -> bool:
        """trainer_masked_mean_shift.py:252's cadence, plus the loop's last
        epoch (trainer.py:674-688)."""
        cfg = self.cfg
        epoch_total = max(cfg.num_epochs, epoch_start + epoch_length)
        scale_period = max(1, int(epoch_total / max(1, cfg.scheduler_num_scale_timesteps)))
        return (
            (epoch > 0 and (epoch + 1) % cfg.save_images_epochs == 0)
            or epoch == (epoch_start + epoch_length - 1)
            or (epoch + 1) % scale_period == 0
        )

    # ------------------------------------------------------------------ artifacts
    def _history(self, **extra) -> dict:
        """history.npz's curves, and `extra` keys."""
        return {"loss_mean_epoch": self.loss_mean_epoch, "lr_list": self.lr_list, **extra}

    def _optimizer_state(self):
        """The optimizer's state for a checkpoint, in the one-process layout
        (TP's slices gathered; collective). Inside an accumulation window
        under DDP each data rank's gradient sum is its own (no_sync): they
        are stacked by data rank (collective), so that every rank resumes
        its own; under SP a data rank's sum is its model group's shares
        summed (each scaled by the loss's M)."""
        plan = self.plan
        tensors, scalars = self.state.optimizer.state_dict()
        tensors = tp.gather_state(tensors, self.model, plan)
        if scalars["mini_step"] > 0 and plan.spatial:
            tensors = {k: all_reduce_sum(v, plan.model_group) / plan.model_size
                       if k.endswith(".grad") else v for k, v in tensors.items()}
        if scalars["mini_step"] > 0 and plan.data_size > 1:
            tensors = {k: host.gather(v[None], plan.data_group) if k.endswith(".grad") else v
                       for k, v in tensors.items()}
            scalars["grad_ranks"] = plan.data_size
        return tensors, scalars

    def _save_checkpoint(self, dirs, epoch: int, extra_meta: Optional[dict] = None,
                         history: Optional[dict] = None, keep_last: int = 0,
                         async_save: bool = False) -> str:
        """Rank 0 writes the checkpoint (io/checkpoint.py) after a barrier;
        every rank returns its path once it is on disk, or, async, once its
        host copy is taken."""
        ema = self.state.ema_model
        config = diffusers_config_from_unet(self.model.config)
        ema_config = None
        if ema is not None:
            # EMAModel.save_pretrained merges its hyperparameters into
            # config.json (io/export_torch.py does the same)
            ema_config = {**config, "optimization_step": int(self.global_step),
                          **self._ckpt_meta.get("ema", {})}
        optimizer_state = self._optimizer_state()
        # the one-process layout: TP's slices gathered on every rank (collective)
        model_sd = tp.gather_state(self.model.state_dict(), self.model, self.plan)
        ema_sd = (tp.gather_state(ema.state_dict(), self.model, self.plan)
                  if ema is not None else None)
        checkpoint_dir = dirs.list_dir["checkpoint"]
        host.barrier()
        if host.is_main_process():
            ckpt_io.save_checkpoint(
                checkpoint_dir, epoch, self.global_step, model_sd, ema_sd, optimizer_state,
                extra_meta={**self._ckpt_meta, **(extra_meta or {})}, history=history,
                keep_last=keep_last, async_save=async_save, config=config,
                ema_config=ema_config,
            )
        host.barrier()
        return os.path.join(checkpoint_dir, f"checkpoint-epoch-{epoch}")

    def _save_learning_curve(self, dirs) -> None:
        """3-panel loss/lr/schedule PNG (trainer_masked.py:275-297); skipped
        where matplotlib is not installed (rank 0 only)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig = plt.figure(figsize=(24, 8))
        plt.subplot(1, 3, 1)
        plt.plot(np.asarray(self.loss_mean_epoch), color="red")
        plt.title("loss")
        plt.subplot(1, 3, 2)
        plt.plot(np.asarray(self.lr_list), color="red")
        plt.title("learning rate")
        plt.subplot(1, 3, 3)
        ratios = np.asarray(self.schedule.ratios)
        plt.plot(ratios, color="red")
        plt.title(f"degrade black area num = {len(ratios)}")
        plt.tight_layout()
        plt.savefig(os.path.join(dirs.list_dir["train_loss"], "loss.png"),
                    bbox_inches="tight", dpi=100)
        plt.close(fig)

    # tensor name -> run-directory key (utils/dirs.py == dirutils.py:77-101).
    # 'noisy_img' is the degraded image (scheduler.py:260 names its output
    # noisy_img); 'noise_img' holds the network's predicted residual (the
    # reference calls it 'mask', trainer_masked_mean_shift.py:140).
    _VISUAL_DIRS = {
        "input": "train_img",
        "degraded_img": "noisy_img",
        "degrade_binary_masks": "mask_img",
        "degradation_mask": "mask_img",
        "mean_pixel": "img",
        "mask": "noise_img",
        "reconstructed_img": "predict_img",
        "inverse_shift_reconstructed_img": "predict_img",
        "shift": "shift_img",
        "shifted_degrade_img": "shift_noisy",
    }

    def _save_train_visuals(self, dirs, epoch: int, used, generator, visualizer=None) -> None:
        """The last batch's train-time tensors as global and local grids in
        the run tree and the visualizer (trainer_masked.py:58-80,300-342,
        trainer_masked_mean_shift.py:264): one forward per save cadence on
        each rank's rows, gathered (collective) before rank 0 writes."""
        if self._last_batch is None:
            return
        out = self._get_visuals_fn(used)(self._last_batch, generator)
        out = {name: host.fetch(tensor, self.plan.data_group) for name, tensor in out.items()}
        if not host.is_main_process():
            return
        display = {}
        for name, arr in out.items():
            d = dirs.list_dir.get(self._VISUAL_DIRS.get(name, "img"))
            if d is None or not os.path.isdir(d):
                continue
            display[f"{name}_normalize_global"] = save_image_grid(
                arr, "global", d, f"{name}_{epoch:05d}_global.png")
            display[f"{name}_normalize_local"] = save_image_grid(
                arr, "image", d, f"{name}_{epoch:05d}_local.png")
        if visualizer is not None and display:
            visualizer.display_current_results(epoch, display)

    def sample_ema(self, generator: torch.Generator, sample_num: Optional[int] = None,
                   capture: Optional[bool] = None):
        """sample_num images (N, H, W, C), a numpy array on every rank, from
        the EMA weights (the online weights when EMA is off). The latents
        are drawn over the global batch rounded up to the ranks (JAX
        _cadence_latent); each rank samples its rows and `fetch` gathers
        them (collective). With capture (default: --capture_trajectory)
        returns (images, trajectory): the sampler's trajectory of the first
        4 images, device tensors (sample/loop.py). The sampler casts its
        model to the compute dtype in place, so it gets a copy."""
        cfg = self.cfg
        capture = cfg.capture_trajectory if capture is None else capture
        used = self.timesteps_used_epoch
        if used is None:
            used = self.schedule.timesteps_for_epoch(
                0, cfg.num_epochs, cfg.scheduler_num_scale_timesteps
            )
        source = self.state.ema_model if self.state.ema_model is not None else self.model
        # only _save_trajectory_grids' 4 items are ever rendered
        sample_fn = make_sample_fn(copy.deepcopy(source), self.schedule, cfg, used,
                                   device=self.device, plan=self.plan,
                                   capture_trajectory=capture, capture_items=4 if capture else 0)
        num = sample_num or cfg.sample_num
        padded = round_up(num, self.plan.data_size)
        latent = latent_initial(
            generator, padded, cfg.out_channel, cfg.data_size,
            cfg.sample_latent_shape, cfg.mean_area, self.dataset_hist, device=self.device,
        )
        out = sample_fn(latent[local_rows(padded, self.plan)], generator)
        if capture:
            return host.fetch(out[0], self.plan.data_group)[:num], out[1]
        return host.fetch(out, self.plan.data_group)[:num]

    @staticmethod
    def _fetch_trajectory(trajectory: dict, n_items: int = 4) -> dict:
        """The captured image buffers on the host, the first n_items only:
        {field: (n_items, T, H, W, C) numpy}."""
        return {name: buf[:, :n_items].cpu().numpy().transpose(1, 0, 2, 3, 4)
                for name, buf in trajectory.items() if name != "means"}

    @staticmethod
    def _save_trajectory_grids(dirs, epoch: int, trajectory: dict) -> None:
        """One grid over the timesteps per captured field and item
        (sampler.py:390-417), from _fetch_trajectory's arrays (rank 0)."""
        d = dirs.list_dir["sample_all_t"]
        for name, traj in trajectory.items():
            for i, g in enumerate(save_multi_index_image_grid(traj, normalization="image")):
                save_png(np.clip(g, 0.0, 1.0), os.path.join(d, f"{name}_{epoch:05d}_item{i}.png"))

    def _save_result_grids(self, dirs, epoch: int, sample: np.ndarray, visualizer) -> None:
        d = dirs.list_dir["ema_sample_img"]
        g_global = save_image_grid(sample, "global", d, f"ema_sample_{epoch:05d}_global.png")
        g_local = save_image_grid(sample, "image", d, f"ema_sample_{epoch:05d}_local.png")
        if visualizer is not None:
            visualizer.display_current_results(
                epoch,
                {
                    "ema_sample_result_normalize_global": g_global,
                    "ema_sample_result_normalize_local": g_local,
                },
            )

    def _save_ema_momentum_sample(self, dirs, epoch: int, visualizer=None) -> None:
        """EMA sampling + global/local grids (trainer_masked_mean_shift.py:
        409-429); with --capture_trajectory, the trajectory grids too."""
        out = self.sample_ema(torch.Generator().manual_seed(self.cfg.seed + epoch))
        if not host.is_main_process():
            return  # the sampling ended in a collective gather; writes are rank 0's
        if isinstance(out, tuple):
            out, trajectory = out
            self._save_trajectory_grids(dirs, epoch, self._fetch_trajectory(trajectory))
        self._save_result_grids(dirs, epoch, out, visualizer)

    def _save_ema_sample(self, dirs, epoch: int, visualizer=None) -> None:
        """--sampling base: EMA sampling with trajectory capture — the result
        grids, the trajectory grids and the trajectory means (the intent of
        trainer_masked_mean_shift.py:374-404, whose unpack of the sampler's
        returns is stale). The means are the full batch's, averaged over
        the steps."""
        sample, trajectory = self.sample_ema(
            torch.Generator().manual_seed(self.cfg.seed + epoch), capture=True)
        if not host.is_main_process():
            return
        m = trajectory["means"]
        means = {
            "ema_sample_mean": float(sample.mean()),
            "ema_sample_t_mean": float(m["sample_t"].mean()),
            "ema_sample_0_mean": float(m["sample_0"].mean()),
            "ema_sample_shift_t_mean": float(m["shifted"].mean()),
            "ema_sample_0_shift_mean": float(m["shifted_result"].mean()),
        }
        self._save_trajectory_grids(dirs, epoch, self._fetch_trajectory(trajectory))
        self._save_result_grids(dirs, epoch, sample, visualizer)
        if visualizer is not None:
            visualizer.plot_current_losses(epoch, means, "value")

    def _save_interpolation_sample(self, dirs, epoch: int, visualizer=None) -> None:
        """--interpolation_shift: the interpolation sweep (sampler.py:102-106,
        264-366) from the EMA weights (the raw ones with EMA off), one grid
        with global normalisation (trainer.py:916-948). The sampler casts its
        model to the compute dtype in place, so it gets a copy, built per
        call as in sample_ema. The sample is gathered (collective) before
        rank 0 writes."""
        cfg = self.cfg
        used = self.timesteps_used_epoch
        if used is None:
            used = self.schedule.timesteps_for_epoch(
                0, cfg.num_epochs, cfg.scheduler_num_scale_timesteps
            )
        source = self.state.ema_model if cfg.use_ema else self.model
        sample_fn = make_interpolation_sample_fn(
            copy.deepcopy(source), self.schedule, cfg, used, float(cfg.interpolation_shift),
            device=self.device, plan=self.plan)
        sample, _mu = sample_fn(torch.Generator().manual_seed(cfg.seed + epoch + 1))
        sample = sample.cpu().numpy()
        if not host.is_main_process():
            return
        g = save_image_grid(sample, "global", dirs.list_dir["ema_sample_img"],
                            f"ema_interpolation_{epoch:05d}.png")
        if visualizer is not None:
            visualizer.display_current_results(epoch, {"ema_interpolation_sample": g})
