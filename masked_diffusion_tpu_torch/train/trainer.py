"""Training orchestration: the host-side shell around the train step.

Counterpart of masked_diffusion_tpu/train/trainer.py without a mesh: epoch
loop, per-epoch timestep curriculum, metrics fetched once per epoch, the
non-finite-loss guard, the metrics JSONL, and on the save cadence an EMA
sample grid (the port's fused sampler) and a checkpoint in the export
layout, checkpoint-epoch-N/{unet,unet_ema}/ with meta.json, which the
port's `--method sample` serves.

  shuffle     np.random.default_rng([seed, epoch]), as trainer.py:477, so
              batch membership equals the JAX trainer's
  curriculum  schedule.timesteps_for_epoch(epoch, epoch_total, scale)
  data        the whole (subset) dataset on the device once; each epoch's
              index rows cross in one transfer, so a step makes no host sync
  seeds       a CPU torch.Generator per epoch, seeded from (seed, epoch)

The model comes from models/factory.build_model_from_config: the default
factory or a zoo name (--model unet1..unet6). Its attention takes the
tiny-head kernel wherever it applies; --tinyhead_attention false is refused.

Not ported yet, and refused at construction when a flag asks for them:
resume (--resume_from_checkpoint), --sampling base with EMA (its cadence
captures trajectories), trajectory capture, interpolation sampling,
multi-GPU meshes, profiling, checkpoint retention and async saves, and the
JAX-only switches (--epoch_scan, --remat, --attention_chunk). Not written:
optimizer state on disk, the loss PNG and the train-visual grids.
"""

from __future__ import annotations

import copy
import os
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import Config, validate_sampling_modes
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset
from masked_diffusion_tpu_torch.io.weights import diffusers_config_from_unet, save_checkpoint
from masked_diffusion_tpu_torch.models.factory import build_model_from_config
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule, build_schedule
from masked_diffusion_tpu_torch.sample.latent import latent_initial
from masked_diffusion_tpu_torch.sample.loop import fused_mode, make_sample_fn
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import create_train_state, make_train_step
from masked_diffusion_tpu_torch.utils.grids import save_image_grid

__all__ = ["Trainer", "build_model_from_config", "unported_options"]


def unported_options(cfg: Config) -> List[str]:
    """The flags of cfg that ask for something the port has not yet."""
    asked = []
    if str(cfg.resume_from_checkpoint) != "False":
        asked.append(f"--resume_from_checkpoint {cfg.resume_from_checkpoint} (resume)")
    if cfg.use_ema and cfg.sampling == "base":
        asked.append("--sampling base (its save cadence captures sampling trajectories)")
    if cfg.capture_trajectory:
        asked.append("--capture_trajectory")
    if cfg.interpolation_shift is not None:
        asked.append("--interpolation_shift (interpolation sampling)")
    if cfg.mesh_data not in (-1, 1) or cfg.mesh_model != 1 or cfg.mesh_spatial:
        asked.append("--mesh_data/--mesh_model/--mesh_spatial (multi-GPU)")
    if cfg.profile_dir:
        asked.append("--profile_dir")
    if cfg.keep_last_checkpoints:
        asked.append("--keep_last_checkpoints")
    if cfg.async_checkpoints:
        asked.append("--async_checkpoints")
    for flag in ("epoch_scan", "remat"):
        if getattr(cfg, flag):
            asked.append(f"--{flag}")
    if cfg.attention_chunk:
        asked.append("--attention_chunk")
    return asked


def _ckpt_meta(model, cfg: Config) -> dict:
    """meta.json's topology and EMA hyperparameters (trainer.py:_unet_meta),
    so masked_diffusion_tpu.io tooling reads the checkpoint as its own."""
    ucfg = model.config
    meta = {
        "unet_config": {
            "sample_size": ucfg.sample_size,
            "in_channels": ucfg.in_channels,
            "out_channels": ucfg.out_channels,
            "block_out_channels": list(ucfg.block_out_channels),
            "layers_per_block": ucfg.layers_per_block,
            "attn_down": list(ucfg.attn_down),
            "attn_up": list(ucfg.attn_up),
            "attention_head_dim": ucfg.attention_head_dim,
            "norm_groups": ucfg.norm_groups,
        }
    }
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


def _cpu_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}


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
    ):
        asked = unported_options(cfg)
        if asked:
            raise NotImplementedError(f"not yet ported: {', '.join(asked)}")
        # silently-broken mode couplings fail here, not at the first save
        # cadence (config.py:validate_sampling_modes); so do sampling modes
        # the cadence's fused sampler does not cover
        validate_sampling_modes(cfg)
        if cfg.use_ema:
            fused_mode(cfg)

        self.cfg = cfg
        self.dataset = dataset
        self.dataset_hist = dataset_hist
        self.visualizer = visualizer
        self.device = torch.device(device)
        self.schedule = schedule or build_schedule(
            cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
            cfg.select_degrade_pixel, cfg.ddpm_schedule_base,
        )
        cfg.updated_ddpm_num_steps = self.schedule.num_steps
        if model is None:
            torch.manual_seed(cfg.seed)
            model = build_model_from_config(cfg)
        self.model = model.to(self.device)
        self._ckpt_meta = _ckpt_meta(self.model, cfg)

        steps_per_epoch = dataset.num_batches(cfg.batch_size)
        total_steps = max(1, steps_per_epoch * cfg.num_epochs)
        self.lr_schedule = build_lr_schedule(
            cfg.lr_scheduler, cfg.lr,
            cfg.lr_warmup_steps * cfg.gradient_accumulation_steps,
            total_steps, cfg.lr_cycle,
        )
        optimizer = build_optimizer(cfg.optim, self.model.parameters(), self.lr_schedule,
                                    1.0, cfg.gradient_accumulation_steps)
        self.state = create_train_state(self.model, optimizer, use_ema=cfg.use_ema)
        self._step_cache: Dict[tuple, callable] = {}
        self._data_dev: Optional[torch.Tensor] = None
        self.loss_mean_epoch: List[float] = []
        self.global_step = 0
        self.timesteps_used_epoch = None

    def _get_step_fn(self, used: np.ndarray):
        key = tuple(int(t) for t in used)
        if key not in self._step_cache:
            self._step_cache[key] = make_train_step(
                self.model, self.schedule, self.cfg, self.state.optimizer, used,
                self.lr_schedule, self.device,
            )
        return self._step_cache[key]

    # ------------------------------------------------------------------ train
    def train(self, epoch_start: int = 0, epoch_length: Optional[int] = None,
              dirs=None, visualizer=None) -> Dict:
        """Train epochs epoch_start .. epoch_start + epoch_length - 1.
        Returns {"loss_mean_epoch", "last_metrics", "ms_per_step",
        "images_per_sec", "checkpoints"}; the rates leave out the first
        epoch (compiles and autotuning) when there is more than one."""
        cfg = self.cfg
        epoch_length = cfg.num_epochs if epoch_length is None else epoch_length
        visualizer = visualizer or self.visualizer
        epoch_total = max(cfg.num_epochs, epoch_start + epoch_length)
        if self._data_dev is None:
            self._data_dev = torch.from_numpy(self.dataset.data).to(self.device)
        last_metrics: Dict[str, float] = {}
        timed: List[tuple] = []  # (seconds, steps) per epoch
        checkpoints: List[str] = []
        for epoch in range(epoch_start, epoch_start + epoch_length):
            t_start = time.perf_counter()
            rng = np.random.default_rng([cfg.seed, epoch])
            gen = torch.Generator().manual_seed((cfg.seed + 1) * 1_000_003 + epoch)
            used = self.schedule.timesteps_for_epoch(
                epoch, epoch_total, cfg.scheduler_num_scale_timesteps
            )
            self.timesteps_used_epoch = used
            step_fn = self._get_step_fn(used)

            rows = list(self.dataset.epoch_index_batches(rng, cfg.batch_size))
            losses = []
            if rows:
                # one host->device transfer of the epoch's index rows
                sel = torch.as_tensor(np.stack(rows), device=self.device)
                for i in range(len(rows)):
                    losses.append(step_fn(self.state, self._data_dev[sel[i]], gen))
                    self.global_step += 1
                # host sync once per epoch, as ONE stacked transfer
                keys = list(losses[0].keys())
                mat = torch.stack([torch.stack([m[k] for k in keys]) for m in losses]).cpu()
                losses = [{k: float(v) for k, v in zip(keys, row)} for row in mat.numpy()]
            epoch_time = time.perf_counter() - t_start
            timed.append((epoch_time, len(losses)))

            # a non-finite loss poisons params, EMA and every later
            # checkpoint: save a post-mortem checkpoint and stop
            if losses and not all(np.isfinite(m["train_loss"]) for m in losses):
                if dirs is not None:
                    self._save_checkpoint(dirs, epoch, {"non_finite_loss": True})
                raise FloatingPointError(
                    f"non-finite train loss at epoch {epoch} "
                    f"(global step {self.global_step}); post-mortem checkpoint saved"
                )
            loss_mean = statistics.mean(m["train_loss"] for m in losses) if losses else 0.0
            self.loss_mean_epoch.append(loss_mean)
            last_metrics = losses[-1] if losses else {}

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
                if cfg.use_ema:
                    self._save_ema_momentum_sample(dirs, epoch, visualizer)
                checkpoints.append(self._save_checkpoint(dirs, epoch))

        steady = timed[1:] if len(timed) > 1 else timed
        seconds = sum(t for t, _ in steady)
        steps = sum(n for _, n in steady)
        return {
            "loss_mean_epoch": self.loss_mean_epoch,
            "last_metrics": last_metrics,
            "ms_per_step": 1e3 * seconds / max(steps, 1),
            "images_per_sec": steps * cfg.batch_size / max(seconds, 1e-9),
            "checkpoints": checkpoints,
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
    def _save_checkpoint(self, dirs, epoch: int, extra_meta: Optional[dict] = None) -> str:
        ema = self.state.ema_model
        meta = {
            "epoch": int(epoch),
            "global_step": int(self.global_step),
            "items": ["unet"] + (["unet_ema"] if ema is not None else []),
            **self._ckpt_meta,
            **(extra_meta or {}),
        }
        config = diffusers_config_from_unet(self.model.config)
        ema_config = None
        if ema is not None:
            # EMAModel.save_pretrained merges its hyperparameters into
            # config.json (io/export_torch.py does the same)
            ema_config = {**config, "optimization_step": int(self.global_step),
                          **self._ckpt_meta.get("ema", {})}
        path = os.path.join(dirs.list_dir["checkpoint"], f"checkpoint-epoch-{epoch}")
        return save_checkpoint(
            path, _cpu_state_dict(self.model), config,
            ema_sd=_cpu_state_dict(ema) if ema is not None else None,
            ema_config=ema_config, meta=meta,
        )

    def sample_ema(self, generator: torch.Generator, sample_num: Optional[int] = None):
        """sample_num images (N, H, W, C) on the device from the EMA weights
        (the online weights when EMA is off), through the fused sampler. The
        sampler casts its model to the compute dtype in place, so it gets a
        copy."""
        cfg = self.cfg
        used = self.timesteps_used_epoch
        if used is None:
            used = self.schedule.timesteps_for_epoch(
                0, cfg.num_epochs, cfg.scheduler_num_scale_timesteps
            )
        source = self.state.ema_model if self.state.ema_model is not None else self.model
        sample_fn = make_sample_fn(copy.deepcopy(source), self.schedule, cfg, used,
                                   device=self.device)
        latent = latent_initial(
            generator, sample_num or cfg.sample_num, cfg.out_channel, cfg.data_size,
            cfg.sample_latent_shape, cfg.mean_area, self.dataset_hist, device=self.device,
        )
        return sample_fn(latent, generator)

    def _save_ema_momentum_sample(self, dirs, epoch: int, visualizer=None) -> None:
        """EMA sampling + global/local grids (trainer_masked_mean_shift.py:
        409-429)."""
        sample = self.sample_ema(torch.Generator().manual_seed(self.cfg.seed + epoch))
        sample = sample.cpu().numpy()
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
