"""Experiment configuration.

One dataclass replaces the reference's three stacked config layers (argparse with
~60 flags, 82 bash launch scripts, accelerate YAML process topology — reference
main_train_masked.py:347-419 and code/script/**). Field names and defaults match
the reference argparse surface so launch scripts translate 1:1; the CLI shim in
cli/main_train_masked.py exposes the same flag names.

Fields marked "INERT (reference fidelity)" are accepted and recorded in
option.ini but consumed by NOTHING — exactly as in the reference, where they
are parsed and never read (or read by commented-out code). They exist so
reference launch scripts run unmodified; see README "Fidelity notes".

A copy of masked_diffusion_tpu/config.py; the port imports nothing of the
JAX package. tests/test_torch_port_host.py holds it equal to the original.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional


@dataclasses.dataclass
class Config:
    # ------------------------------------------------------------------ dirs / task
    use_wandb: bool = True
    # INERT (reference fidelity): the reference's mlflow calls are commented
    # out (visualizer.py:80-91); the flag routes nowhere on either side
    use_mlflow: bool = True
    task: str = "train"  # train | sample | dataset
    content: str = "test_code"
    dir_work: str = "./"
    dir_dataset: str = "/nas2/dataset"
    data_name: str = "mnist"
    data_set: str = "train"
    data_size: int = 64
    data_subset: bool = False
    data_subset_num: int = 1000
    data_subset_label: Optional[int] = None  # single-class filter (mnist/cifar10)
    date: str = ""
    time: str = ""
    wandb_name: str = "diffusion"
    method: str = "base"  # base | mean_shift | test
    test_method: str = "base"  # INERT (reference fidelity): parsed, never read
    title: str = ""
    # ------------------------------------------------------------------ model / optim
    model: str = "default"
    batch_size: int = 128
    in_channel: int = 3
    out_channel: int = 3
    num_attention: int = 1
    num_epochs: int = 1000
    optim: str = "adamw"  # adam | adamw | sgd
    lr: float = 1e-4
    lr_scheduler: str = "linear"  # cosine | hard_cosine | constant | linear
    lr_warmup_steps: int = 500
    lr_cycle: float = 0.5
    gradient_accumulation_steps: int = 1
    mixed_precision: str = "no"  # no | fp16 | bf16  (bf16 is the TPU-native choice)
    # ------------------------------------------------------------------ ema / diffusion process
    use_ema: bool = True
    ema_inv_gamma: float = 1.0
    ema_power: float = 3.0 / 4.0
    ema_max_decay: float = 0.9999
    loss_weight_use: bool = False
    loss_weight_power_base: float = 10.0
    loss_space: str = "x_0"  # INERT (reference fidelity): parsed, never read
    ddpm_num_steps: int = 1000
    updated_ddpm_num_steps: int = 1000  # filled in after schedule dedup
    ddpm_schedule: str = "linear"  # linear | log | exponential | sigmoid
    ddpm_schedule_base: float = 10.0
    scheduler_num_scale_timesteps: int = 1
    select_degrade_pixel: str = "indexing"  # indexing | thresholding
    degrade_channel: str = "1-channel"  # 1-channel | 3-channel
    mean_option: Any = 0  # float-like | 'degraded_area' | 'non_degraded_area' | '0'
    mean_area: str = "image-wise"  # image-wise | channel-wise
    # INERT (reference fidelity): parsed, never read
    mean_value_accumulate: bool = False
    shift_type: str = "noise_with_perturbation"
    # ['1-d_constant','3-d_constant','noise_reduction','noise_std_reduction',
    #  'noise_with_perturbation','non_shift']
    noise_mean: float = 0.0
    # ------------------------------------------------------------------ sampling
    sample_latent_shape: str = "data"  # data | zero | normal | uniform | grid
    sampling: str = "base"  # base | momentum
    momentum_adaptive: str = "base_momentum"
    # ['base_momentum','base_sampling','momentum','boosting']
    # INERT (reference fidelity): parsed, never read (the 'momentum' update
    # rule reads adaptive_momentum_rate below, sampler.py:223-231)
    adaptive_decay_rate: float = 0.999
    adaptive_momentum_rate: float = 0.9
    sampling_mask_dependency: str = "independent"
    # ['dependent_prev','independent','dependent_t']
    sample_num: int = 100
    sample_epoch_ratio: float = 0.2  # INERT (reference fidelity): never read
    resume_from_checkpoint: str = "False"
    # INERT (TPU-native): the reference passes this to DataLoader workers
    # (main_train_masked.py:288); this framework preloads datasets into RAM
    # (data/datasets.py) and feeds the device async, so there is no worker
    # pool to size
    num_workers: int = 32
    # INERT (reference fidelity): parsed, never read on either side —
    # checkpoint cadence is save_images_epochs (trainer.py save cadence)
    checkpointing_steps: int = 500
    save_images_epochs: int = 10
    output_dir: Optional[str] = None
    # ------------------------------------------------------------------ test
    test_model_path: Optional[str] = None
    # ------------------------------------------------------------------ TPU-native extensions
    seed: int = 0
    mesh_data: int = -1  # -1: all local devices on the data axis
    mesh_model: int = 1  # tensor-parallel axis (parallel/tp.py channel sharding)
    # narrowest output-feature width that shards over 'model' (wide kernels
    # + their adamw moments and EMA leaves); only read when mesh_model > 1
    tp_min_features: int = 256
    # spatial partitioning (parallel/sp.py): use the model axis to shard
    # activations along image HEIGHT instead of channel-sharding the params —
    # for resolutions where one image's activations outgrow a chip's HBM.
    # Mutually exclusive use of the axis with TP; params stay replicated.
    mesh_spatial: bool = False
    capture_trajectory: bool = False  # sampler keeps per-step buffers (HBM-heavy)
    # sampling-only encoder reuse ("Faster Diffusion", arXiv:2312.09608;
    # PAPERS.md): the reverse loop runs the UNet's encoder (conv_in, the
    # down path, the middle) on every K-th step and replays its cached
    # activations through the up path on the steps between
    # (sample/loop.py). An approximation: the JAX package measured it to
    # destroy sample fidelity at T=1421 with K=2. 0/1 = exact sampling.
    encoder_reuse: int = 0
    # route to the interpolation sampler (Sampler.sample's 3rd arg,
    # sampler.py:102-106,264-366 — dead in the reference, live here): when
    # set, the save cadence also renders an interpolation sweep grid
    interpolation_shift: Optional[float] = None
    block_out_channels: Optional[tuple] = None  # override UNet widths (tests/bench)
    layers_per_block: int = 2
    # recompute the down and up paths' ResnetBlocks in the backward
    # (torch.utils.checkpoint, models/unet.py): their activations are not
    # kept, at the price of a second forward of those blocks a step
    remat: bool = False
    # exact attention one block of this many query rows at a time
    # (models/unet.py, ops/tinyhead_attention.chunked_attention_plain): the
    # live scores are (B, heads, chunk, S) instead of (B, heads, S, S), for
    # placements whose full scores do not fit; None/0 = off
    attention_chunk: Optional[int] = None
    # the tiny-head attention kernel (ops/tinyhead_attention.py) for the
    # family's 8-wide heads at S >= 128; exact, the plain version elsewhere.
    # None: the kernel wherever it applies, unless attention_chunk is set;
    # True: the kernel wherever it applies; False: never (the plain or the
    # chunked version). The JAX package's MDT_TINYHEAD override has no
    # counterpart.
    tinyhead_attention: Optional[bool] = None
    # the JAX package's whole-epoch scan: True runs each epoch through
    # train/step.py:make_train_epoch (on a card the step as CUDA graphs
    # replayed once a batch), bit for bit the step-by-step loop, one process
    # only; None: MDT_EPOCH_SCAN=1/0, else off (JAX's auto rule is a TPU
    # backend, which the port never has; train/trainer.py:use_epoch_scan)
    epoch_scan: Optional[bool] = None
    profile_dir: Optional[str] = None  # jax.profiler trace output
    # checkpoint retention: keep only the N newest checkpoint-epoch-* dirs
    # (0 = keep all, the reference behavior — its cadence saves accumulate
    # unboundedly, trainer_masked_mean_shift.py:268-269)
    keep_last_checkpoints: int = 0
    # cadence checkpoint writes commit in background threads instead of
    # stalling the train loop (io/checkpoint.py:save_checkpoint async_save;
    # the reference blocks on the whole accelerator.save_state)
    async_checkpoints: bool = False

    # ------------------------------------------------------------------ helpers
    @property
    def weight_dtype(self) -> str:
        if self.mixed_precision == "bf16":
            return "bfloat16"
        if self.mixed_precision == "fp16":
            # fp16 has no TPU fast path; route to bf16 (documented divergence —
            # the reference uses AMP fp16 on CUDA, main_train_masked.py:229-238)
            return "bfloat16"
        return "float32"

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["weight_dtype"] = self.weight_dtype
        return d

    def save_option(self, dir_save: str) -> str:
        """Dump all options as option.ini (JSON), mirroring the reference's
        save_option (main_train_masked.py:338-343)."""
        filename = os.path.join(dir_save, "option.ini")
        with open(filename, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)
        return filename


def validate_sampling_modes(cfg) -> None:
    """Reject selection x dependency couplings that the reference leaves as
    silent crashes or garbage.

    * dependent_t masks come from one shared uniform field thresholded at two
      ratio levels (degrade_dependent_base_sampling) — the reference's
      'indexing' branch there is a bare `pass` that crashes on undefined
      masks_t (scheduler.py:491-492). Feeding integer pixel COUNTS into the
      `u > amount` threshold instead would yield all-zero masks and mean-fill
      every step without an error, so the combination is rejected up front.
    * interpolation sampling ratio-thresholds its shared mask the same way
      (degrade_interpolation_sampling / scheduler.py:552-569) and has no
      indexing branch at all.

    Called from Trainer.__init__, make_sample_fn, and
    make_interpolation_sample_fn so invalid runs fail at build time, not at
    the first save cadence hours into training.
    """
    if cfg.select_degrade_pixel != "indexing":
        return
    if cfg.sampling_mask_dependency == "dependent_t":
        raise ValueError(
            "sampling_mask_dependency='dependent_t' requires "
            "select_degrade_pixel='thresholding': dependent_t thresholds one "
            "shared uniform field at two ratio levels; the reference's "
            "'indexing' branch is an unimplemented `pass` that crashes "
            "(scheduler.py:491-492). Use 'thresholding', or an independent/"
            "dependent_prev mask dependency."
        )
    if getattr(cfg, "interpolation_shift", None) is not None:
        raise ValueError(
            "interpolation sampling requires select_degrade_pixel="
            "'thresholding': its shared batch mask is a uniform-vs-ratio "
            "threshold (scheduler.py:552-569) with no indexing variant."
        )


def parse_mean_option(mean_option: Any):
    """Resolve the polymorphic --mean_option flag.

    Returns ('const', value) for numeric options (including the string "0"),
    or ('degraded_area'|'non_degraded_area', None). Mirrors the reference's
    try/float(...)/except dispatch (scheduler.py:298-317).
    """
    try:
        return "const", float(mean_option)
    except (TypeError, ValueError):
        pass
    if mean_option in ("degraded_area", "non_degraded_area"):
        return mean_option, None
    raise ValueError(f"unsupported mean_option: {mean_option!r}")
