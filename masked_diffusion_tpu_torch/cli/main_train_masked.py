"""CLI entry point of the port — the JAX package's flags plus --device.

    python -m masked_diffusion_tpu_torch.cli.main_train_masked --method mean_shift \
        --data_name synthetic --data_size 64 --mixed_precision bf16 ...
    python -m masked_diffusion_tpu_torch.cli.main_train_masked --method sample \
        --test_model_path <checkpoint-epoch-N> --data_name synthetic ...
    python -m masked_diffusion_tpu_torch.cli.main_train_masked --method test \
        --test_model_path <checkpoint-epoch-N> --data_name synthetic ...

str2bool, build_parser and config_from_args are copies of
masked_diffusion_tpu/cli/main_train_masked.py:23-208 (the port imports
nothing of the JAX package; tests/test_torch_port_host.py holds them equal).
The method dispatch mirrors that file's main (:232-350) without a mesh:

  base | mean_shift  train (train/trainer.py) and write checkpoints
                     (io/checkpoint.py: checkpoint-epoch-N/{unet,unet_ema,
                     optimizer}/, meta.json, history.npz), and on the save
                     cadence the loss curve, the train visuals and the EMA
                     sample (--sampling base, the default, with its
                     trajectory grids and means); prints a `train_stats
                     {json}` line. --resume_from_checkpoint latest|<path>
                     continues a run from its newest complete checkpoint in
                     --output_dir, or else in the run's own checkpoint
                     directory (the same --date/--time/--title name it):
                     --num_epochs is the total, so it trains the epochs left.
                     SIGTERM saves a resumable checkpoint and exits 0;
                     --keep_last_checkpoints N and --async_checkpoints true
                     bound and background the cadence's saves
  sample             load --test_model_path in the export layout (written by
                     the port's trainer or by masked_diffusion_tpu.io.
                     export_torch), or with --resume_from_checkpoint latest
                     the newest checkpoint of --output_dir, and generate
                     --sample_num images in any sampling mode
                     (--sampling_mask_dependency, --momentum_adaptive,
                     --degrade_channel, --mean_option, --mean_area,
                     --encoder_reuse); prints `sample_stats`
  test               the diversity tester (tester.py): load --test_model_path
                     as `sample` does, sample with its EMA weights whenever
                     it has them, rounds of --sample_num images deduplicated
                     by cosine similarity until --data_subset_num unique
                     images (at most 1000 rounds), each matched to its
                     nearest training image; writes under the run's test/
                     tree (sample_page_N.png, final_sample.png,
                     number_of_sample.png, neighbor_N.png) and prints
                     `test_stats`

--model picks the default factory (--num_attention) or a zoo name
(unet1..unet6, models/zoo.py). Attention takes the tiny-head kernel wherever
it applies unless --tinyhead_attention false or --attention_chunk N asks for
the plain or the chunked version (models/unet.py); --remat recomputes the
down and up paths' ResnetBlocks in the backward. None of the three changes
a parameter, so a checkpoint trained with them serves without them.

Data (data/datasets.py): mnist and cifar10 files, image folders, LSUN LMDB
archives (--data_name lsun --data_set church|bedroom|tower reads
<dir_dataset>/lsun/<class>_lmdb/data.mdb), scikit-learn's digits, synthetic
blobs, and a --dir_dataset containing 'hugging' through the Hugging Face
adapter (where `datasets` is installed). MDT_NATIVE_PREPROCESS=1 resizes
with the port's C++ library (native/) instead of PIL. A `dataset_stats
{json}` line names the shape, the preprocessing backend (native, pil or
numpy) and the load seconds. --profile_dir traces one epoch of training
(utils/profiling.py), one trace_rank<r>.json a rank. A reference-trained
checkpoint (diffusers folders, safetensors or .bin, legacy attention names)
is served as it is by --test_model_path, and converted into the port's
layout by

    python -m masked_diffusion_tpu_torch.io.import_torch <src> <out_dir>

--device cuda (the default) without CUDA raises; nothing carries on on the
CPU unless --device cpu asks for it. --interpolation_shift renders the
interpolation sweep on the training cadence (train/trainer.py). Any other
--method is "unknown --method".

Data-parallel, one process per rank (parallel/mesh.py):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m masked_diffusion_tpu_torch.cli.main_train_masked --mesh_data N ...

With WORLD_SIZE > 1 the process group is set up before anything touches the
card (--device cuda becomes cuda:LOCAL_RANK, one card per rank, NCCL, and
more ranks than cards raise; --device cuda:N puts every rank on card N,
gloo; --device cpu is gloo), rank 0 builds the kernel library before the
others load it, --batch_size is the global batch, and only rank 0 writes
files and prints the stats lines. --mesh_data must equal WORLD_SIZE (-1:
whatever it is). --multihost True is the same setup across nodes
(torchrun --nnodes), and raises without torchrun's WORLD_SIZE.

Tensor and spatial parallelism, a data x model grid of D x M ranks
(parallel/tp.py, parallel/sp.py):

    python -m torch.distributed.run --standalone --nproc_per_node 4 \
        -m masked_diffusion_tpu_torch.cli.main_train_masked \
        --mesh_data 2 --mesh_model 2 [--mesh_spatial true] ...

--mesh_model M channel-shards every parameter at least --tp_min_features
wide (with its AdamW moments and EMA) over the M ranks of a model group;
with --mesh_spatial true the state stays replicated and each UNet
activation is split along image height over them. --mesh_data D x
--mesh_model M must equal WORLD_SIZE (D = -1: WORLD_SIZE / M), and a bad
topology (--mesh_model 2 in one process, --mesh_spatial with --mesh_model
1, a height M does not divide) raises before any file is written. The
backend rule is data parallelism's; rank 0 prints an `sp:` line of the
levels it splits. Training, --method sample and --method test all run on
the grid; checkpoints keep the one-process layout.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.config import Config


def str2bool(v) -> bool:
    # the reference uses type=eval for booleans (main_train_masked.py:351)
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # ---- dirutils inputs (main_train_masked.py:347-367)
    p.add_argument("--use_wandb", type=str2bool, default=True)
    p.add_argument("--use_mlflow", type=str2bool, default=True)
    p.add_argument("--task", type=str, choices=["train", "sample", "dataset"], default="train")
    p.add_argument("--content", type=str, default="test_code")
    p.add_argument("--dir_work", type=str, default="./")
    p.add_argument("--dir_dataset", type=str, default="/nas2/dataset",
                   help="dataset root; a path containing 'hugging' loads --data_name "
                   "(mnist, metfaces) through the Hugging Face adapter")
    p.add_argument("--data_name", type=str, default="mnist",
                   help="mnist | cifar10 | lsun (LMDB archives under <dir_dataset>/lsun/"
                   "<class>_lmdb) | digits | synthetic | an image-folder name")
    p.add_argument("--data_set", type=str, default="train",
                   help="the split; for lsun: church | bedroom | tower | <class>_train")
    p.add_argument("--data_size", type=int, default=64)
    p.add_argument("--data_subset", type=str2bool, default=False)
    p.add_argument("--data_subset_num", type=int, default=1000)
    # single-class filter for mnist/cifar10 (utils/datasetutils.py:223-243)
    p.add_argument("--data_subset_label", type=int, default=None)
    p.add_argument("--date", type=str, default="")
    p.add_argument("--time", type=str, default="")
    p.add_argument("--wandb_name", type=str, default="diffusion")
    p.add_argument("--method", type=str, default="base",
                   help="base | mean_shift (train), sample (generate from "
                   "--test_model_path), test (the diversity tester on "
                   "--test_model_path)")
    p.add_argument("--test_method", type=str, default="base")
    p.add_argument("--title", type=str, default="")
    # ---- model / optim (:369-381)
    p.add_argument("--model", type=str, default="default")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--in_channel", type=int, default=3)
    p.add_argument("--out_channel", type=int, default=3)
    p.add_argument("--num_attention", type=int, default=1)
    p.add_argument("--num_epochs", type=int, default=1000)
    p.add_argument("--optim", type=str, choices=["adam", "adamw", "sgd"], default="adamw")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_scheduler", type=str, default="linear")
    p.add_argument("--lr_warmup_steps", type=int, default=500)
    p.add_argument("--lr_cycle", type=float, default=0.5)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--mixed_precision", type=str, default="no", choices=["no", "fp16", "bf16"])
    # ---- ema / process (:383-401)
    p.add_argument("--use_ema", type=str2bool, default=True)
    p.add_argument("--ema_inv_gamma", type=float, default=1.0)
    p.add_argument("--ema_power", type=float, default=3 / 4)
    p.add_argument("--ema_max_decay", type=float, default=0.9999)
    p.add_argument("--loss_weight_use", type=str2bool, default=False)
    p.add_argument("--loss_weight_power_base", type=float, default=10.0)
    p.add_argument("--loss_space", type=str, default="x_0")
    p.add_argument("--ddpm_num_steps", type=int, default=1000)
    p.add_argument("--updated_ddpm_num_steps", type=int, default=1000)
    p.add_argument("--ddpm_schedule", type=str, default="linear")
    p.add_argument("--ddpm_schedule_base", type=float, default=10.0)
    p.add_argument("--scheduler_num_scale_timesteps", type=int, default=1)
    p.add_argument("--select_degrade_pixel", default="indexing")
    p.add_argument("--degrade_channel", type=str, default="1-channel")
    p.add_argument("--mean_option", default=0)
    p.add_argument("--mean_area", default="image-wise", choices=["channel-wise", "image-wise"])
    p.add_argument("--mean_value_accumulate", type=str2bool, default=False)
    p.add_argument(
        "--shift_type", type=str, default="noise_with_perturbation",
        choices=[
            "1-d_constant", "3-d_constant", "noise_reduction",
            "noise_std_reduction", "noise_with_perturbation", "non_shift",
        ],
    )
    p.add_argument("--noise_mean", type=float, default=0)
    # ---- sampling (:403-415)
    p.add_argument(
        "--sample_latent_shape", type=str, default="data",
        choices=["data", "zero", "normal", "uniform", "grid"],
    )
    p.add_argument("--sampling", type=str, default="base")
    p.add_argument(
        "--momentum_adaptive", type=str, default="base_momentum",
        choices=["base_momentum", "base_sampling", "momentum", "boosting"],
    )
    p.add_argument("--adaptive_decay_rate", type=float, default=0.999)
    p.add_argument("--adaptive_momentum_rate", type=float, default=0.9)
    p.add_argument(
        "--sampling_mask_dependency", type=str, default="independent",
        choices=["dependent_prev", "independent", "dependent_t"],
    )
    p.add_argument("--sample_num", type=int, default=100)
    p.add_argument("--sample_epoch_ratio", type=float, default=0.2)
    p.add_argument("--resume_from_checkpoint", default="False")
    p.add_argument("--num_workers", type=int, default=32)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--save_images_epochs", type=int, default=10)
    p.add_argument("--output_dir", type=str, default=None)
    # ---- test (:417)
    p.add_argument("--test_model_path", type=str, default=None)
    # ---- TPU-native extensions
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument(
        "--tp_min_features", type=int, default=256,
        help="narrowest output-feature width that channel-shards over the "
        "model group's ranks when --mesh_model > 1 (parallel/tp.py)",
    )
    p.add_argument(
        "--mesh_spatial", type=str2bool, default=False,
        help="split UNet activations along image height over the model "
        "group's ranks (parallel/sp.py spatial partitioning, for images too "
        "large for one card's memory) instead of channel-sharding params; "
        "needs --mesh_model > 1",
    )
    p.add_argument("--multihost", type=str2bool, default=False)
    p.add_argument("--capture_trajectory", type=str2bool, default=False)
    p.add_argument(
        "--interpolation_shift", type=float, default=None,
        help="enable interpolation sampling on the save cadence "
        "(Sampler.sample's third argument, sampler.py:102-106,264-366)",
    )
    p.add_argument(
        "--block_out_channels", type=str, default=None,
        help="comma-separated UNet level widths, e.g. 64,64,128 (default: "
        "the reference's 128,128,256,256,512,512)",
    )
    p.add_argument("--layers_per_block", type=int, default=2)
    p.add_argument(
        "--remat", type=str2bool, default=False,
        help="recompute the down and up paths' ResnetBlocks in the backward "
        "(torch.utils.checkpoint) instead of keeping their activations: less "
        "device memory a train step, a second forward of those blocks",
    )
    p.add_argument(
        "--attention_chunk", type=int, default=None,
        help="exact attention one block of this many query rows at a time: "
        "the live scores are (B, heads, chunk, S), not (B, heads, S, S), for "
        "placements whose full scores do not fit (0/unset = off)",
    )
    p.add_argument(
        "--tinyhead_attention", type=str2bool, default=None,
        help="the tiny-head attention kernel for the family's 8-wide heads "
        "(ops/tinyhead_attention.py, csrc/tinyhead_attention.cu): exact, the "
        "scores never written to device memory; the plain version at S < 128. "
        "unset: the kernel wherever it applies unless --attention_chunk is "
        "given; true: wherever it applies; false: never",
    )
    p.add_argument(
        "--epoch_scan", type=str2bool, default=None,
        help="the JAX package's whole-epoch scan; the port trains step by "
        "step and refuses true (its CUDA counterpart would be a graphed "
        "step); unset or false = step by step",
    )
    p.add_argument(
        "--encoder_reuse", type=int, default=0,
        help="sampling-only: run the UNet encoder every K-th reverse step "
        "and replay its cached activations through the up path between "
        "(Faster Diffusion, arXiv:2312.09608); an approximation that can "
        "destroy sample fidelity on long schedules; 0/1 = exact sampling "
        "(default)",
    )
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace one epoch (the second, or the only one) into "
                   "<dir>/trace_rank<r>.json, one file a rank")
    p.add_argument(
        "--keep_last_checkpoints", type=int, default=0,
        help="keep only the N newest checkpoint-epoch-* dirs (0 = keep all, "
        "the reference behavior)",
    )
    p.add_argument(
        "--async_checkpoints", type=str2bool, default=False,
        help="commit cadence checkpoint writes in background threads instead "
        "of stalling the train loop (orbax async save; preemption and "
        "post-mortem saves stay synchronous)",
    )
    return p


def config_from_args(args) -> Config:
    fields = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in vars(args).items() if k in fields}
    if kw.get("block_out_channels"):
        kw["block_out_channels"] = tuple(
            int(c) for c in str(kw["block_out_channels"]).split(",")
        )
    return Config(**kw)


def _parse_args(argv=None):
    p = build_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda (each rank its own card), cuda:N "
                        "(every rank on card N) or cpu")
    return p.parse_args(argv)


def parse(argv=None):
    """Flags -> (Config, torch.device of --device)."""
    args = _parse_args(argv)
    return config_from_args(args), torch.device(args.device)


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _mesh(plan) -> dict:
    return {"data": plan.data_size, "model": plan.model_size, "spatial": plan.spatial}


def _resume_path(cfg: Config, dirs) -> Optional[str]:
    """The checkpoint --resume_from_checkpoint names: in --output_dir, or
    else in the run's checkpoint directory. None for 'latest' when there is
    none (a fresh run); a named checkpoint that does not exist raises."""
    from masked_diffusion_tpu_torch.io.checkpoint import find_resume_checkpoint

    wanted = cfg.resume_from_checkpoint
    path = find_resume_checkpoint(cfg.output_dir or dirs.list_dir.get("checkpoint", ""), wanted)
    if path is None and wanted not in ("latest", "True", True):
        raise FileNotFoundError(f"Checkpoint '{wanted}' does not exist.")
    return path


def _train(cfg: Config, plan, dirs, dataset, dataset_hist, visualizer) -> None:
    from masked_diffusion_tpu_torch.train.trainer import Trainer
    from masked_diffusion_tpu_torch.utils import host

    device = plan.device
    trainer = Trainer(cfg, dataset, dataset_hist, visualizer=visualizer, device=device,
                      plan=plan)
    global_step = first_epoch = resume_step = 0
    if str(cfg.resume_from_checkpoint) != "False":
        path = _resume_path(cfg, dirs)
        if path is not None:
            global_step = trainer.restore(path)
            steps_per_epoch = max(1, dataset.num_batches(cfg.batch_size))
            first_epoch, resume_step = divmod(global_step, steps_per_epoch)
            if host.is_main_process():
                print(f"Resuming from checkpoint {path} (epoch {first_epoch})", flush=True)
        elif host.is_main_process():
            print(f"Checkpoint '{cfg.resume_from_checkpoint}' does not exist. "
                  "Starting a new training run.", flush=True)
    if host.is_main_process():
        print(
            f"***** Running {cfg.method} *****\n"
            f"  Num examples = {len(dataset)}\n"
            f"  Num epochs = {cfg.num_epochs}\n"
            f"  Batch size per step = {cfg.batch_size} (x{plan.data_size} data-parallel "
            f"ranks, x{plan.model_size} model ranks{' spatial' if plan.spatial else ''})\n"
            f"  Gradient accumulation = {cfg.gradient_accumulation_steps}\n"
            f"  Device = {_device_name(device)}",
            flush=True,
        )
    # --num_epochs is the total (main_train_masked.py:285-335): a resumed run
    # trains the epochs left
    result = trainer.train(first_epoch, max(0, cfg.num_epochs - first_epoch), resume_step,
                           global_step, dirs, visualizer)
    if not host.is_main_process():
        return
    print("train_stats " + json.dumps({
        "epochs": len(result["loss_mean_epoch"]),
        "loss_mean_epoch": result["loss_mean_epoch"],
        "global_step": trainer.global_step,
        "ms_per_step": result["ms_per_step"],
        "images_per_sec": result["images_per_sec"],
        "device": _device_name(device),
        "ranks": plan.world_size,
        "mesh": _mesh(plan),
        "checkpoints": result["checkpoints"],
        "preempted": result["preempted"],
    }), flush=True)


def _sample(cfg: Config, plan, dirs, dataset_hist) -> None:
    from masked_diffusion_tpu_torch.io.weights import load_checkpoint
    from masked_diffusion_tpu_torch.models.factory import build_model_from_config
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.generate import generate_images
    from masked_diffusion_tpu_torch.utils import host

    path = cfg.test_model_path
    if not path and str(cfg.resume_from_checkpoint) != "False":
        path = _resume_path(cfg, dirs)
    if not path:
        raise SystemExit("--method sample needs --test_model_path (a checkpoint-epoch-N "
                         "folder written by the port's trainer or by "
                         "masked_diffusion_tpu.io.export_torch), or --resume_from_checkpoint "
                         "latest with --output_dir")
    unet_sd, ema_sd, _ = load_checkpoint(path)
    model = build_model_from_config(cfg)
    use_ema = cfg.use_ema and ema_sd is not None
    model.load_state_dict(ema_sd if use_ema else unet_sd, strict=True)

    schedule = build_schedule(
        cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
        cfg.select_degrade_pixel, cfg.ddpm_schedule_base,
    )
    cfg.updated_ddpm_num_steps = schedule.num_steps
    out_dir = dirs.list_dir.get("sample") or dirs.list_dir["test_sample_img"]
    stats = generate_images(cfg, model, schedule, dataset_hist, device=plan.device,
                            out_dir=out_dir, plan=plan)
    if not host.is_main_process():
        return
    name = _device_name(plan.device)
    print(
        f"sampled {len(stats['images'])} images in {stats['batches']} batch(es) "
        f"of {stats['steps']} steps -> {out_dir} ({stats['images_per_sec']:.2f} "
        f"imgs/s, {stats['ms_per_step']:.3f} ms/step on {name})",
        flush=True,
    )
    print("sample_stats " + json.dumps({
        "images": len(stats["images"]), "batches": stats["batches"],
        "steps": stats["steps"], "images_per_sec": stats["images_per_sec"],
        "ms_per_step": stats["ms_per_step"], "device": name, "ranks": plan.world_size,
        "mesh": _mesh(plan),
        "ema": use_ema, "out_dir": out_dir,
        "finite": bool(np.isfinite(stats["images"]).all()),
    }), flush=True)


def _test(cfg: Config, plan, dirs, dataset, dataset_hist) -> None:
    """--method test (main_train_masked.py:328-350): the tester on the
    checkpoint's weights, its EMA whenever it has one (tester.py:121)."""
    from masked_diffusion_tpu_torch.io.weights import load_checkpoint
    from masked_diffusion_tpu_torch.models.factory import build_model_from_config
    from masked_diffusion_tpu_torch.tester import Tester
    from masked_diffusion_tpu_torch.utils import host

    if not cfg.test_model_path:
        raise SystemExit("--test_model_path is required for --method test")
    unet_sd, ema_sd, _ = load_checkpoint(cfg.test_model_path)
    model = build_model_from_config(cfg)
    model.load_state_dict(unet_sd, strict=True)
    tester = Tester(cfg, dataset, model, ema_sd, dataset_hist=dataset_hist,
                    device=plan.device, plan=plan)
    result = tester.run(dirs)
    if not host.is_main_process():
        return
    rounds, timed = result["rounds"], result["timed_rounds"]
    images = timed * cfg.sample_num
    steps = timed * len(tester.timesteps_used_epoch)
    print("test_stats " + json.dumps({
        "rounds": rounds, "unique": len(result["unique_images"]),
        "target": cfg.data_subset_num, "history": result["num_unique_history"],
        "seconds_per_round": result["seconds"] / max(timed, 1),
        "ms_per_step": 1e3 * result["sample_seconds"] / max(steps, 1),
        "images_per_sec": images / max(result["sample_seconds"], 1e-9),
        "steps": len(tester.timesteps_used_epoch), "sample_num": cfg.sample_num,
        "device": _device_name(plan.device), "ranks": plan.world_size, "mesh": _mesh(plan),
        "ema": ema_sd is not None, "out_dir": dirs.list_dir["test_sample_img"],
    }), flush=True)


def main(argv=None) -> int:
    args = _parse_args(argv)
    cfg, device = config_from_args(args), torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    method = cfg.method.lower()
    if method not in ("base", "mean_shift", "sample", "test"):
        raise SystemExit(f"unknown --method {cfg.method!r}")

    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.data.histogram import compute_mean_histogram, empty_histogram
    from masked_diffusion_tpu_torch.ops import build
    from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from masked_diffusion_tpu_torch.parallel.sp import validate_spatial
    from masked_diffusion_tpu_torch.utils import host
    from masked_diffusion_tpu_torch.utils.dirs import Dir
    from masked_diffusion_tpu_torch.utils.visualizer import Visualizer

    # WORLD_SIZE > 1: before the card is touched
    device = init_distributed(device, multihost=args.multihost)
    plan = make_mesh(cfg.mesh_data, cfg.mesh_model, device, spatial=cfg.mesh_spatial)
    if cfg.mesh_spatial:
        validate_spatial(plan, cfg.data_size)
    main_process = host.is_main_process()
    if plan.world_size > 1:
        if plan.device.type == "cuda":
            # rank 0 builds the kernel library; the others load what it built
            if main_process:
                build.load_library()
            host.barrier()
        if not (cfg.date and cfg.time):
            cfg.date, cfg.time = host.synced_timestamp()
    dirs = Dir(
        task=cfg.task, content=cfg.content, dir_work=cfg.dir_work,
        dir_dataset=cfg.dir_dataset, data_name=cfg.data_name, data_set=cfg.data_set,
        data_size=cfg.data_size, date=cfg.date, time=cfg.time,
        method=cfg.method, title=cfg.title, make_dirs=main_process,
    )
    np.random.seed(cfg.seed)  # host-side seeding (main_train_masked.py:441-445)
    torch.manual_seed(cfg.seed)
    # the sample-task tree (utils/dirs.py:100-113) has no option/log dirs
    if main_process and "option" in dirs.list_dir:
        cfg.save_option(dirs.list_dir["option"])

    # the dataset is needed to train, or for the 'data' latent's histogram
    dataset = None
    if method != "sample" or cfg.sample_latent_shape.lower() == "data":
        t0 = time.perf_counter()
        dataset = get_dataset(
            cfg.dir_dataset, cfg.data_name, cfg.data_size, cfg.data_set,
            cfg.data_subset, cfg.data_subset_num, seed=cfg.seed,
            label_filter=cfg.data_subset_label if cfg.data_subset else None,
        )
        if main_process:
            print("dataset_stats " + json.dumps({
                "name": cfg.data_name, "shape": list(dataset.data.shape),
                "backend": dataset.backend, "load_s": time.perf_counter() - t0}), flush=True)
    if cfg.sample_latent_shape.lower() == "data":
        dataset_hist = compute_mean_histogram(dataset.data, cfg.sample_num, cfg.mean_area)
    else:
        dataset_hist = empty_histogram()

    if method == "sample":
        _sample(cfg, plan, dirs, dataset_hist)
        return 0
    if method == "test":
        _test(cfg, plan, dirs, dataset, dataset_hist)
        return 0
    # always-on JSONL metrics sink (log/metrics.jsonl) on rank 0; wandb only if enabled
    visualizer = (Visualizer(cfg, dirs.list_dir["log"])
                  if main_process and "log" in dirs.list_dir else None)
    try:
        _train(cfg, plan, dirs, dataset, dataset_hist, visualizer)
    finally:
        if visualizer is not None:
            visualizer.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
