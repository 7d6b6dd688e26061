"""CLI entry point of the port — the JAX package's flags plus --device.

    python -m masked_diffusion_tpu_torch.cli.main_train_masked --method sample \
        --test_model_path <checkpoint-epoch-N> --data_name synthetic ...

The parser is masked_diffusion_tpu/cli/main_train_masked.py:build_parser
(jax-free). Only `--method sample` is ported: it loads --test_model_path in
the layout masked_diffusion_tpu.io.export_torch writes (unet/, unet_ema/)
and generates --sample_num images. --device cuda (the default) without CUDA
raises; nothing carries on on the CPU unless --device cpu asks for it.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from masked_diffusion_tpu.cli.main_train_masked import build_parser, config_from_args


def parse(argv=None):
    """Flags -> (the JAX package's Config, torch.device of --device)."""
    p = build_parser()
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to sample on (cuda, cuda:N or cpu)")
    args = p.parse_args(argv)
    return config_from_args(args), torch.device(args.device)


def main(argv=None) -> int:
    cfg, device = parse(argv)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")
    if cfg.method.lower() != "sample":
        raise SystemExit(f"--method {cfg.method}: not yet ported (only --method sample)")
    if not cfg.test_model_path:
        raise SystemExit("--method sample needs --test_model_path "
                         "(a checkpoint written by masked_diffusion_tpu.io.export_torch)")

    from masked_diffusion_tpu.data.datasets import get_dataset
    from masked_diffusion_tpu.data.histogram import compute_mean_histogram, empty_histogram
    from masked_diffusion_tpu.utils.dirs import Dir
    from masked_diffusion_tpu_torch.io.weights import load_checkpoint
    from masked_diffusion_tpu_torch.models.factory import build_model_from_config
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.generate import generate_images

    dirs = Dir(
        task=cfg.task, content=cfg.content, dir_work=cfg.dir_work,
        dir_dataset=cfg.dir_dataset, data_name=cfg.data_name, data_set=cfg.data_set,
        data_size=cfg.data_size, date=cfg.date, time=cfg.time,
        method=cfg.method, title=cfg.title,
    )
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    if "option" in dirs.list_dir:
        cfg.save_option(dirs.list_dir["option"])

    if cfg.sample_latent_shape.lower() == "data":
        dataset = get_dataset(
            cfg.dir_dataset, cfg.data_name, cfg.data_size, cfg.data_set,
            cfg.data_subset, cfg.data_subset_num, seed=cfg.seed,
            label_filter=cfg.data_subset_label if cfg.data_subset else None,
        )
        dataset_hist = compute_mean_histogram(dataset.data, cfg.sample_num, cfg.mean_area)
    else:
        dataset_hist = empty_histogram()

    unet_sd, ema_sd, _ = load_checkpoint(cfg.test_model_path)
    model = build_model_from_config(cfg)
    use_ema = cfg.use_ema and ema_sd is not None
    model.load_state_dict(ema_sd if use_ema else unet_sd, strict=True)

    schedule = build_schedule(
        cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
        cfg.select_degrade_pixel, cfg.ddpm_schedule_base,
    )
    cfg.updated_ddpm_num_steps = schedule.num_steps
    out_dir = dirs.list_dir.get("sample") or dirs.list_dir["test_sample_img"]
    stats = generate_images(cfg, model, schedule, dataset_hist, device=device,
                            out_dir=out_dir)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(
        f"sampled {len(stats['images'])} images in {stats['batches']} batch(es) "
        f"of {stats['steps']} steps -> {out_dir} ({stats['images_per_sec']:.2f} "
        f"imgs/s, {stats['ms_per_step']:.3f} ms/step on {name})",
        flush=True,
    )
    print("sample_stats " + json.dumps({
        "images": len(stats["images"]), "batches": stats["batches"],
        "steps": stats["steps"], "images_per_sec": stats["images_per_sec"],
        "ms_per_step": stats["ms_per_step"], "device": name,
        "ema": use_ema, "out_dir": out_dir,
        "finite": bool(np.isfinite(stats["images"]).all()),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
