"""Legacy GAN/EBM entry point of the port — the flag surface of the
reference's code/main_train.py:135-202 (dead as checked in: its `trainer`
module is missing from the repo, main_train.py:28), as the JAX package's
root main_train.py runs it, plus --device:

    python -m masked_diffusion_tpu_torch.cli.main_train [flags]

The Generator/Discriminator of models/gan.py (the models_Mnist.py design)
trained by train/gan_trainer.py with optional Langevin latent refinement.
--device cuda (the default) without CUDA raises; --device cpu runs on the
host. Prints `final losses: G=... D=...` as the JAX entry point does, then
one `gan_stats {json}` line: epochs, steps, ms/step, the device, and the
sample grids written (gan_sample_{epoch:05d}.png under train/image/
sample_image every --save_every epochs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def str2bool(v):
    return str(v).lower() in ("true", "1", "yes")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--task", type=str, default="train")
    p.add_argument("--content", type=str, default="gan")
    p.add_argument("--dir_work", type=str, default="./")
    p.add_argument("--dir_dataset", type=str, default="/nas2/dataset")
    p.add_argument("--data_name", type=str, default="mnist")
    p.add_argument("--data_set", type=str, default="train")
    p.add_argument("--data_size", type=int, default=32)
    p.add_argument("--data_subset_use", type=str2bool, default=False)
    p.add_argument("--data_subset_label", type=int, default=0)
    p.add_argument("--data_subset_num", type=int, default=0)
    p.add_argument("--date", type=str, default="")
    p.add_argument("--time", type=str, default="")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=0)
    p.add_argument("--dim_latent", type=int, default=100)
    p.add_argument("--dim_feature", type=int, default=32)
    p.add_argument("--optim", type=str, default="adam")
    p.add_argument("--lr_scheduler", type=str, default="cosineannealinglr")
    p.add_argument("--lr_generator_max", type=float, default=2e-4)
    p.add_argument("--lr_generator_min", type=float, default=0.0)
    p.add_argument("--lr_discriminator_max", type=float, default=2e-4)
    p.add_argument("--lr_discriminator_min", type=float, default=0.0)
    p.add_argument("--weight_reg", type=float, default=0.0)
    p.add_argument("--langevin_length", type=int, default=0)
    p.add_argument("--langevin_lr", type=float, default=0.0)
    p.add_argument("--langevin_noise_lr", type=float, default=0.0)
    p.add_argument("--epoch_length", type=int, default=100)
    p.add_argument("--epoch_resume", type=int, default=0)
    p.add_argument("--save_every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to run on: cuda, cuda:N or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available")

    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.train.gan_trainer import GANTrainer
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    dirs = Dir(
        task="train", content=args.content, dir_work=args.dir_work,
        dir_dataset=args.dir_dataset, data_name=args.data_name,
        data_set=args.data_set, data_size=args.data_size,
        date=args.date, time=args.time, method="gan",
    )
    dataset = get_dataset(
        args.dir_dataset, args.data_name, args.data_size, args.data_set,
        data_subset=args.data_subset_use, num_data=args.data_subset_num,
        seed=args.seed,
        # the legacy path trains on a single digit class when subsetting
        # (main_train.py's data_subset_label semantics)
        label_filter=args.data_subset_label if args.data_subset_use else None,
    )
    channels = dataset.shape[-1]
    steps_per_epoch = max(1, dataset.num_batches(args.batch_size))
    trainer = GANTrainer(
        dim_latent=args.dim_latent, dim_features=args.dim_feature,
        out_channels=channels,
        lr_g=args.lr_generator_max, lr_d=args.lr_discriminator_max,
        lr_g_min=args.lr_generator_min, lr_d_min=args.lr_discriminator_min,
        total_steps=steps_per_epoch * args.epoch_length,
        weight_reg=args.weight_reg, langevin_length=args.langevin_length,
        langevin_lr=args.langevin_lr, langevin_noise_lr=args.langevin_noise_lr,
        optim_name=args.optim, seed=args.seed, device=device,
    )
    result = trainer.train(
        dataset, args.batch_size, args.epoch_length, seed=args.seed,
        dirs=dirs, sample_every=args.save_every,
    )
    if result["history"]:
        last = result["history"][-1]
        print(f"final losses: G={last['loss_g']:.4f} D={last['loss_d']:.4f}")
    sample_dir = dirs.list_dir["sample_img"]
    print("gan_stats " + json.dumps({
        "epochs": args.epoch_length, "steps": result["steps"],
        "ms_per_step": 1e3 * result["seconds"] / max(1, result["steps"]),
        "loss_g": [h["loss_g"] for h in result["history"]],
        "loss_d": [h["loss_d"] for h in result["history"]],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "samples": sorted(os.path.join(sample_dir, f) for f in os.listdir(sample_dir)
                          if f.startswith("gan_sample_")),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
