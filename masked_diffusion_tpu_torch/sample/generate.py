"""Standalone generation: model -> N images (the serving path).

Counterpart of masked_diffusion_tpu/sample/generate.py:generate_images,
without a mesh: one sampler reused across batches, latents from a CPU
generator per batch, images written as PNG grids and per-image files.
"""

from __future__ import annotations

import math
import os
import time
from typing import Optional

import numpy as np
import torch

from masked_diffusion_tpu_torch.utils.grids import normalize01, save_image_grid, save_png
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule
from masked_diffusion_tpu_torch.sample.latent import latent_initial
from masked_diffusion_tpu_torch.sample.loop import make_sample_fn


def generate_images(
    cfg,
    model: torch.nn.Module,
    schedule: MaskSchedule,
    dataset_hist=None,
    *,
    device="cuda",
    out_dir: Optional[str] = None,
) -> dict:
    """Sample cfg.sample_num images in batches of at most cfg.batch_size
    on `device`, seeded by cfg.seed.

    Returns {"images": (N, H, W, C) float32 numpy array in model space,
    "images_per_sec", "ms_per_step", "batches", "steps"}. Throughput is
    steady-state: with more than one batch the first (which pays warm-up)
    is left out.
    """
    num = int(cfg.sample_num)
    batch = min(num, int(cfg.batch_size))
    # the Tester's fixed curriculum slice (masked_diffusion_tpu/tester.py:62)
    used = schedule.timesteps_for_epoch(1, 10, cfg.scheduler_num_scale_timesteps)
    sample_fn = make_sample_fn(model, schedule, cfg, used, device=device)

    n_batches = int(math.ceil(num / batch))
    chunks = []
    t_first = None
    t0 = time.perf_counter()
    for i in range(n_batches):
        gen = torch.Generator().manual_seed(int(cfg.seed) * 1_000_003 + i)
        latent = latent_initial(
            gen, batch, cfg.out_channel, cfg.data_size, cfg.sample_latent_shape,
            cfg.mean_area, dataset_hist, device=device,
        )
        chunks.append(sample_fn(latent, gen).cpu().numpy())  # the copy syncs
        if t_first is None:
            t_first = time.perf_counter() - t0
    elapsed = time.perf_counter() - t0
    images = np.concatenate(chunks, axis=0)[:num]

    if n_batches > 1:
        timed_batches, seconds = n_batches - 1, elapsed - t_first
        ips = (num - min(batch, num)) / max(seconds, 1e-9)
    else:
        timed_batches, seconds = 1, elapsed
        ips = num / max(seconds, 1e-9)
    ms_per_step = 1e3 * seconds / (timed_batches * len(used))

    if out_dir is not None:
        for b, chunk in enumerate(chunks):
            real = chunk[: max(0, num - b * batch)]
            if len(real):
                save_image_grid(real, "image", out_dir, f"sample_grid_{b:04d}.png")
        norm = normalize01(images)
        for idx in range(len(norm)):
            save_png(norm[idx], os.path.join(out_dir, f"sample_{idx:05d}.png"))

    return {"images": images, "images_per_sec": ips, "ms_per_step": ms_per_step,
            "batches": n_batches, "steps": len(used)}
