"""Diversity evaluator (--method test).

Counterpart of masked_diffusion_tpu/tester.py (reference tester.py:32-280):
repeatedly sample from a checkpoint's weights (its EMA whenever it has one),
deduplicate the generated images by cosine similarity (threshold 0.9), keep
sampling until the unique count reaches data_subset_num, match each unique
sample to its nearest training image, and save grids and the unique-count
plot.

The interface stays the JAX module's: numpy NHWC images in and out. The
similarity products are plain fp32 matmuls on the tester's device
(torch.matmul, TF32 off inside the call whatever the process's flags say:
a TF32 product flips pairs near the threshold); the greedy passes, whose
"first occurrence wins" order matters, run on the host over the fetched
similarity matrix, as the JAX module's do. Downsampling for the
nearest-neighbour match is bilinear WITH antialiasing, as jax.image.resize
does when it shrinks.

Data-parallel (a parallel/mesh.MeshPlan of N ranks, under torchrun): each
round's batch is sampled on every rank's rows and gathered to every rank
(utils/host.fetch, collective), so every rank dedups the same images; the
stop test is agreed across the ranks each round (utils/host.any_flag), so
every rank leaves the loop in the same round and none waits in a gather;
only rank 0 writes files.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset
from masked_diffusion_tpu_torch.ops.schedule import MaskSchedule, build_schedule
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan, local_rows, round_up
from masked_diffusion_tpu_torch.sample.latent import latent_initial
from masked_diffusion_tpu_torch.sample.loop import make_sample_fn
from masked_diffusion_tpu_torch.utils import host
from masked_diffusion_tpu_torch.utils.grids import (
    make_grid,
    normalize01,
    save_image_grid,
    save_png,
)

COSINE_SIMILARITY_TH = 0.9  # tester.py:53


@contextlib.contextmanager
def _full_fp32():
    """fp32 matmuls without TF32 for the duration, the flag restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _flatten_normalize(x: np.ndarray) -> np.ndarray:
    v = x.reshape(x.shape[0], -1).astype(np.float32)
    n = np.linalg.norm(v, axis=1, keepdims=True)
    return v / np.maximum(n, 1e-12)


def cosine_matrix(a: np.ndarray, b: np.ndarray, device="cuda") -> np.ndarray:
    """Pairwise cosine similarities (len(a), len(b)) as numpy: one fp32
    matmul on `device` (the card unless the caller names another)."""
    va, vb = _flatten_normalize(a), _flatten_normalize(b)
    with _full_fp32():
        sim = torch.matmul(torch.from_numpy(va).to(device), torch.from_numpy(vb).to(device).T)
    return sim.cpu().numpy()


def greedy_dedup(batch: np.ndarray, threshold: float = COSINE_SIMILARITY_TH,
                 device="cuda") -> np.ndarray:
    """Keep the first of each similar group (tester.py:150-162 semantics):
    i is kept only if sim[i, j] < threshold for every kept j."""
    if len(batch) == 0:
        return batch
    sim = cosine_matrix(batch, batch, device)
    keep: List[int] = []
    for i in range(len(batch)):
        if all(sim[i, j] < threshold for j in keep):
            keep.append(i)
    return batch[keep]


def dedup_against(
    batch: np.ndarray, previous: np.ndarray, threshold: float = COSINE_SIMILARITY_TH,
    device="cuda",
) -> np.ndarray:
    """Drop batch items similar (> threshold) to any previous unique image
    (tester.py:165-186)."""
    if len(batch) == 0 or len(previous) == 0:
        return batch
    sim = cosine_matrix(batch, previous, device)
    mask = (sim > threshold).any(axis=1)
    return batch[~mask]


def _downsample_batch(x: np.ndarray, size: int, device="cuda") -> np.ndarray:
    """(N, H, W, C) -> (N, size, size, C), bilinear with antialiasing (what
    jax.image.resize's 'bilinear' does when it shrinks)."""
    t = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
    out = F.interpolate(t.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).cpu().numpy()


def get_nearest_neighbor(
    samples: np.ndarray,
    dataset: np.ndarray,
    compare_size: int = 32,
    flip_augment: bool = True,
    device="cuda",
) -> np.ndarray:
    """Nearest training image per sample by cosine similarity at a reduced
    resolution, with optional horizontal-flip augmentation of the dataset
    (Sampler.get_nearest_neighbor, sampler.py:487-518: both sides are
    compared at compare_size; the flipped copies double the candidate pool,
    and the returned images are the original-resolution training images,
    never the mirrored ones)."""
    cand = dataset
    if flip_augment:
        cand = np.concatenate([dataset, dataset[:, :, ::-1, :]], axis=0)
    sim = cosine_matrix(
        _downsample_batch(samples, compare_size, device),
        _downsample_batch(cand, compare_size, device), device,
    )
    idx = sim.argmax(axis=1)
    return dataset[idx % len(dataset)]


class Tester:
    """The diversity loop on `device` (the card unless the caller names
    another). model: the UNet with the checkpoint's weights; ema_state_dict:
    the checkpoint's EMA weights, which the tester samples with whenever
    they are given (tester.py:87-93, JAX :121), on a copy of model."""

    def __init__(
        self,
        cfg: Config,
        dataset: InMemoryDataset,
        model: torch.nn.Module,
        ema_state_dict: Optional[dict] = None,
        schedule: Optional[MaskSchedule] = None,
        dataset_hist=None,
        *,
        device="cuda",
        plan: Optional[MeshPlan] = None,
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.device = torch.device(device)
        self.plan = plan or MeshPlan(device=self.device)
        if ema_state_dict is not None:
            model = copy.deepcopy(model)
            model.load_state_dict(ema_state_dict, strict=True)
        self.model = model
        self.schedule = schedule or build_schedule(
            cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
            cfg.select_degrade_pixel, cfg.ddpm_schedule_base,
        )
        cfg.updated_ddpm_num_steps = self.schedule.num_steps
        self.dataset_hist = dataset_hist
        # fixed curriculum slice, as the reference hardcodes (tester.py:62)
        self.timesteps_used_epoch = self.schedule.timesteps_for_epoch(
            1, 10, cfg.scheduler_num_scale_timesteps
        )
        self._sample_fn = make_sample_fn(self.model, self.schedule, cfg,
                                         self.timesteps_used_epoch, device=self.device,
                                         plan=self.plan)

    def _sample_batch(self, generator: torch.Generator) -> np.ndarray:
        """cfg.sample_num images (N, H, W, C) numpy on every rank: the global
        latent batch rounded up to the ranks, this rank's rows sampled, the
        batch gathered (collective) and trimmed."""
        cfg = self.cfg
        num = cfg.sample_num
        padded = round_up(num, self.plan.data_size)
        latent = latent_initial(
            generator, padded, cfg.out_channel, cfg.data_size,
            cfg.sample_latent_shape, cfg.mean_area, self.dataset_hist, device=self.device,
        )
        out = self._sample_fn(latent[local_rows(padded, self.plan)], generator)
        return host.fetch(out)[:num]

    def run(self, dirs=None, max_rounds: int = 1000,
            generator: Optional[torch.Generator] = None) -> dict:
        """Sampling / dedup / matching loop (tester.py:57-133). Returns
        {"unique_images", "num_unique_history", "rounds", "img_set"} as the
        JAX Tester does, and the loop's times: "seconds" (every round),
        "sample_seconds" (the sampling, up to the host copy of its images)
        and "timed_rounds" (the rounds those cover: all but the first, which
        pays warm-up, when there is more than one)."""
        cfg = self.cfg
        generator = generator or torch.Generator().manual_seed(int(cfg.seed))
        target = cfg.data_subset_num
        device = self.device
        main_process = host.is_main_process()
        write = dirs is not None and main_process

        train_set = normalize01(self.dataset.data[:target])
        img_set: List[np.ndarray] = [
            np.empty((0,) + train_set.shape[1:], dtype=np.float32) for _ in range(target)
        ]

        unique_images = np.empty((0,) + train_set.shape[1:], dtype=np.float32)
        num_unique_history: List[int] = []

        rounds = 0
        round_s, sample_s = [], []
        # the stop test is agreed over the ranks (collective): all leave together
        while rounds < max_rounds and not host.any_flag(len(unique_images) >= target):
            t0 = time.perf_counter()
            round_gen = torch.Generator().manual_seed(
                int(torch.randint(0, 2**62, (1,), generator=generator)))
            batch = self._sample_batch(round_gen)
            sample_s.append(time.perf_counter() - t0)

            unique_in_batch = greedy_dedup(batch, device=device)
            fresh = dedup_against(unique_in_batch, unique_images, device=device)
            n_before = len(unique_images)
            unique_images = np.concatenate([unique_images, fresh], axis=0)
            num_unique_history.append(len(unique_images))

            changed_idx: set = set()
            if len(fresh):
                nn_idx = self.nearest_neighbor_idx(fresh, train_set)
                img_set, changed_idx = self.assign_similar_neighbor(fresh, img_set, nn_idx)

            if write:
                # only the pages and neighbour chunks this round touched are
                # rendered again
                self._save_progress(dirs, unique_images, num_unique_history, rounds,
                                    start=n_before)
                self.save_neighbor(img_set, train_set, dirs.list_dir["test_sample_neighbor"],
                                   changed=changed_idx)
            rounds += 1
            round_s.append(time.perf_counter() - t0)

        if write and len(unique_images):
            save_image_grid(unique_images, "image", dirs.list_dir["test_sample_img"],
                            "final_sample.png")
        first = 1 if rounds > 1 else 0
        return {
            "unique_images": unique_images,
            "num_unique_history": num_unique_history,
            "rounds": rounds,
            "img_set": img_set,
            "seconds": sum(round_s[first:]),
            "sample_seconds": sum(sample_s[first:]),
            "timed_rounds": rounds - first,
        }

    # ------------------------------------------------------------------ matching
    def nearest_neighbor_idx(self, source: np.ndarray, train_set: np.ndarray) -> np.ndarray:
        """argmax cosine similarity vs the training set (tester.py:189-206)."""
        sim = cosine_matrix(train_set, source, self.device)  # (train, source)
        return sim.argmax(axis=0)

    def assign_similar_neighbor(
        self, generated: np.ndarray, img_set: List[np.ndarray], idx: np.ndarray
    ):
        """Attach each sample to its nearest train image unless a
        too-similar sample is already attached (tester.py:209-223), in
        order: a sample attached earlier in the round counts for the later
        ones. Returns (img_set, set of train indices whose bucket
        changed)."""
        changed: set = set()
        for i in range(len(generated)):
            bucket = img_set[int(idx[i])]
            if len(bucket):
                sim = cosine_matrix(generated[i : i + 1], bucket, self.device)
                if (sim > COSINE_SIMILARITY_TH).any():
                    continue
            img_set[int(idx[i])] = np.concatenate([bucket, generated[i : i + 1]], axis=0)
            changed.add(int(idx[i]))
        return img_set, changed

    # ------------------------------------------------------------------ artifacts
    def _save_progress(self, dirs, unique_images, history, round_idx, start=0) -> None:
        """Render the 100-image pages touched since `start` (unique_images is
        append-only; a page is rewritten only while it is still filling),
        and the unique-count plot where matplotlib is installed."""
        d_img = dirs.list_dir["test_sample_img"]
        first_page = start // 100
        last_page = max(first_page, (len(unique_images) - 1) // 100 if len(unique_images) else 0)
        for i in range(first_page, last_page + 1):
            part = unique_images[i * 100 : (i + 1) * 100]
            if len(part) == 0:
                continue
            save_image_grid(part, "image", d_img, f"sample_page_{i}.png")
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return
        plt.figure()
        plt.plot(history)
        plt.savefig(os.path.join(dirs.list_dir["test_sample_num"], "number_of_sample.png"))
        plt.close()

    def save_neighbor(
        self, img_set, train_set, out_dir, chunk_length: int = 10, changed=None
    ) -> None:
        """Per-train-image rows: [train image | its matched samples]
        (tester.py:226-280), rendered as padded grids. With `changed` (train
        indices whose bucket gained a sample this round) only the chunks
        containing them are rendered again."""
        n = len(train_set)
        chunks = math.ceil(n / chunk_length)
        if changed is not None:
            chunk_ids = sorted({i // chunk_length for i in changed})
        else:
            chunk_ids = range(chunks)
        for idx in chunk_ids:
            rows = []
            max_cols = 1
            for i in range(idx * chunk_length, min((idx + 1) * chunk_length, n)):
                row = [train_set[i][None]]
                if len(img_set[i]):
                    row.append(normalize01(img_set[i]))
                row = np.concatenate(row, axis=0)
                max_cols = max(max_cols, len(row))
                rows.append(row)
            if not rows:
                continue
            h, w, c = rows[0].shape[1:]
            canvas = np.zeros((len(rows), max_cols, h, w, c), dtype=np.float32)
            for r, row in enumerate(rows):
                canvas[r, : len(row)] = row
            grid = make_grid(canvas.reshape(-1, h, w, c), nrow=max_cols)
            save_png(grid, os.path.join(out_dir, f"neighbor_{idx}.png"))
