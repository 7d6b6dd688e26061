"""Legacy GAN/EBM trainer serving cli/main_train.py.

The reference's legacy entry point (code/main_train.py:28) imports a
`trainer` module that does not exist in the repo — the path is dead as
checked in (SURVEY.md §0/§3.5). Its argparse surface (Langevin length/lr/
noise-lr, weight_reg, G/D optimizers with min/max LR) indicates an
EBM-flavored GAN; the JAX package's train/gan_trainer.py gives it a working
implementation, and this is its counterpart:

  * non-saturating GAN losses on logits (BCE-with-logits),
  * optional Langevin refinement of latents against the discriminator energy
    (z <- z + lr/2 * grad_z D(G(z)) + noise_lr * eps, langevin_length
    steps; torch.autograd.grad where JAX takes jax.grad),
  * logit L2 regularization scaled by weight_reg (EBM energy stabilizer),
  * the discriminator step on the detached fake, then the generator step
    scored by the UPDATED discriminator, as the JAX step does,
  * cosine LR from lr_max to lr_min for both networks, as
    optax.cosine_decay_schedule evaluates it at the update count from 0,
    with optax's optimizers: adam, adamw (weight decay 1e-4, optax's
    default, not torch's 1e-2) and sgd without momentum.

The draws (z, and each Langevin step's noise) come from a torch.Generator on
the device; `step` also takes them as arguments, so that the tests inject
the JAX step's own draws. Initial weights follow Flax's defaults
(models/gan.py:init_like_flax), drawn from a CPU generator seeded with
`seed`. Images are NCHW on the device; `train` takes the JAX package's NHWC
numpy batches from dataset.epoch_batches(np.random.default_rng(seed), ...),
so both packages see the same batches.
"""

from __future__ import annotations

import math
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from masked_diffusion_tpu_torch.models.gan import Discriminator, Generator, init_like_flax
from masked_diffusion_tpu_torch.train.optim import Optimizer

GAN_IMAGE_SIZE = 32  # the Generator's output side (five x2 upsamplings of 1x1)


def _bce_logits(logits: torch.Tensor, target_ones: bool) -> torch.Tensor:
    # -log sigmoid(l) for ones, -log(1 - sigmoid(l)) for zeros
    return F.softplus(-logits if target_ones else logits).mean()


def cosine_decay(lr_max: float, lr_min: float, total_steps: int):
    """optax.cosine_decay_schedule(lr_max, max(1, total_steps),
    alpha=lr_min / lr_max): count -> LR (a host float)."""
    steps = max(1, total_steps)
    alpha = lr_min / max(lr_max, 1e-12)

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        return lr_max * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(name: str, params, schedule) -> Optimizer:
    """optax.adam / adamw / sgd on `schedule`, no clipping."""
    params = list(params)
    name = name.lower()
    if name == "sgd":
        base = torch.optim.SGD(params, lr=0.0)
    elif name == "adamw":
        base = torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    else:  # the JAX trainer's fallback: any other name is adam
        base = torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    return Optimizer(params, base, schedule, grad_clip_norm=None)


class GANTrainer:
    def __init__(
        self,
        dim_latent: int = 100,
        dim_features: int = 32,
        out_channels: int = 1,
        lr_g: float = 2e-4,
        lr_d: float = 2e-4,
        lr_g_min: float = 0.0,
        lr_d_min: float = 0.0,
        total_steps: int = 10_000,
        weight_reg: float = 0.0,
        langevin_length: int = 0,
        langevin_lr: float = 0.0,
        langevin_noise_lr: float = 0.0,
        optim_name: str = "adam",
        seed: int = 0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.dim_latent = dim_latent
        self.weight_reg = weight_reg
        self.langevin_length = int(langevin_length)
        self.langevin_lr = langevin_lr
        self.langevin_noise_lr = langevin_noise_lr

        init = torch.Generator().manual_seed(int(seed))
        self.G = init_like_flax(Generator(dim_latent, dim_features, out_channels), init)
        self.D = init_like_flax(Discriminator(out_channels, dim_features, GAN_IMAGE_SIZE), init)
        self.G.to(self.device)
        self.D.to(self.device)
        self.opt_g = make_optimizer(optim_name, self.G.parameters(),
                                    cosine_decay(lr_g, lr_g_min, total_steps))
        self.opt_d = make_optimizer(optim_name, self.D.parameters(),
                                    cosine_decay(lr_d, lr_d_min, total_steps))
        self.generator = torch.Generator(self.device).manual_seed(int(seed))

    # ------------------------------------------------------------------
    def draws(self, batch: int, generator: Optional[torch.Generator] = None):
        """(z, noise): the step's latents (batch, dim_latent) and its
        Langevin noise (langevin_length, batch, dim_latent)."""
        gen = generator if generator is not None else self.generator
        z = torch.randn(batch, self.dim_latent, generator=gen, device=self.device)
        noise = torch.randn(self.langevin_length, batch, self.dim_latent, generator=gen,
                            device=self.device)
        return z, noise

    def _refine_latent(self, z: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """Langevin refinement against the discriminator energy."""
        for i in range(self.langevin_length):
            zz = z.detach().requires_grad_(True)
            energy = self.D(self.G(zz)).sum()
            (g,) = torch.autograd.grad(energy, zz)
            z = z + 0.5 * self.langevin_lr * g + self.langevin_noise_lr * noise[i].to(z.device)
        return z.detach()

    def step(self, real: torch.Tensor, z: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One D update then one G update on `real` (NCHW). z and noise are
        drawn from the trainer's generator unless given. Afterwards each
        parameter's .grad holds its network's gradient of this step."""
        real = real.to(self.device, torch.float32)
        if z is None:
            z, noise = self.draws(real.shape[0])
        z = self._refine_latent(z.to(self.device), noise)
        with torch.no_grad():
            fake = self.G(z)

        # ---- D step, on the fake with no path to G
        self.opt_d.zero_grad()
        real_logits = self.D(real)
        fake_logits = self.D(fake)
        d_loss = _bce_logits(real_logits, True) + _bce_logits(fake_logits, False)
        if self.weight_reg > 0:
            d_loss = d_loss + self.weight_reg * (
                real_logits.pow(2).mean() + fake_logits.pow(2).mean())
        d_loss.backward()
        self.opt_d.update()

        # ---- G step (non-saturating), scored by the updated D
        self.opt_g.zero_grad()
        self.D.requires_grad_(False)
        try:
            g_loss = _bce_logits(self.D(self.G(z)), True)
            g_loss.backward()
        finally:
            self.D.requires_grad_(True)
        self.opt_g.update()
        return {"loss_d": d_loss.detach(), "loss_g": g_loss.detach()}

    # ------------------------------------------------------------------
    def train(self, dataset, batch_size: int, num_epochs: int, seed: int = 0,
              dirs=None, sample_every: int = 10) -> Dict:
        """Epochs over dataset.epoch_batches; returns the per-epoch mean
        losses under "history", and the steps and seconds of the training
        steps (the sample saves excluded)."""
        rng = np.random.default_rng(seed)
        history = []
        steps, seconds = 0, 0.0
        for epoch in range(num_epochs):
            losses = []
            t0 = time.perf_counter()
            for batch in dataset.epoch_batches(rng, batch_size):
                real = torch.from_numpy(np.asarray(batch, np.float32)).to(self.device)
                losses.append(self.step(real.permute(0, 3, 1, 2).contiguous()))
            if losses:
                stacked = {k: torch.stack([m[k] for m in losses]) for k in losses[0]}
                history.append({k: float(v.mean()) for k, v in stacked.items()})
            seconds += time.perf_counter() - t0  # the float() above waited for the device
            steps += len(losses)
            if dirs is not None and (epoch + 1) % sample_every == 0:
                self._save_samples(dirs, epoch)
        return {"history": history, "steps": steps, "seconds": seconds}

    @torch.no_grad()
    def sample(self, n: int = 64, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        gen = generator if generator is not None else self.generator
        z = torch.randn(n, self.dim_latent, generator=gen, device=self.device)
        return self.G(z)

    def _save_samples(self, dirs, epoch: int) -> None:
        from masked_diffusion_tpu_torch.utils.grids import save_image_grid

        imgs = self.sample(64).permute(0, 2, 3, 1).float().cpu().numpy()
        save_image_grid(
            imgs, "image", dirs.list_dir["sample_img"], f"gan_sample_{epoch:05d}.png"
        )
