"""Legacy GAN models (reference models/models_Mnist.py:6-100).

Generator: latent -> linear -> 1x1 feature map -> 5x (bilinear upsample +
3x3 conv + LeakyReLU) -> sigmoid, producing 32x32 images.
Discriminator: 5x stride-2 3x3 conv + LeakyReLU -> 2 linears -> logit.
(The reference's BatchNorm layers are commented out; kept out here too.)

NCHW counterpart of masked_diffusion_tpu/models/gan.py. Its submodules carry
the Flax module names, so io/legacy_weights.py maps a JAX parameter tree
onto them name for name. nn.Linear needs its input width where Flax's Dense
infers it: the Discriminator computes it from `image_size`, the size of the
images it scores (32, the Generator's output, in the trainer).

init_like_flax gives a legacy model the JAX package's initial distribution
(Flax's defaults: truncated-normal lecun kernels, zero biases, unit norm
scales, zero residual gammas), from an explicit torch.Generator.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's "truncated_normal")
_TRUNC_STD = 0.87962566103423978


def init_like_flax(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise every conv, transposed conv, linear and GroupNorm of
    `module` as Flax initialises them (lecun_normal kernels, fan-in over
    the kernel's input channels and window; zero biases; unit scales), and
    every scalar `gamma` to 0. In place; returns the module."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                out_dim = 1 if isinstance(m, nn.ConvTranspose2d) else 0
                fan_in = m.weight.numel() // m.weight.shape[out_dim]
                std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.GroupNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            gamma = getattr(m, "gamma", None)
            if isinstance(gamma, nn.Parameter):
                gamma.zero_()
    return module


def conv_out_size(size: int, strides: int) -> int:
    """The side after `strides` 3x3 stride-2 convs with padding 1."""
    for _ in range(strides):
        size = (size - 1) // 2 + 1
    return size


class Discriminator(nn.Module):
    def __init__(self, in_channels: int = 1, dim_features: int = 32, image_size: int = 32):
        super().__init__()
        f = dim_features
        prev = in_channels
        for i, mult in enumerate((1, 2, 4, 8, 16)):
            self.add_module(f"conv{i + 1}", nn.Conv2d(prev, f * mult, 3, stride=2, padding=1,
                                                      bias=False))
            prev = f * mult
        side = conv_out_size(image_size, 5)
        self.linear1 = nn.Linear(prev * side * side, f * 8, bias=False)
        self.linear2 = nn.Linear(f * 8, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(5):
            h = F.leaky_relu(getattr(self, f"conv{i + 1}")(h), 0.01)
        # flattened in NHWC (H, W, C) order, as the Flax reshape does
        h = h.permute(0, 2, 3, 1).flatten(1)
        h = F.leaky_relu(self.linear1(h), 0.01)
        return self.linear2(h).squeeze(-1)


class Generator(nn.Module):
    def __init__(self, dim_latent: int = 100, dim_features: int = 32, out_channels: int = 1):
        super().__init__()
        f = dim_features
        self.linear = nn.Linear(dim_latent, f * 16, bias=False)
        prev = f * 16
        for i, mult in enumerate((8, 4, 2, 1)):
            self.add_module(f"conv{i + 1}", nn.Conv2d(prev, f * mult, 3, padding=1, bias=False))
            prev = f * mult
        self.conv5 = nn.Conv2d(prev, out_channels, 3, padding=1, bias=False)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.linear(z)[:, :, None, None]  # a 1x1 map: no flatten order

        def up(x):  # jax.image.resize "bilinear" when upsampling
            return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)

        for i in range(4):
            h = F.leaky_relu(getattr(self, f"conv{i + 1}")(up(h)), 0.01)
        return torch.sigmoid(self.conv5(up(h)))
