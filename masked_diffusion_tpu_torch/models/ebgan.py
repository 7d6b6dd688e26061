"""EBGAN toy models (reference models/models_simple.py:8-96, after the
public eriklindernoren/PyTorch-GAN EBGAN example).

  EBGenerator     : z (62,) -> linear -> 8x8x128 map -> 2x (up2 + conv +
                    norm + LeakyReLU) -> conv -> tanh, 32x32x1 images.
  EBDiscriminator : energy model — stride-2 conv encoder, a 32-d embedding
                    bottleneck, linear expansion, and an upsample+conv
                    decoder; returns (reconstruction, embedding) for the
                    EBGAN energy + pull-away terms.
  AutoEncoder     : conv encoder to z_dim, linear+deconv decoder (28x28
                    MNIST).

The reference's BatchNorm layers are GroupNorm, as in the JAX package
(batch-independent statistics). NCHW counterpart of
masked_diffusion_tpu/models/ebgan.py; submodules carry the Flax names
(io/legacy_weights.py). Two layouts differ from the Flax models':

  * Flax flattens and reshapes NHWC maps in (H, W, C) order, torch's NCHW
    in (C, H, W). The models permute to NHWC before every flatten and
    after every reshape, so each linear's weight is the Flax kernel
    transposed and fc_norm2's groups run over the same flat (H, W, C)
    vector as in Flax.
  * Flax's ConvTranspose(k=3, s=2, padding="SAME") is a stride-2 transposed
    conv with the kernel unflipped, whose output starts one row and column
    before torch's padding-0 one: dec1/dec2 are padding-0
    nn.ConvTranspose2d's cropped to the first 2n rows and columns, holding
    the Flax kernel flipped in space (the converter flips it).

nn.GroupNorm's epsilon is Flax's 1e-6 (torch's default is 1e-5).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

FLAX_GN_EPS = 1e-6


def _up2(x: torch.Tensor) -> torch.Tensor:
    # jax.image.resize "nearest" x2 reads source index i // 2, as torch does
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _flat_hwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).flatten(1)


def _map_hwc(x: torch.Tensor, side: int, channels: int) -> torch.Tensor:
    return x.reshape(x.shape[0], side, side, channels).permute(0, 3, 1, 2)


class EBGenerator(nn.Module):
    def __init__(self, latent_dim: int = 62, out_channels: int = 1, image_size: int = 32):
        super().__init__()
        self.init_size = image_size // 4
        self.l1 = nn.Linear(latent_dim, 128 * self.init_size ** 2)
        self.conv1 = nn.Conv2d(128, 128, 3, padding=1)
        self.norm1 = nn.GroupNorm(32, 128, eps=FLAX_GN_EPS)
        self.conv2 = nn.Conv2d(128, 64, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, 64, eps=FLAX_GN_EPS)
        self.conv3 = nn.Conv2d(64, out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = _map_hwc(self.l1(z), self.init_size, 128)
        h = F.leaky_relu(self.norm1(self.conv1(_up2(h))), 0.2)
        h = F.leaky_relu(self.norm2(self.conv2(_up2(h))), 0.2)
        return torch.tanh(self.conv3(h))


class EBDiscriminator(nn.Module):
    def __init__(self, in_channels: int = 1, embedding_dim: int = 32, image_size: int = 32):
        super().__init__()
        self.down_size = image_size // 2
        flat = self.down_size ** 2 * 64
        self.down = nn.Conv2d(in_channels, 64, 3, stride=2, padding=1)
        self.embedding = nn.Linear(flat, embedding_dim)
        self.fc_norm1 = nn.GroupNorm(8, embedding_dim, eps=FLAX_GN_EPS)
        self.fc = nn.Linear(embedding_dim, flat)
        self.fc_norm2 = nn.GroupNorm(32, flat, eps=FLAX_GN_EPS)
        self.up = nn.Conv2d(64, in_channels, 3, padding=1)

    def forward(self, img: torch.Tensor):
        h = F.relu(self.down(img))
        embedding = self.embedding(_flat_hwc(h))
        h = F.relu(self.fc_norm1(embedding))
        h = F.relu(self.fc_norm2(self.fc(h)))  # groups over the (H, W, C) vector
        h = _up2(_map_hwc(h, self.down_size, 64))
        return self.up(h), embedding


class AutoEncoder(nn.Module):
    def __init__(self, z_dim: int = 2, in_channels: int = 1, image_size: int = 28):
        super().__init__()
        self.bottleneck = image_size // 4
        flat = 64 * self.bottleneck ** 2
        self.enc1 = nn.Conv2d(in_channels, 32, 3, padding=1)
        self.enc2 = nn.Conv2d(32, 64, 3, stride=2, padding=1)
        self.enc3 = nn.Conv2d(64, 64, 3, stride=2, padding=1)
        self.enc_fc = nn.Linear(flat, z_dim)
        self.dec_fc = nn.Linear(z_dim, flat)
        self.dec1 = nn.ConvTranspose2d(64, 64, 3, stride=2)
        self.dec2 = nn.ConvTranspose2d(64, 32, 3, stride=2)
        self.dec3 = nn.Conv2d(32, in_channels, 3, padding=1)

    @staticmethod
    def _same_up(deconv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
        """Flax ConvTranspose(3, 2, "SAME"): n -> 2n."""
        h, w = x.shape[-2:]
        return deconv(x)[..., : 2 * h, : 2 * w]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.leaky_relu(self.enc1(x), 0.01)
        h = F.leaky_relu(self.enc2(h), 0.01)
        h = F.leaky_relu(self.enc3(h), 0.01)
        z = F.leaky_relu(self.enc_fc(_flat_hwc(h)), 0.01)
        h = F.leaky_relu(_map_hwc(self.dec_fc(z), self.bottleneck, 64), 0.01)
        h = F.leaky_relu(self._same_up(self.dec1, h), 0.01)
        h = F.leaky_relu(self._same_up(self.dec2, h), 0.01)
        return self.dec3(h)
