"""Saliency EBM stack — the reference's legacy saliency models
(models/models_Saliency.py:11-30 dispatch; models/ResNet/ResNet_models.py:
GeneratorLatent :90, GeneratorBaseLine :400, Descriptor :38; backbone.py:
PAM_Module :51, CAM_Module :22; HolisticAttention.py HA :31), as the JAX
package rebuilt them compactly: the B2-ResNet50 backbone becomes a strided
residual encoder of configurable width; PAM/CAM are batched products; HA is
a conv with a fixed Gaussian kernel. The stack is disconnected from the
diffusion path (SURVEY.md §2.2).

NCHW counterpart of masked_diffusion_tpu/models/saliency.py; submodules
carry the Flax names (ResidualStage's unnamed Flax GroupNorm_0 is `norm`
here, io/legacy_weights.py maps it). Flax infers input widths, so the
constructors take them: `in_channels` of the image (3) and, for the
Descriptor, of image and saliency map together (4). nn.GroupNorm's epsilon
is Flax's 1e-6. Every resize upsamples, where jax.image.resize "bilinear"
equals F.interpolate(align_corners=False).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from masked_diffusion_tpu_torch.models.ebgan import FLAX_GN_EPS


def gaussian_kernel_2d(size: int = 31, sigma: float = 4.0, device=None) -> torch.Tensor:
    """Normalized 2-D Gaussian (HolisticAttention.gkern, :14-21)."""
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    k1 = torch.exp(-0.5 * (x / sigma) ** 2)
    k2 = torch.sqrt(torch.outer(k1, k1))
    return k2 / torch.sum(k2)


def holistic_attention(attention: torch.Tensor, x: torch.Tensor, size: int = 31,
                       sigma: float = 4.0) -> torch.Tensor:
    """HA op (HolisticAttention.py:31-43): blur the (B, 1, H, W) attention
    map with a Gaussian, floor it against itself (max(soft, att)), gate the
    features."""
    kernel = gaussian_kernel_2d(size, sigma, attention.device)[None, None]
    soft = F.conv2d(attention.float(), kernel, padding=size // 2)
    soft = torch.maximum(soft, attention)
    return soft * x


class PositionAttention(nn.Module):
    """PAM (backbone.py:51-84): spatial self-attention with C//8 projections
    and a learned residual scale."""

    def __init__(self, channels: int):
        super().__init__()
        d = max(1, channels // 8)
        self.query = nn.Conv2d(channels, d, 1)
        self.key = nn.Conv2d(channels, d, 1)
        self.value = nn.Conv2d(channels, channels, 1)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q = self.query(x).flatten(2).transpose(1, 2)  # (b, hw, d)
        k = self.key(x).flatten(2).transpose(1, 2)
        v = self.value(x).flatten(2).transpose(1, 2)  # (b, hw, c)
        scores = torch.einsum("bsd,btd->bst", q.float(), k.float())
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bst,btc->bsc", attn, v).transpose(1, 2).reshape(b, c, h, w)
        return self.gamma * out + x


class ChannelAttention(nn.Module):
    """CAM (backbone.py:22-49): channel-to-channel attention with the
    max-subtracted energy trick and a learned residual scale, in fp32."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.flatten(2).float()  # (b, c, hw)
        energy = torch.einsum("bcs,bds->bcd", flat, flat)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = torch.einsum("bcd,bds->bcs", attn, flat).reshape(x.shape)
        return (self.gamma * out + x).to(x.dtype)


class ResidualStage(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, stride=stride, padding=1)
        self.norm = nn.GroupNorm(min(32, out_channels), out_channels, eps=FLAX_GN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        # Flax's default "SAME" padding is none for a 1x1 window
        self.skip = nn.Conv2d(in_channels, out_channels, 1, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.norm(self.conv1(x))))
        return F.relu(h + self.skip(x))


class SaliencyEncoder(nn.Module):
    """Multi-scale feature pyramid standing in for the B2-ResNet backbone
    (ResNet.py:82-142): 4 strided residual stages -> (x1, x2, x3, x4)."""

    def __init__(self, in_channels: int = 3, width: int = 32):
        super().__init__()
        w = width
        self.stage1 = ResidualStage(in_channels, w)
        self.stage2 = ResidualStage(w, w * 2)
        self.stage3 = ResidualStage(w * 2, w * 4)
        self.stage4 = ResidualStage(w * 4, w * 8)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x1 = self.stage1(x)
        x2 = self.stage2(x1)
        x3 = self.stage3(x2)
        return x1, x2, x3, self.stage4(x3)


class _Decoder(nn.Module):
    """The top-down decoder both generators share: upsample to each skip,
    concat, conv + ReLU, then upsample to the input and predict 1 channel."""

    def __init__(self, width: int):
        super().__init__()
        w = width
        for i, (prev, cc) in enumerate(((w * 8, w * 4), (w * 4, w * 2), (w * 2, w))):
            self.add_module(f"dec{i}", nn.Conv2d(prev + cc, cc, 3, padding=1))
        self.pred = nn.Conv2d(w, 1, 3, padding=1)

    def decode(self, h, skips, size):
        for i, skip in enumerate(skips):
            h = F.interpolate(h, size=skip.shape[-2:], mode="bilinear", align_corners=False)
            h = F.relu(getattr(self, f"dec{i}")(torch.cat([h, skip], dim=1)))
        h = F.interpolate(h, size=size, mode="bilinear", align_corners=False)
        return self.pred(h)


class GeneratorLatent(_Decoder):
    """Latent-conditioned saliency generator (ResNet_models.py:90-103 +
    Saliency_feat_encoder :148-222): encoder pyramid, latent broadcast-concat
    at the deepest stage, PAM+CAM refinement, top-down decoder to a 1-channel
    saliency map at input resolution."""

    def __init__(self, width: int = 32, latent_dim: int = 8, in_channels: int = 3):
        super().__init__(width)
        self.encoder = SaliencyEncoder(in_channels, width)
        self.fuse_z = nn.Conv2d(width * 8 + latent_dim, width * 8, 3, padding=1)
        self.pam = PositionAttention(width * 8)
        self.cam = ChannelAttention()

    def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4 = self.encoder(x)
        zmap = z[:, :, None, None].to(x4.dtype).expand(-1, -1, *x4.shape[-2:])
        h = F.relu(self.fuse_z(torch.cat([x4, zmap], dim=1)))
        h = self.cam(self.pam(h))
        return self.decode(h, (x3, x2, x1), x.shape[-2:])


class GeneratorBaseLine(_Decoder):
    """No-latent variant (ResNet_models.py:400-412): same pyramid + decoder
    without the latent concat."""

    def __init__(self, width: int = 32, in_channels: int = 3):
        super().__init__(width)
        self.encoder = SaliencyEncoder(in_channels, width)
        self.pam = PositionAttention(width * 8)
        self.cam = ChannelAttention()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4 = self.encoder(x)
        h = self.cam(self.pam(x4))
        return self.decode(h, (x3, x2, x1), x.shape[-2:])


class Descriptor(nn.Module):
    """Energy model over (image, saliency-map) pairs
    (ResNet_models.py:38-88): concat -> strided conv stack -> scalar energy."""

    def __init__(self, width: int = 32, in_channels: int = 4):
        super().__init__()
        prev = in_channels
        for i, mult in enumerate((1, 2, 4, 8)):
            self.add_module(f"conv{i + 1}", nn.Conv2d(prev, width * mult, 3, stride=2,
                                                      padding=1))
            prev = width * mult
        self.fc1 = nn.Linear(prev, width * 4)
        self.fc2 = nn.Linear(width * 4, 1)

    def forward(self, image: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        h = torch.cat([image, seg.to(image.dtype)], dim=1)
        for i in range(4):
            h = F.leaky_relu(getattr(self, f"conv{i + 1}")(h), 0.2)
        h = F.leaky_relu(self.fc1(h.mean(dim=(2, 3))), 0.2)
        return self.fc2(h).squeeze(-1)


def SaliencyModel(work: str, method: str = "from_latent", width: int = 32,
                  latent_dim: int = 8, in_channels: int = 3) -> nn.Module:
    """Dispatch mirroring models_Saliency.Model (models_Saliency.py:11-30)."""
    if work == "generator":
        if method == "from_latent":
            return GeneratorLatent(width=width, latent_dim=latent_dim, in_channels=in_channels)
        if method == "from_image":
            return GeneratorBaseLine(width=width, in_channels=in_channels)
        raise NotImplementedError("model selection error")
    if work == "descriptor":
        return Descriptor(width=width, in_channels=in_channels + 1)
    raise NotImplementedError("model selection error")
