"""Time-conditioned U-Net denoiser (PyTorch, NCHW).

Counterpart of masked_diffusion_tpu/models/unet.py:UNet2D — the diffusers
UNet2DModel design space of the reference (utils/model.py:24-32): ResnetBlock
(GroupNorm -> SiLU -> conv, time projection add), attention blocks with
head_dim-partitioned heads, stride-2 conv down, nearest x2 + conv up, skip
concatenation, and a zero-initialised output conv.

Parameter names are the diffusers names that
masked_diffusion_tpu/io/export_torch.py:state_dict_from_params emits, so an
exported checkpoint loads with strict=True.

Every GroupNorm runs through the fused kernel wrapper
(ops/groupnorm.py:group_norm_silu): norm1/norm2 and norm_out with SiLU, the
attention group_norm without. Attention routes as the JAX AttentionBlock
does (models/unet.py:437-449), by UNetConfig.tinyhead_attention and
attention_chunk (attention_route):

  tinyhead_attention  attention_chunk  S >= 128, D <= 8  elsewhere
  None                None/0           kernel            plain
  None                N                chunked           chunked
  True                None/0           kernel            plain
  True                N                kernel            chunked
  False               None/0           plain             plain
  False               N                chunked           chunked

"kernel" is the tiny-head wrapper (ops/tinyhead_attention.py: the kernel on
CUDA, its plain version on the CPU), "plain" its plain version (einsum ->
fp32 softmax -> einsum), "chunked" the plain version over blocks of N query
rows (chunked_attention_plain).

Switches that change no parameter (UNetConfig.remat, attention_chunk,
tinyhead_attention; io/weights.unet_config_meta leaves them out):

  remat     the down and up paths' ResnetBlocks run under
            torch.utils.checkpoint when a gradient is being recorded (JAX
            nn.remat at :458-459); the middle and the attention blocks keep
            their activations
  forward(..., cached=, return_cached=)
            the encoder cache of --encoder_reuse (JAX :391-407): with
            return_cached the call also returns (h after the middle, the
            skips); given that back as `cached`, conv_in, the down path and
            the middle are skipped and only the up path runs, with the
            current t's embedding

Tensor and spatial parallelism convert a built UNet2D in place, swapping
module classes for subclasses and keeping every parameter name:
parallel/tp.py:shard_module (column-parallel Conv2d/Linear, GroupNormAct
with its weight and bias gathered) and parallel/sp.py:split_module (halo
convolutions, GroupNorm with all-reduced statistics, attention on the
gathered block, conv_in and conv_out reading and gathering whole images).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu
from masked_diffusion_tpu_torch.ops.tinyhead_attention import (
    chunked_attention_plain,
    tinyhead_attention,
    tinyhead_attention_plain,
    tinyhead_supported,
)


def _norm_groups(channels: int, preferred: int = 32) -> int:
    # keep >= 2 channels per group: with one channel per group, GroupNorm
    # exactly cancels the per-channel time-embedding add in ResnetBlock
    g = min(preferred, max(1, channels // 2))
    while channels % g != 0:
        g -= 1
    return g


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers Timesteps semantics), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - freq_shift)
    emb = torch.exp(exponent)[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """The topology fields of the JAX package's UNetConfig, and its switches
    remat, attention_chunk (None or 0: off) and tinyhead_attention (None:
    the kernel wherever it applies unless attention_chunk is set; True,
    False: forced). Its pallas_norm and pallas_attention have no
    counterpart: GroupNorm always takes the kernel, and the TPU's stock
    flash attention has none."""

    sample_size: int = 64
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)
    layers_per_block: int = 2
    # attn_down: shallowest level first; attn_up: DEEPEST block first
    # (diffusers down_block_types / up_block_types order)
    attn_down: Tuple[bool, ...] = (False, False, False, False, True, False)
    attn_up: Tuple[bool, ...] = (False, True, False, False, False, False)
    attention_head_dim: int = 8
    norm_groups: int = 32
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    remat: bool = False
    attention_chunk: Optional[int] = None
    tinyhead_attention: Optional[bool] = None

    def __post_init__(self):
        n = len(self.block_out_channels)
        if len(self.attn_down) != n or len(self.attn_up) != n:
            raise ValueError("attention placement length must match block count")


class GroupNormAct(nn.Module):
    """GroupNorm + affine + optional SiLU through the fused kernel wrapper.
    Holds `weight` and `bias` as nn.GroupNorm does."""

    def __init__(self, num_groups: int, channels: int, eps: float, silu: bool):
        super().__init__()
        self.num_groups, self.eps, self.silu = num_groups, eps, silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_silu(x, self.weight, self.bias, self.num_groups, self.eps, self.silu)


class ResnetBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, temb_dim: int, cfg: UNetConfig):
        super().__init__()
        self.norm1 = GroupNormAct(_norm_groups(c_in, cfg.norm_groups), c_in, cfg.norm_eps, True)
        self.conv1 = nn.Conv2d(c_in, c_out, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, c_out)
        self.norm2 = GroupNormAct(_norm_groups(c_out, cfg.norm_groups), c_out, cfg.norm_eps, True)
        self.conv2 = nn.Conv2d(c_out, c_out, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(c_in, c_out, 1) if c_in != c_out else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def attention_route(cfg: UNetConfig, s: int, d: int) -> str:
    """"kernel", "chunked" or "plain": the route of attention over S tokens
    in heads of D channels (the module docstring's table)."""
    tiny = cfg.tinyhead_attention
    if tiny is None:  # auto never overrides an asked-for chunk (JAX :437-443)
        tiny = not cfg.attention_chunk
    if tiny and tinyhead_supported(s, d):
        return "kernel"
    return "chunked" if cfg.attention_chunk else "plain"


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens, heads of head_dim channels."""

    def __init__(self, channels: int, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        self.heads = max(1, channels // cfg.attention_head_dim)
        self.group_norm = GroupNormAct(
            _norm_groups(channels, cfg.norm_groups), channels, cfg.norm_eps, False
        )
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        hidden = self.group_norm(x).reshape(b, c, h * w).transpose(1, 2)  # (B, S, C)

        def split_heads(t):
            return t.reshape(b, h * w, self.heads, c // self.heads).transpose(1, 2)

        q = split_heads(self.to_q(hidden))
        k = split_heads(self.to_k(hidden))
        v = split_heads(self.to_v(hidden))
        scale = 1.0 / math.sqrt(c // self.heads)
        route = attention_route(self.cfg, h * w, c // self.heads)
        if route == "kernel":
            out = tinyhead_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)
        elif route == "chunked":
            out = chunked_attention_plain(q, k, v, scale, self.cfg.attention_chunk)
        else:
            out = tinyhead_attention_plain(q, k, v, scale)
        out = out.transpose(1, 2).reshape(b, h * w, c)
        out = self.to_out[0](out)
        return x + out.transpose(1, 2).reshape(b, c, h, w)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, temb_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(dim, temb_dim)
        self.linear_2 = nn.Linear(temb_dim, temb_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class DownBlock(nn.Module):
    def __init__(self, c_in, c_out, temb_dim, attn: bool, last: bool, cfg: UNetConfig):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList(
            ResnetBlock(c_in if j == 0 else c_out, c_out, temb_dim, cfg) for j in range(n)
        )
        self.attentions = nn.ModuleList(
            AttentionBlock(c_out, cfg) for _ in range(n if attn else 0)
        )
        self.downsamplers = nn.ModuleList([] if last else [Downsample(c_out)])


class UpBlock(nn.Module):
    def __init__(self, c_ins, c_out, temb_dim, attn: bool, last: bool, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(ResnetBlock(ci, c_out, temb_dim, cfg) for ci in c_ins)
        self.attentions = nn.ModuleList(
            AttentionBlock(c_out, cfg) for _ in range(len(c_ins) if attn else 0)
        )
        self.upsamplers = nn.ModuleList([] if last else [Upsample(c_out)])


class MidBlock(nn.Module):
    def __init__(self, channels, temb_dim, cfg: UNetConfig):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(channels, channels, temb_dim, cfg) for _ in range(2)
        )
        self.attentions = nn.ModuleList([AttentionBlock(channels, cfg)])


class UNet2D(nn.Module):
    """forward: (x NCHW, t (B,)) -> residual NCHW, in the module's dtype."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        self.config = cfg = config
        ch = cfg.block_out_channels
        n = len(ch)
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)

        skip_ch = [ch[0]]
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i in range(n):
            last = i == n - 1
            self.down_blocks.append(DownBlock(prev, ch[i], temb_dim, cfg.attn_down[i], last, cfg))
            skip_ch += [ch[i]] * cfg.layers_per_block + ([] if last else [ch[i]])
            prev = ch[i]

        self.mid_block = MidBlock(ch[-1], temb_dim, cfg)

        # up path, DEEPEST level first: attn_up[0] is the deepest block
        self.up_blocks = nn.ModuleList()
        rev = tuple(reversed(ch))
        for i in range(n):
            c_ins = []
            for _ in range(cfg.layers_per_block + 1):
                c_ins.append(prev + skip_ch.pop())
                prev = rev[i]
            self.up_blocks.append(
                UpBlock(c_ins, rev[i], temb_dim, cfg.attn_up[i], i == n - 1, cfg)
            )

        self.conv_norm_out = GroupNormAct(
            _norm_groups(ch[0], cfg.norm_groups), ch[0], cfg.norm_eps, True
        )
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)
        nn.init.zeros_(self.conv_out.weight)  # the residual starts at zero
        nn.init.zeros_(self.conv_out.bias)

    def _resnet(self, res: ResnetBlock, h: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        """A down or up path ResnetBlock, rematerialised in the backward when
        remat is on and a gradient is being recorded. The non-reentrant form
        replays autocast and works under DDP; nothing in the block draws a
        random number, so the RNG state is not saved and restored."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(res, h, temb, use_reentrant=False, preserve_rng_state=False)
        return res(h, temb)

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor, cached=None,
                return_cached: bool = False):
        """The residual; with return_cached, (residual, cache). Given a cache
        from an earlier call, x is not read: the up path runs on the cached
        encoder state with timesteps' embedding."""
        dtype = self.conv_in.weight.dtype
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(x.shape[0])
        temb = timestep_embedding(
            timesteps, self.config.block_out_channels[0],
            self.config.flip_sin_to_cos, self.config.freq_shift,
        ).to(dtype)
        temb = self.time_embedding(temb)

        if cached is None:
            h = self.conv_in(x.to(dtype))
            skips = [h]
            for blk in self.down_blocks:
                for j, res in enumerate(blk.resnets):
                    h = self._resnet(res, h, temb)
                    if len(blk.attentions):
                        h = blk.attentions[j](h)
                    skips.append(h)
                for down in blk.downsamplers:
                    h = down(h)
                    skips.append(h)

            h = self.mid_block.resnets[0](h, temb)
            h = self.mid_block.attentions[0](h)
            h = self.mid_block.resnets[1](h, temb)
            new_cached = (h, tuple(skips))
        else:
            h, cached_skips = cached
            h = h.to(dtype)
            skips = [s.to(dtype) for s in cached_skips]
            new_cached = cached

        for blk in self.up_blocks:
            for j, res in enumerate(blk.resnets):
                h = self._resnet(res, torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h)
            for up in blk.upsamplers:
                h = up(h)

        out = self.conv_out(self.conv_norm_out(h))
        return (out, new_cached) if return_cached else out
