"""Named model zoo: one UNet family, six named configurations.

A copy of masked_diffusion_tpu/models/zoo.py (ZOO_NAMES,
_attn_at_resolutions, _zoo_config and Model, :42-152) on the port's
UNetConfig; the port imports nothing of the JAX package, and
tests/test_torch_port_zoo.py holds every topology equal to the original.

The reference ships six hand-written PyTorch UNets selected by name
(models/models_Unet.py:17-175, dispatching to models/unet/unet{1..6}.py); all
share the same design space: resblocks + GroupNorm + self-attention at
configurable levels + sinusoidal time embedding. Each zoo name maps to a
configuration of the one UNet2D family covering the same architecture point:

  unet / unet1 : wandb-tutorial UNet (unet1.py) — 3-level 64/128/256 with
                 self-attention at every level below the stem, time_dim=256.
  unet2        : labml DDPM (unet2.py) — base 64, mults (1,2,2,4),
                 attention at the two deepest levels, 2 blocks.
  unet3        : HF annotated-diffusion (unet3.py) — base dim = image size,
                 mults (1,2,4,8), groups 8 (ConvNeXt blocks in the original;
                 covered by the resblock family).
  unet4        : OpenAI guided-diffusion (unet4.py) — base 128,
                 mults (1,2,4,8), attention at feature resolutions {16, 8},
                 2 res blocks.
  unet5        : SR3/Palette (unet5.py) — base 32, mults (1,2,4,8,8),
                 attention at feature resolution 8, 3 res blocks.
  unet6        : tqch/ddpm-torch (unet6.py) — base 128 with the reference's
                 per-image-size tables (models_Unet.py:142-159): 32/64 ->
                 mults [1,2,2,2] + attention at level 2; 128/256 ->
                 mults [1,1,2,2,4,4] + attention at level 4.

Model("default", ..., num_attention=n) is the default model (utils/model.py
MyModel), built by models/factory.build_unet, as in the JAX package.

Attention-at-resolution specs (unet4/unet5) convert to per-level flags via
level i having feature resolution image_size // 2**i.

Not carried over: the compute dtype arguments (the port's models are fp32
modules; bf16 comes from autocast in training and from the sampler's cast).
The switches remat, attention_chunk (0 as None) and tinyhead_attention pass
through to UNetConfig.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from masked_diffusion_tpu_torch.models.factory import build_unet
from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig

ZOO_NAMES = ("unet", "unet1", "unet2", "unet3", "unet4", "unet5", "unet6")


def _attn_at_resolutions(
    image_size: int, n_levels: int, resolutions: Tuple[int, ...]
) -> Tuple[bool, ...]:
    """Per-level attention flags for 'attend at feature resolution r' specs
    (unet4's attention_resolutions, unet5's attn_res)."""
    return tuple((image_size // (2**i)) in resolutions for i in range(n_levels))


def _zoo_config(
    name: str, data_channel: int, data_height: int, out_channel: int
) -> UNetConfig:
    size = data_height

    if name in ("unet", "unet1"):
        channels = (64, 128, 256)
        attn = (False, True, True)
    elif name == "unet2":
        base, mults = 64, (1, 2, 2, 4)
        channels = tuple(base * m for m in mults)
        attn = (False, False, True, True)
    elif name == "unet3":
        base, mults = size, (1, 2, 4, 8)
        channels = tuple(base * m for m in mults)
        attn = (False, False, False, True)
        return UNetConfig(
            sample_size=size, in_channels=data_channel, out_channels=out_channel,
            block_out_channels=channels, layers_per_block=2,
            attn_down=attn, attn_up=tuple(reversed(attn)), norm_groups=8,
        )
    elif name == "unet4":
        base, mults = 128, (1, 2, 4, 8)
        channels = tuple(base * m for m in mults)
        # upstream-caller quirk preserved: models_Unet.py:72 passes
        # attention_resolutions=(16,8) straight into unet4.py's UNetModel,
        # where the membership test is `ds in attention_resolutions` with ds
        # the DOWNSAMPLE RATE 1,2,4,8 (unet4.py:860,875,910) — so the
        # reference attends only where 2**level in (16,8), i.e. the deepest
        # level (ds=8); 16 never matches. NOT feature resolutions.
        attn = tuple(2**i in (16, 8) for i in range(len(mults)))
    elif name == "unet5":
        base, mults = 32, (1, 2, 4, 8, 8)
        channels = tuple(base * m for m in mults)
        attn = _attn_at_resolutions(size, len(mults), (8,))
        return UNetConfig(
            sample_size=size, in_channels=data_channel, out_channels=out_channel,
            block_out_channels=channels, layers_per_block=3,
            attn_down=attn, attn_up=tuple(reversed(attn)),
        )
    elif name == "unet6":
        base = 128
        if size in (32, 64):
            mults = (1, 2, 2, 2)
            attn = (False, False, True, False)
        elif size in (128, 256):
            mults = (1, 1, 2, 2, 4, 4)
            attn = (False, False, False, False, True, False)
        else:  # reference covers only {32,64,128,256}; extend by area
            mults = (1, 2, 2, 2) if size < 128 else (1, 1, 2, 2, 4, 4)
            attn = tuple(
                i == (2 if len(mults) == 4 else 4) for i in range(len(mults))
            )
        channels = tuple(base * m for m in mults)
    else:
        raise NotImplementedError("model selection error")

    # attn_up is diffusers up_block_types order (deepest first); mirroring the
    # down placement by resolution therefore reverses the tuple
    return UNetConfig(
        sample_size=size, in_channels=data_channel, out_channels=out_channel,
        block_out_channels=channels, layers_per_block=2,
        attn_down=attn, attn_up=tuple(reversed(attn)),
    )


def Model(
    name: str,
    data_channel: int,
    data_height: int,
    data_width: int,
    out_channel: Optional[int] = None,
    num_attention: int = 1,
    remat: bool = False,
    attention_chunk: Optional[int] = None,
    tinyhead_attention: Optional[bool] = None,
) -> UNet2D:
    """Zoo dispatch with the reference signature (models_Unet.py:17), in
    fp32; "default" is models/factory.build_unet."""
    if data_height != data_width:
        raise ValueError("zoo models are square-image models")
    out_channel = out_channel if out_channel is not None else data_channel
    switches = dict(remat=remat, attention_chunk=attention_chunk or None,
                    tinyhead_attention=tinyhead_attention)
    if name == "default":
        return build_unet(dim_channel=data_channel, dim_height=data_height,
                          dim_width=data_width, num_attention=num_attention, **switches)
    return UNet2D(dataclasses.replace(
        _zoo_config(name, data_channel, data_height, out_channel), **switches))
