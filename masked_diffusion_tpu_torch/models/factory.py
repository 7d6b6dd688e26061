"""Model factory mirroring masked_diffusion_tpu/models/factory.py.

attention_placement maps --num_attention in 1..5 to per-level attention flags
exactly as the reference's utils/model.py:6-20 places Attn blocks in the
6-level UNet2DModel.
"""

from __future__ import annotations

from typing import Optional, Tuple

from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig
from masked_diffusion_tpu_torch.models.zoo import Model as zoo_model

_PLACEMENTS = {
    # num_attention: (down flags, up flags) over 6 levels (utils/model.py:6-20)
    1: ((0, 0, 0, 0, 1, 0), (0, 1, 0, 0, 0, 0)),
    2: ((0, 0, 0, 1, 1, 0), (0, 1, 1, 0, 0, 0)),
    3: ((0, 0, 1, 1, 1, 0), (0, 1, 1, 1, 0, 0)),
    4: ((0, 1, 1, 1, 1, 0), (0, 1, 1, 1, 1, 0)),
    5: ((0, 1, 1, 1, 1, 1), (1, 1, 1, 1, 1, 0)),
}

DEFAULT_BLOCK_OUT_CHANNELS: Tuple[int, ...] = (128, 128, 256, 256, 512, 512)


def attention_placement(num_attention: int, n_levels: int = 6):
    if num_attention not in _PLACEMENTS:
        raise NotImplementedError("not implemented")
    down6, up6 = _PLACEMENTS[num_attention]
    if n_levels == 6:
        return tuple(bool(d) for d in down6), tuple(bool(u) for u in up6)
    # shrunk configs: map each 6-level index onto the level at the same
    # relative depth
    down = [False] * n_levels
    up = [False] * n_levels
    for i, f in enumerate(down6):
        if f:
            down[round(i * (n_levels - 1) / 5)] = True
    for i, f in enumerate(up6):
        if f:
            up[round(i * (n_levels - 1) / 5)] = True
    return tuple(down), tuple(up)


def build_unet(
    dim_channel: int = 3,
    dim_height: int = 64,
    dim_width: int = 64,
    num_attention: int = 1,
    block_out_channels: Optional[Tuple[int, ...]] = None,
    layers_per_block: int = 2,
) -> UNet2D:
    """Equivalent of the reference's utils/model.MyModel (utils/model.py:3-33),
    in fp32; the sampler casts it to its compute dtype."""
    channels = tuple(block_out_channels or DEFAULT_BLOCK_OUT_CHANNELS)
    attn_down, attn_up = attention_placement(num_attention, len(channels))
    cfg = UNetConfig(
        sample_size=dim_height,
        in_channels=dim_channel,
        out_channels=dim_channel,
        block_out_channels=channels,
        layers_per_block=layers_per_block,
        attn_down=attn_down,
        attn_up=attn_up,
    )
    return UNet2D(cfg)


def build_model_from_config(cfg) -> UNet2D:
    """Model dispatch of the trainer and of --method sample
    (masked_diffusion_tpu/train/trainer.py:47-74): the default diffusers-style
    factory (--num_attention), or a named zoo architecture (--model
    unet1..unet6, models/zoo.py).

    --tinyhead_attention unset or true is what the port does: attention
    takes the tiny-head kernel wherever it applies (models/unet.py). false,
    the JAX package's einsum at those shapes, is refused."""
    if cfg.tinyhead_attention is False:
        raise NotImplementedError(
            "not yet ported: --tinyhead_attention false (the port's attention takes the "
            "tiny-head kernel wherever it applies)")
    if cfg.model != "default":
        return zoo_model(
            cfg.model, cfg.in_channel, cfg.data_size, cfg.data_size, cfg.out_channel,
            remat=cfg.remat, attention_chunk=cfg.attention_chunk,
        )
    return build_unet(
        dim_channel=cfg.in_channel,
        dim_height=cfg.data_size,
        dim_width=cfg.data_size,
        num_attention=cfg.num_attention,
        block_out_channels=cfg.block_out_channels,
        layers_per_block=cfg.layers_per_block,
    )
