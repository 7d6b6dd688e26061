"""Import a reference-trained checkpoint into the port's checkpoint layout.

Counterpart of masked_diffusion_tpu/io/import_torch.py:221-320. The
reference serializes checkpoints through custom accelerate hooks
(main_train_masked.py:195-225): `checkpoint-epoch-N/unet/` is a diffusers
`UNet2DModel.save_pretrained` folder (config.json + a state dict in
diffusion_pytorch_model.safetensors or .bin) and `checkpoint-epoch-N/
unet_ema/` the same for `EMAModel.save_pretrained` (shadow weights, with the
EMA hyperparameters merged into config.json). This tool brings those
weights across:

    python -m masked_diffusion_tpu_torch.io.import_torch <src> <out_dir>
        [--epoch N] [--global_step N]

reads the folders without diffusers (io/weights.load_diffusers_folder: the
.bin pickle or safetensors, legacy attention names renamed) and writes
<out_dir>/checkpoint-epoch-N/ in the layout of io/checkpoint.py: unet/ and
unet_ema/ as safetensors under the port's names, and meta.json with the JAX
tool's fields: `imported_from`, `optimizer_imported: false`, `unet_config`
(from the block types of unet/config.json) and `ema` (the hyperparameters
EMAModel.save_pretrained merged into unet_ema/config.json). The epoch comes
from the name `checkpoint-(epoch-)N`, the global step from the EMA's
`optimization_step` (else the epoch). A bare save_pretrained folder (a dir
with config.json) is taken as the unet, with no EMA.

The reference's optimizer.bin is not imported, so the result serves
(`--method sample|test --test_model_path`) but does not resume: a resume
from it is refused for the missing optimizer state
(train/trainer.py:Trainer.restore). `--method sample|test` also read a
reference folder directly (io/weights.load_checkpoint). The conversion is
host work and never touches the card.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import Optional

from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io
from masked_diffusion_tpu_torch.io.weights import load_diffusers_folder, unet_config_meta
from masked_diffusion_tpu_torch.models.unet import UNetConfig

# EMAModel.save_pretrained's hyperparameters in unet_ema/config.json
_EMA_KEYS = ("decay", "min_decay", "optimization_step", "power", "inv_gamma",
             "update_after_step", "use_ema_warmup")


def unet_config_from_diffusers(config: dict) -> UNetConfig:
    """A UNetConfig from a UNet2DModel config.json. Attention placement comes
    from the block-type lists (utils/model.py:6-20 builds them; 'Attn*' =
    attention at that level); up_block_types is deepest-first, the order of
    UNetConfig.attn_up."""
    down_types = config.get("down_block_types") or []
    up_types = config.get("up_block_types") or []
    channels = tuple(config.get("block_out_channels", (128, 128, 256, 256, 512, 512)))
    n = len(channels)
    attn_down = tuple(t.startswith("Attn") for t in down_types) if down_types else (False,) * n
    attn_up = tuple(t.startswith("Attn") for t in up_types) if up_types else (False,) * n
    head_dim = config.get("attention_head_dim", 8)
    if isinstance(head_dim, (list, tuple)):
        head_dim = head_dim[0]
    return UNetConfig(
        sample_size=config.get("sample_size", 64) or 64,
        in_channels=config.get("in_channels", 3),
        out_channels=config.get("out_channels", 3),
        block_out_channels=channels,
        layers_per_block=config.get("layers_per_block", 2),
        attn_down=attn_down,
        attn_up=attn_up,
        attention_head_dim=head_dim,
        norm_groups=config.get("norm_num_groups", 32),
        norm_eps=config.get("norm_eps", 1e-5),
        flip_sin_to_cos=config.get("flip_sin_to_cos", True),
        freq_shift=config.get("freq_shift", 0.0),
    )


def import_checkpoint(src: str, out_dir: str, epoch: Optional[int] = None,
                      global_step: Optional[int] = None) -> str:
    """Convert one reference checkpoint dir (unet/ and optionally unet_ema/),
    or a bare save_pretrained folder, into out_dir/checkpoint-epoch-N/.
    Returns the written checkpoint's path."""
    src = os.path.abspath(src)
    unet_dir, ema_dir = src, None
    if os.path.isdir(os.path.join(src, "unet")):
        unet_dir = os.path.join(src, "unet")
        if os.path.isdir(os.path.join(src, "unet_ema")):
            ema_dir = os.path.join(src, "unet_ema")

    unet_sd, config = load_diffusers_folder(unet_dir)
    ucfg = unet_config_from_diffusers(config)
    ema_sd, ema_config, ema_meta = None, None, {}
    if ema_dir is not None:
        ema_sd, ema_config = load_diffusers_folder(ema_dir)
        ema_meta = {k: ema_config[k] for k in _EMA_KEYS if k in ema_config}

    if epoch is None:
        m = re.search(r"checkpoint-(?:epoch-)?(\d+)$", os.path.basename(src))
        epoch = int(m.group(1)) if m else 0
    if global_step is None:
        # the reference parses the suffix as the step on resume
        # (main_train_masked.py:271-275); the EMA's optimization_step is the
        # per-update count and the better signal where it is present
        global_step = int(ema_meta.get("optimization_step", epoch))

    extra_meta = {"imported_from": src, "optimizer_imported": False,
                  "unet_config": unet_config_meta(ucfg)}
    if ema_meta:
        extra_meta["ema"] = ema_meta
    return ckpt_io.save_checkpoint(out_dir, epoch, global_step, unet_sd, ema_sd,
                                   extra_meta=extra_meta, config=config,
                                   ema_config=ema_config)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m masked_diffusion_tpu_torch.io.import_torch",
        description="Import a reference checkpoint (checkpoint-*/unet[,unet_ema] diffusers "
        "folders, safetensors or .bin) into the checkpoint layout the port serves from.",
    )
    ap.add_argument("src", help="reference checkpoint dir (or a bare save_pretrained folder)")
    ap.add_argument("out_dir", help="directory to write checkpoint-epoch-N into")
    ap.add_argument("--epoch", type=int, default=None,
                    help="override the epoch parsed from the src dir name")
    ap.add_argument("--global_step", type=int, default=None,
                    help="override the step (default: EMA optimization_step)")
    args = ap.parse_args(argv)
    path = import_checkpoint(args.src, args.out_dir, args.epoch, args.global_step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    print(f"imported -> {path}")
    print(f"  items: {meta['items']}  epoch: {meta['epoch']}  "
          f"global_step: {meta['global_step']}")
    print(f"  unet_config: {json.dumps(meta['unet_config'])}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
