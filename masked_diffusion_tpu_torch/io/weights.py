"""UNet weights: from JAX parameters, and the exported checkpoint layout.

A JAX checkpoint reaches the port through the JAX package's exporter,

    python -m masked_diffusion_tpu.io.export_torch <checkpoint-epoch-N> <out>

which writes checkpoint-epoch-N/{unet,unet_ema}/, each folder holding
config.json and diffusion_pytorch_model.safetensors under diffusers
UNet2DModel tensor names — the names of the port's UNet2D parameters.

- state_dict_from_flax: a JAX UNet2D parameter tree (numpy leaves) -> the
  port's state dict, for the default factory and every zoo topology. The
  same mapping as export_torch.state_dict_from_params (copied: that module
  sits behind io/__init__.py, which imports orbax): HWIO conv kernel ->
  (O, I, kh, kw), (in, out) dense kernel -> (out, in), norm scale/bias ->
  weight/bias. flax_layout is its name table, which walks shape-only trees
  too.
- read_safetensors / write_safetensors: the format by hand with numpy, so
  that loading needs no safetensors package: an 8-byte little-endian header
  length, a JSON header, then the raw little-endian tensor bytes.
- load_checkpoint / save_checkpoint: the export layout,
  checkpoint-epoch-N/{unet,unet_ema}/ (config.json and the safetensors
  file each) plus meta.json, which the port's trainer writes and its
  `--method sample` reads. load_checkpoint also reads the reference's own
  folders (load_diffusers_folder, as masked_diffusion_tpu/io/import_torch.py
  reads them): the diffusion_pytorch_model.bin pickle where there is no
  safetensors file, and the pre-0.15 diffusers attention names
  query/key/value/proj_attn as to_q/to_k/to_v/to_out.0 (the port keeps
  diffusers' to_out.0 index, which the JAX reader drops because its flax
  tree has no Sequential). A data-parallel run saves the module that
  DistributedDataParallel wraps, never the wrapper: the names carry no
  `module.` prefix, so a checkpoint of N ranks loads in one process and
  in the JAX package's io/import_torch.py.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

WEIGHTS_NAME = "diffusion_pytorch_model.safetensors"
BIN_NAME = "diffusion_pytorch_model.bin"  # the torch pickle older diffusers wrote

# old (pre-0.15) diffusers AttentionBlock names -> the port's
_LEGACY_ATTN = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U8": np.uint8, "BOOL": np.bool_,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


#: transposes from the JAX layout: HWIO conv kernel -> (O, I, kh, kw),
#: (in, out) dense kernel -> (out, in); biases and norm scales as they are
_CONV, _DENSE = (3, 2, 0, 1), (1, 0)


def flax_layout(p: Dict[str, Any], ucfg) -> Iterator[Tuple[str, Any, Optional[tuple]]]:
    """(port parameter name, JAX leaf, transpose or None) for every parameter
    of a JAX UNet2D parameter tree p (without the 'params' level). Leaves
    are passed through untouched, so shape-only trees (jax.eval_shape) walk
    too. ucfg: a UNetConfig of either package (block_out_channels,
    layers_per_block, attn_down, attn_up); every zoo topology is one."""

    def conv(name, leaf):
        yield f"{name}.weight", leaf["kernel"], _CONV
        yield f"{name}.bias", leaf["bias"], None

    def dense(name, leaf):
        yield f"{name}.weight", leaf["kernel"], _DENSE
        yield f"{name}.bias", leaf["bias"], None

    def norm(name, leaf):
        yield f"{name}.weight", leaf["scale"], None
        yield f"{name}.bias", leaf["bias"], None

    def resnet(name, leaf):
        yield from norm(f"{name}.norm1", leaf["norm1"])
        yield from conv(f"{name}.conv1", leaf["conv1"])
        yield from dense(f"{name}.time_emb_proj", leaf["time_emb_proj"])
        yield from norm(f"{name}.norm2", leaf["norm2"])
        yield from conv(f"{name}.conv2", leaf["conv2"])
        if "conv_shortcut" in leaf:
            yield from conv(f"{name}.conv_shortcut", leaf["conv_shortcut"])

    def attn(name, leaf):
        yield from norm(f"{name}.group_norm", leaf["group_norm"])
        for proj in ("to_q", "to_k", "to_v"):
            yield from dense(f"{name}.{proj}", leaf[proj])
        yield from dense(f"{name}.to_out.0", leaf["to_out"])

    yield from dense("time_embedding.linear_1", p["time_dense1"])
    yield from dense("time_embedding.linear_2", p["time_dense2"])
    yield from conv("conv_in", p["conv_in"])
    n = len(ucfg.block_out_channels)
    for i in range(n):
        for j in range(ucfg.layers_per_block):
            yield from resnet(f"down_blocks.{i}.resnets.{j}", p[f"down_{i}_res_{j}"])
            if ucfg.attn_down[i]:
                yield from attn(f"down_blocks.{i}.attentions.{j}", p[f"down_{i}_attn_{j}"])
        if i != n - 1:
            yield from conv(f"down_blocks.{i}.downsamplers.0.conv",
                            p[f"down_{i}_downsample"]["conv"])
    yield from resnet("mid_block.resnets.0", p["mid_res_1"])
    yield from attn("mid_block.attentions.0", p["mid_attn"])
    yield from resnet("mid_block.resnets.1", p["mid_res_2"])
    for i in range(n):
        for j in range(ucfg.layers_per_block + 1):
            yield from resnet(f"up_blocks.{i}.resnets.{j}", p[f"up_{i}_res_{j}"])
            if ucfg.attn_up[i]:
                yield from attn(f"up_blocks.{i}.attentions.{j}", p[f"up_{i}_attn_{j}"])
        if i != n - 1:
            yield from conv(f"up_blocks.{i}.upsamplers.0.conv", p[f"up_{i}_upsample"]["conv"])
    yield from norm("conv_norm_out", p["norm_out"])
    yield from conv("conv_out", p["conv_out"])


def state_dict_from_flax(params_np: Dict[str, Any], ucfg) -> Dict[str, torch.Tensor]:
    """JAX UNet2D variables (numpy leaves; with or without the 'params' top
    level) -> the port's UNet2D state dict, by flax_layout."""
    p = params_np["params"] if "params" in params_np else params_np
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf, perm in flax_layout(p, ucfg):
        a = np.asarray(leaf)
        if a.dtype not in (np.float16, np.float32, np.float64):
            a = a.astype(np.float32)
        sd[name] = torch.from_numpy(np.ascontiguousarray(a.transpose(perm)) if perm else a)
    return sd


def diffusers_config_from_unet(ucfg) -> dict:
    """The config.json UNet2DModel.save_pretrained writes for this topology
    (as masked_diffusion_tpu/io/export_torch.py writes it)."""
    return {
        "_class_name": "UNet2DModel",
        "sample_size": ucfg.sample_size,
        "in_channels": ucfg.in_channels,
        "out_channels": ucfg.out_channels,
        "layers_per_block": ucfg.layers_per_block,
        "block_out_channels": list(ucfg.block_out_channels),
        "down_block_types": ["AttnDownBlock2D" if a else "DownBlock2D" for a in ucfg.attn_down],
        "up_block_types": ["AttnUpBlock2D" if a else "UpBlock2D" for a in ucfg.attn_up],
        "attention_head_dim": ucfg.attention_head_dim,
        "norm_num_groups": ucfg.norm_groups,
        "norm_eps": ucfg.norm_eps,
        "flip_sin_to_cos": ucfg.flip_sin_to_cos,
        "freq_shift": ucfg.freq_shift,
    }


def unet_config_meta(ucfg) -> dict:
    """meta.json's `unet_config`: the topology fields the JAX package's
    checkpoints record (trainer.py:_unet_meta, io/import_torch.py), lists
    for tuples."""
    return {k: (list(v) if isinstance(v, tuple) else v) for k, v in (
        ("sample_size", ucfg.sample_size), ("in_channels", ucfg.in_channels),
        ("out_channels", ucfg.out_channels), ("block_out_channels", ucfg.block_out_channels),
        ("layers_per_block", ucfg.layers_per_block), ("attn_down", ucfg.attn_down),
        ("attn_up", ucfg.attn_up), ("attention_head_dim", ucfg.attention_head_dim),
        ("norm_groups", ucfg.norm_groups))}


# ------------------------------------------------------------------ safetensors


def write_safetensors(path: str, tensors: Dict[str, Any]) -> None:
    """Write numpy arrays or CPU tensors in the safetensors format."""
    header: Dict[str, Any] = {}
    blobs = []
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        a = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        a = np.asarray(a, order="C")  # keeps a 0-d shape (ascontiguousarray makes it 1-d)
        if a.dtype not in _CODES:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors code here")
        raw = a.astype(a.dtype.newbyteorder("<"), copy=False).tobytes()
        header[name] = {"dtype": _CODES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)  # the spec pads the header to 8 bytes
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Read a safetensors file into numpy arrays. BF16 widens to float32
    (value-exact)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8 : 8 + n])
    body = memoryview(data)[8 + n :]
    out: Dict[str, np.ndarray] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":
            u16 = np.frombuffer(body[begin:end], dtype="<u2").astype(np.uint32)
            out[name] = (u16 << 16).view(np.float32).reshape(shape)
            continue
        if info["dtype"] not in _DTYPES:
            raise TypeError(f"{name}: unsupported safetensors dtype {info['dtype']}")
        dt = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        a = np.frombuffer(body[begin:end], dtype=dt).reshape(shape)
        out[name] = a.astype(a.dtype.newbyteorder("="))
    return out


# ------------------------------------------------------------------ checkpoints


def save_checkpoint(
    dirname: str,
    unet_sd: Dict[str, Any],
    config: dict,
    ema_sd: Optional[Dict[str, Any]] = None,
    ema_config: Optional[dict] = None,
    meta: Optional[dict] = None,
) -> str:
    """Write the export layout under dirname: unet/, unet_ema/ when ema_sd
    is given (with ema_config, else config), and meta.json when given.
    Raises on a state dict of a DistributedDataParallel wrapper."""
    folders = [("unet", unet_sd, config)]
    if ema_sd is not None:
        folders.append(("unet_ema", ema_sd, ema_config or config))
    for sub, sd, _ in folders:
        wrapped = [k for k in sd if k.startswith("module.")]
        if wrapped:
            raise ValueError(f"{sub}: {wrapped[0]!r} is a DistributedDataParallel name; "
                             "save the wrapped module (its .module)")
    for sub, sd, cfg in folders:
        folder = os.path.join(dirname, sub)
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        write_safetensors(os.path.join(folder, WEIGHTS_NAME), sd)
    if meta is not None:
        with open(os.path.join(dirname, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    return dirname


def weights_file(folder: str) -> Optional[str]:
    """The state dict file of a save_pretrained folder: the safetensors
    file, else the .bin pickle, else None."""
    for name in (WEIGHTS_NAME, BIN_NAME):
        path = os.path.join(folder, name)
        if os.path.exists(path):
            return path
    return None


def load_diffusers_folder(folder: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """One save_pretrained folder -> (state dict under the port's names,
    config.json or {}). Reads diffusion_pytorch_model.safetensors, else the
    .bin pickle (torch.load with weights_only=True); renames the legacy
    attention names (query/key/value/proj_attn)."""
    config: dict = {}
    if os.path.exists(os.path.join(folder, "config.json")):
        with open(os.path.join(folder, "config.json")) as f:
            config = json.load(f)
    path = weights_file(folder)
    if path is None:
        raise FileNotFoundError(f"no diffusion_pytorch_model.(safetensors|bin) under {folder}")
    if path.endswith(".bin"):
        raw = torch.load(path, map_location="cpu", weights_only=True)
        raw = {k: v.detach().contiguous() for k, v in raw.items()}
    else:
        raw = {k: torch.from_numpy(np.array(v)) for k, v in read_safetensors(path).items()}
    return {".".join(_LEGACY_ATTN.get(p, p) for p in k.split(".")): v
            for k, v in raw.items()}, config


def load_checkpoint(
    dirname: str,
) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]], dict]:
    """Read the export layout, or a reference checkpoint folder. Returns
    (unet state dict, unet_ema state dict or None, unet/config.json)."""
    if weights_file(os.path.join(dirname, "unet")) is None:
        raise FileNotFoundError(
            f"{dirname}: no unet/{WEIGHTS_NAME} or unet/{BIN_NAME} (write one with "
            "python -m masked_diffusion_tpu.io.export_torch)"
        )
    unet, config = load_diffusers_folder(os.path.join(dirname, "unet"))
    ema = None
    if weights_file(os.path.join(dirname, "unet_ema")) is not None:
        ema, _ = load_diffusers_folder(os.path.join(dirname, "unet_ema"))
    return unet, ema, config
