"""Reference-era checkpoints in the port against the JAX package's reader
and import tool.

The fixture is a toy UNet's checkpoint in the reference's form, built by
renaming the port's own state dict as tests/test_import_torch.py builds
its fixture: unet/ and unet_ema/ save_pretrained folders (config.json and
the state dict) in safetensors or the .bin pickle, under current diffusers
names or the pre-0.15 attention names (query/key/value/proj_attn), with the
EMA hyperparameters merged into unet_ema/config.json, with and without
unet_ema/. Checks:

  * io/weights.load_checkpoint reads each as the JAX load_diffusers_folder
    does, modulo to_out.0 <-> to_out (the port keeps diffusers' Sequential
    index), and gives back the port's state dict bitwise;
  * io/import_torch.import_checkpoint gives the JAX tool's epoch, global
    step, unet_config and ema meta, and weights bitwise equal to the port's
    converter (io/weights.state_dict_from_flax) applied to the JAX
    map_state_dict params;
  * --method sample on the CPU serves the imported folder and the reference
    folder itself, with the same images; a resume from either is refused
    for the missing optimizer state.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from masked_diffusion_tpu.io import import_torch as jimport
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.io import import_torch as timport
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models.factory import build_unet

SIZE = 16
EMA_META = {"decay": 0.9999, "min_decay": 0.0, "optimization_step": 37, "power": 0.75,
            "inv_gamma": 1.0, "update_after_step": 0, "use_ema_warmup": True}
_LEGACY = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}


def _model(seed):
    torch.manual_seed(seed)
    model = build_unet(3, SIZE, SIZE, block_out_channels=(32, 64), layers_per_block=1)
    with torch.no_grad():  # no zero-initialised tensor: every name carries values
        for p in model.parameters():
            p.add_(0.01 * torch.randn_like(p))
    return model


def _legacy(sd):
    out = {}
    for k, v in sd.items():
        for new, old in _LEGACY.items():
            k = k.replace(f".{new}.", f".{old}.")
        out[k] = v
    return out


def _write_folder(folder, sd, config, fmt):
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "config.json"), "w") as f:
        json.dump(config, f)
    if fmt == "bin":
        torch.save({k: v.clone() for k, v in sd.items()},
                   os.path.join(folder, weights.BIN_NAME))
    else:
        weights.write_safetensors(os.path.join(folder, weights.WEIGHTS_NAME), sd)


def _reference(root, fmt, legacy, ema=True):
    """A reference checkpoint-epoch-3/ of the toy UNet; returns (path, unet
    state dict, EMA state dict or None) under the port's names."""
    unet, ema_model = _model(0), _model(1)
    config = weights.diffusers_config_from_unet(unet.config)
    path = os.path.join(root, "checkpoint-epoch-3")
    sds = {"unet": unet.state_dict(), "unet_ema": ema_model.state_dict() if ema else None}
    for sub, sd in sds.items():
        if sd is not None:
            cfg = {**config, **EMA_META} if sub == "unet_ema" else config
            _write_folder(os.path.join(path, sub), _legacy(sd) if legacy else sd, cfg, fmt)
    return path, sds["unet"], sds["unet_ema"]


def _same(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (what, k)


FORMS = [("safetensors", False), ("safetensors", True), ("bin", False), ("bin", True)]


@pytest.mark.parametrize("fmt,legacy", FORMS)
def test_load_checkpoint_reads_reference_folders_as_the_jax_reader(tmp_path, fmt, legacy):
    path, unet_sd, ema_sd = _reference(str(tmp_path), fmt, legacy)
    got_unet, got_ema, config = weights.load_checkpoint(path)
    _same(got_unet, unet_sd, "unet")
    _same(got_ema, ema_sd, "unet_ema")
    assert config["block_out_channels"] == [32, 64]
    for sub, got in (("unet", got_unet), ("unet_ema", got_ema)):
        jsd, _ = jimport.load_diffusers_folder(os.path.join(path, sub))
        mapped = {k.replace("to_out.0", "to_out"): v for k, v in got.items()}
        assert sorted(mapped) == sorted(jsd)
        for k, v in mapped.items():
            np.testing.assert_array_equal(v.numpy(), jsd[k], err_msg=k)


@pytest.mark.parametrize("fmt,legacy,ema", [("bin", True, True), ("safetensors", False, False),
                                            ("bin", False, True)])
def test_import_tool_equals_the_jax_tool(tmp_path, capsys, fmt, legacy, ema):
    src, _, _ = _reference(str(tmp_path / "ref"), fmt, legacy, ema=ema)
    assert timport.main([src, str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    (path,) = glob.glob(str(tmp_path / "port" / "checkpoint-epoch-*"))
    assert f"imported -> {path}" in out
    jpath = jimport.import_checkpoint(src, str(tmp_path / "jax"))
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(jpath, "meta.json")) as f:
        jmeta = json.load(f)
    for key in ("epoch", "global_step", "unet_config", "optimizer_imported", "imported_from"):
        assert meta[key] == jmeta[key], key
    assert meta.get("ema") == jmeta.get("ema") == (EMA_META if ema else None)
    assert meta["epoch"] == 3 and meta["global_step"] == (37 if ema else 3)
    assert meta["optimizer_imported"] is False and not os.path.exists(
        os.path.join(path, "optimizer"))
    assert meta["items"] == (["unet", "unet_ema"] if ema else ["unet"])

    # the weights: the port's converter on the JAX tool's parameter trees
    got_unet, got_ema, _ = weights.load_checkpoint(path)
    with open(os.path.join(src, "unet", "config.json")) as f:
        config = json.load(f)
    jcfg = jimport.unet_config_from_diffusers(config)
    assert timport.unet_config_from_diffusers(config).attn_down == jcfg.attn_down
    for sub, got in (("unet", got_unet), ("unet_ema", got_ema)):
        if got is None:
            assert sub == "unet_ema" and not ema
            continue
        jsd, _ = jimport.load_diffusers_folder(os.path.join(src, sub))
        _same(got, weights.state_dict_from_flax(jimport.map_state_dict(jsd, jcfg), jcfg), sub)


def test_import_tool_takes_a_bare_save_pretrained_folder(tmp_path):
    src, unet_sd, _ = _reference(str(tmp_path / "ref"), "bin", True, ema=False)
    path = timport.import_checkpoint(os.path.join(src, "unet"), str(tmp_path / "out"),
                                     global_step=11)
    jpath = jimport.import_checkpoint(os.path.join(src, "unet"), str(tmp_path / "jax"),
                                      global_step=11)
    assert os.path.basename(path) == os.path.basename(jpath) == "checkpoint-epoch-0"
    got_unet, got_ema, _ = weights.load_checkpoint(path)
    _same(got_unet, unet_sd, "bare unet")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert got_ema is None and meta["global_step"] == 11 and "ema" not in meta


def _cli_args(work, method, *extra):
    return ["--method", method, "--data_name", "synthetic", "--data_size", str(SIZE),
            "--data_subset", "True", "--data_subset_num", "8", "--batch_size", "4",
            "--num_epochs", "2", "--sample_num", "2", "--ddpm_schedule", "log",
            "--ddpm_num_steps", "6", "--mean_option", "degraded_area", "--sampling",
            "momentum", "--use_wandb", "False", "--block_out_channels", "32,64",
            "--layers_per_block", "1", "--device", "cpu", "--dir_work", str(work), *extra]


@pytest.fixture
def imported(tmp_path):
    src, _, _ = _reference(str(tmp_path / "ref"), "bin", True)
    return src, timport.import_checkpoint(src, str(tmp_path / "imported"))


def test_sample_serves_the_imported_and_the_reference_folder_alike(tmp_path, capsys, imported):
    pngs = {}
    for name, path in zip(("reference", "imported"), imported):
        assert port_cli.main(_cli_args(tmp_path / name, "sample", "--test_model_path",
                                       path)) == 0
        line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("sample_stats ")][-1]
        stats = json.loads(line.split(" ", 1)[1])
        assert stats["images"] == 2 and stats["finite"] and stats["ema"]
        files = sorted(glob.glob(os.path.join(stats["out_dir"], "sample_*.png")))
        pngs[name] = []
        for png in files:
            with open(png, "rb") as f:
                pngs[name].append(f.read())
    assert pngs["reference"] == pngs["imported"] and len(pngs["imported"]) == 3


@pytest.mark.parametrize("which", [0, 1], ids=["reference", "imported"])
def test_resume_from_a_reference_checkpoint_is_refused(tmp_path, imported, which):
    with pytest.raises(ValueError, match=r"missing \['optimizer'\]; resuming would silently"):
        port_cli.main(_cli_args(tmp_path / "run", "mean_shift", "--resume_from_checkpoint",
                                imported[which]))
    assert not glob.glob(str(tmp_path / "run" / "**" / "checkpoint-epoch-*"), recursive=True)
