"""The port's model zoo (models/zoo.py) against the JAX package's.

- Topology: for every name x size {32, 64, 128, 256} x channels {1, 3},
  the port's _zoo_config equals the JAX one field by field (no init).
- Parameter layout: io/weights.flax_layout walks the JAX model's parameter
  shapes (jax.eval_shape, no init cost) onto exactly the port model's
  state_dict names and shapes (the port model on the meta device), for
  every distinct zoo topology; the diffusers config.json agrees too.
- Forward parity: unet1, unet3 and unet5 at 32x32 with narrowed
  block_out_channels (each name's placement, groups and depth kept),
  JAX weights through state_dict_from_flax with strict=True; fp32 at the
  tolerance of tests/test_torch_port_unet.py (atol 2e-4, rtol 2e-3: conv
  sums in another order). Attention routes through the tiny-head path on
  both sides where S >= 128 (the JAX kernel in interpret mode, the port's
  wrapper by shape).
- The CLI trains --model unet1 on the CPU and serves its checkpoint.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.io import export_torch
from masked_diffusion_tpu.models import zoo as jzoo
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models import unet as unet_mod
from masked_diffusion_tpu_torch.models.factory import build_model_from_config
from masked_diffusion_tpu_torch.models import zoo as tzoo
from masked_diffusion_tpu_torch.ops import tinyhead_attention as tth
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401

TOPOLOGY = [f.name for f in dataclasses.fields(unet_mod.UNetConfig)]


@pytest.mark.parametrize("name", jzoo.ZOO_NAMES)
def test_topology_equals_jax_for_every_size_and_channel_count(name):
    assert tzoo.ZOO_NAMES == jzoo.ZOO_NAMES
    for size in (32, 64, 128, 256):
        for ch in (1, 3):
            j = jzoo._zoo_config(name, ch, size, ch)
            t = tzoo._zoo_config(name, ch, size, ch)
            assert {f: getattr(t, f) for f in TOPOLOGY} == {f: getattr(j, f) for f in TOPOLOGY}
            assert tzoo._attn_at_resolutions(size, 5, (8,)) == jzoo._attn_at_resolutions(size, 5, (8,))


# one case per distinct parameter structure of the zoo
LAYOUT_CASES = [("unet1", 32, 3), ("unet2", 32, 3), ("unet3", 32, 3), ("unet4", 32, 3),
                ("unet5", 32, 3), ("unet5", 256, 3), ("unet6", 32, 3), ("unet6", 256, 1)]


@pytest.mark.parametrize("name,size,ch", LAYOUT_CASES)
def test_parameter_layout_equals_jax(name, size, ch):
    jmodel = jzoo.Model(name, ch, size, size)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, ch)), jnp.zeros((1,))))
    layout = list(weights.flax_layout(shapes["params"], jmodel.config))
    want = {n: tuple(leaf.shape[i] for i in perm) if perm else tuple(leaf.shape)
            for n, leaf, perm in layout}
    assert len(want) == len(layout) == len(jax.tree.leaves(shapes))  # every leaf, once
    with torch.device("meta"):
        tmodel = tzoo.Model(name, ch, size, size)
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == want
    assert weights.diffusers_config_from_unet(tmodel.config) == \
        export_torch.diffusers_config_from_unet(jmodel.config)


def _random_variables(jmodel, size, seed):
    """Seeded random parameters in the JAX model's tree, from its shapes
    alone (a flax init on the CPU costs tens of seconds here): kernels
    N(0, 1/fan_in), biases N(0, 0.05^2), norm scales 1 + N(0, 0.05^2)."""
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), jnp.zeros((1,))))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape).astype(np.float32)
        return ((name == "scale") + rng.normal(0, 0.05, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _narrow(cfg, div):
    return dataclasses.replace(cfg, block_out_channels=tuple(c // div for c in cfg.block_out_channels))


@pytest.mark.parametrize("name,div,tinyhead_calls", [("unet1", 4, 5), ("unet3", 4, 0),
                                                     ("unet5", 4, 0)])
def test_forward_matches_jax(monkeypatch, name, div, tinyhead_calls):
    size = 32
    monkeypatch.setenv("MDT_TINYHEAD_INTERPRET", "1")
    jcfg = dataclasses.replace(_narrow(jzoo._zoo_config(name, 3, size, 3), div),
                               tinyhead_attention=True)
    jmodel = jzoo.UNet2D(config=jcfg)
    variables = _random_variables(jmodel, size, seed=2)
    rng = np.random.default_rng(3)

    tcfg = _narrow(tzoo._zoo_config(name, 3, size, 3), div)
    assert tcfg.norm_groups == jcfg.norm_groups and tcfg.layers_per_block == jcfg.layers_per_block
    tmodel = unet_mod.UNet2D(tcfg)
    tmodel.load_state_dict(weights.state_dict_from_flax(variables, jcfg), strict=True)
    calls = []

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return tth.tinyhead_attention(q, k, v, scale)

    monkeypatch.setattr(unet_mod, "tinyhead_attention", spy)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    t = np.asarray([3.0, 250.0], np.float32)
    want = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        got = tmodel.eval()(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t))
    assert len(calls) == tinyhead_calls  # attention at S >= 128 took the tiny-head route
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-4, rtol=2e-3)


def test_model_errors_and_passthrough():
    with pytest.raises(NotImplementedError, match="model selection error"):
        tzoo.Model("unet7", 3, 32, 32)
    with pytest.raises(ValueError, match="square"):
        tzoo.Model("unet1", 3, 32, 64)
    with torch.device("meta"):  # "default" is the factory's model, as in JAX
        assert tzoo.Model("default", 3, 32, 32, num_attention=5).config.attn_down == (
            False, True, True, True, True, True)
        for kw in ({"remat": True}, {"attention_chunk": 64}, {"tinyhead_attention": False}):
            assert getattr(tzoo.Model("unet6", 3, 32, 32, **kw).config, next(iter(kw))) == \
                next(iter(kw.values()))
    cfg, _ = port_cli.parse(["--model", "unet6", "--data_size", "32", "--tinyhead_attention", "true"])
    with torch.device("meta"):
        zoo = build_model_from_config(cfg)
        default = build_model_from_config(dataclasses.replace(cfg, model="default", num_attention=5))
        off = build_model_from_config(dataclasses.replace(cfg, tinyhead_attention=False))
    assert zoo.config == dataclasses.replace(tzoo._zoo_config("unet6", 3, 32, 3),
                                             tinyhead_attention=True)
    assert default.config.attn_down == (False, True, True, True, True, True)
    assert off.config.tinyhead_attention is False


def _cli_args(workdir, method, *extra):
    return [
        "--method", method, "--model", "unet1", "--data_name", "synthetic", "--data_size", "32",
        "--data_subset", "True", "--data_subset_num", "8", "--batch_size", "4",
        "--num_epochs", "1", "--save_images_epochs", "1", "--sampling", "momentum",
        "--ddpm_schedule", "log", "--ddpm_num_steps", "3", "--select_degrade_pixel", "indexing",
        "--mean_option", "degraded_area", "--shift_type", "1-d_constant", "--sample_num", "2",
        "--use_wandb", "False", "--lr_warmup_steps", "0", "--tinyhead_attention", "true",
        "--dir_work", str(workdir), "--device", "cpu", *extra,
    ]


def _stats(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line.split(" ", 1)[1])


def test_cli_trains_unet1_on_cpu_then_serves_it(tmp_path, capsys, monkeypatch):
    calls = []

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return tth.tinyhead_attention(q, k, v, scale)

    monkeypatch.setattr(unet_mod, "tinyhead_attention", spy)
    assert port_cli.main(_cli_args(tmp_path / "run", "mean_shift")) == 0
    stats = _stats(capsys.readouterr().out, "train_stats")
    assert stats["global_step"] == 2 and np.isfinite(stats["loss_mean_epoch"]).all()
    (ckpt,) = stats["checkpoints"]
    with open(os.path.join(ckpt, "meta.json")) as f:
        assert json.load(f)["unet_config"]["block_out_channels"] == [64, 128, 256]
    with open(os.path.join(ckpt, "unet", "config.json")) as f:
        assert json.load(f)["down_block_types"] == ["DownBlock2D", "AttnDownBlock2D",
                                                    "AttnDownBlock2D"]
    # the tiny-head route at level 1 (16x16, S=256) of every UNet forward,
    # two train steps then the EMA grid's reverse steps
    trained = len(calls)
    assert trained > 2 * 5 and set(calls) == {(4, 16, 256, 8), (2, 16, 256, 8)}

    assert port_cli.main(_cli_args(tmp_path / "serve", "sample", "--test_model_path", ckpt)) == 0
    served = _stats(capsys.readouterr().out, "sample_stats")
    assert served["ema"] and served["finite"] and served["images"] == 2
    assert len(calls) - trained == 5 * served["steps"] * served["batches"]
