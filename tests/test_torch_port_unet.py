"""The port's UNet2D against the JAX UNet2D, through the weight converter.

The JAX UNet is initialised at toy widths, its conv_out overwritten with
seeded random values (a fresh init outputs exactly 0, which would prove
nothing), converted with io/weights.state_dict_from_flax and loaded with
strict=True. The fp32 forwards agree to atol 2e-4, rtol 2e-3 (the tolerance
of tests/test_torch_parity.py:113: conv sums in another order). Also: the
converter equals the JAX exporter bitwise, and the port's safetensors reader
loads what the exporter writes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.io import export_torch
from masked_diffusion_tpu.models.factory import attention_placement
from masked_diffusion_tpu.models.unet import UNet2D as JaxUNet2D
from masked_diffusion_tpu.models.unet import UNetConfig as JaxUNetConfig
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig

SIZE = 16


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for the port's CPU tests (imported by the other
    port test files that run UNets): the suite runs several workers on one
    host, and every worker's torch taking all cores makes them 30x slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _numpy_tree(tree):
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.array(tree)


def jax_unet(channels=(32, 64), layers=1, num_attention=1, in_ch=3, seed=0, jit_init=False):
    """(JAX model, its UNetConfig, numpy variables with a random conv_out).
    jit_init compiles the init as one program: a fresh process's eager init
    compiles op by op, ~2.5x slower on the CPU."""
    down, up = attention_placement(num_attention, len(channels))
    cfg = JaxUNetConfig(
        sample_size=SIZE, in_channels=in_ch, out_channels=in_ch,
        block_out_channels=tuple(channels), layers_per_block=layers,
        attn_down=down, attn_up=up,
    )
    model = JaxUNet2D(config=cfg)
    init = jax.jit(model.init) if jit_init else model.init
    variables = _numpy_tree(init(
        jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, in_ch)), jnp.zeros((1,))
    ))
    rng = np.random.default_rng(seed)
    conv_out = variables["params"]["conv_out"]
    conv_out["kernel"] = rng.normal(0, 0.05, conv_out["kernel"].shape).astype(np.float32)
    conv_out["bias"] = rng.normal(0, 0.05, conv_out["bias"].shape).astype(np.float32)
    return model, cfg, variables


def port_unet(jcfg, variables):
    model = UNet2D(UNetConfig(
        sample_size=jcfg.sample_size, in_channels=jcfg.in_channels,
        out_channels=jcfg.out_channels, block_out_channels=jcfg.block_out_channels,
        layers_per_block=jcfg.layers_per_block, attn_down=jcfg.attn_down,
        attn_up=jcfg.attn_up, attention_head_dim=jcfg.attention_head_dim,
        norm_groups=jcfg.norm_groups,
    ))
    model.load_state_dict(weights.state_dict_from_flax(variables, jcfg), strict=True)
    return model.eval()


@pytest.mark.parametrize("num_attention,in_ch", [(1, 3), (2, 3), (3, 3), (4, 3), (5, 3), (1, 1)])
def test_forward_matches_jax(num_attention, in_ch):
    jmodel, jcfg, variables = jax_unet(num_attention=num_attention, in_ch=in_ch,
                                       seed=num_attention)
    tmodel = port_unet(jcfg, variables)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, SIZE, SIZE, in_ch)).astype(np.float32)
    t = np.asarray([3.0, 250.0], np.float32)
    j_out = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        t_out = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t))
    t_out = t_out.permute(0, 2, 3, 1).numpy()
    assert np.abs(j_out).max() > 1e-3  # the output depends on the weights
    np.testing.assert_allclose(t_out, j_out, atol=2e-4, rtol=2e-3)


def test_converter_equals_exporter_bitwise():
    _, jcfg, variables = jax_unet(channels=(32, 64, 64), num_attention=2)
    ours = weights.state_dict_from_flax(variables, jcfg)
    theirs = export_torch.state_dict_from_params(variables, jcfg)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    # and the port's module has exactly these parameters
    port = UNet2D(UNetConfig(
        sample_size=SIZE, block_out_channels=jcfg.block_out_channels,
        layers_per_block=jcfg.layers_per_block, attn_down=jcfg.attn_down, attn_up=jcfg.attn_up,
    ))
    assert sorted(port.state_dict()) == sorted(theirs)


def test_reader_loads_the_exporters_folder(tmp_path):
    _, jcfg, variables = jax_unet()
    sd = export_torch.state_dict_from_params(variables, jcfg)
    sd["half"] = np.arange(6, dtype=np.float16).reshape(2, 3)
    config = export_torch.diffusers_config_from_unet(jcfg)
    export_torch._write_pretrained(str(tmp_path / "unet"), sd, config)
    export_torch._write_pretrained(str(tmp_path / "unet_ema"), sd, config)
    unet, ema, cfg = weights.load_checkpoint(str(tmp_path))
    assert cfg == config
    for got in (unet, ema):
        assert sorted(got) == sorted(sd)
        for k, v in sd.items():
            assert got[k].numpy().dtype == v.dtype
            np.testing.assert_array_equal(got[k].numpy(), v)
    assert weights.diffusers_config_from_unet(jcfg) == config


def test_writer_is_read_by_safetensors(tmp_path):
    from safetensors.numpy import load_file

    rng = np.random.default_rng(0)
    sd = {"a.weight": rng.normal(size=(3, 4)).astype(np.float32),
          "b": np.arange(5, dtype=np.int64), "c": np.ones((2,), np.float16)}
    path = os.path.join(tmp_path, "w.safetensors")
    weights.write_safetensors(path, sd)
    back = load_file(path)
    mine = weights.read_safetensors(path)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k], v)
        np.testing.assert_array_equal(mine[k], v)
        assert back[k].dtype == v.dtype == mine[k].dtype
