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


def jax_unet_random(num_attention=1, seed=0):
    """As jax_unet, but every variable is seeded numpy values in the tree
    the init makes, its shapes by jax.eval_shape (the init compiles for ~8
    s on the CPU): kernels N(0, 1/fan_in), norm scales 1 + N(0, 0.05^2),
    biases N(0, 0.05^2)."""
    down, up = attention_placement(num_attention, 2)
    cfg = JaxUNetConfig(sample_size=SIZE, in_channels=3, out_channels=3,
                        block_out_channels=(32, 64), layers_per_block=1, attn_down=down,
                        attn_up=up)
    model = JaxUNet2D(config=cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
                            jnp.zeros((1,)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape).astype(np.float32)
        return ((name == "scale") + rng.normal(0, 0.05, shape)).astype(np.float32)

    return model, cfg, _numpy_tree(jax.tree_util.tree_map_with_path(fill, shapes))


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


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bf16_forward_matches_jax():
    """bf16: the JAX UNet with compute dtype bf16 (per-op casts, fp32
    params) against the port under autocast, as the train step runs it.
    The two bf16 outputs agree within 2x the larger of the two sides' own
    bf16-vs-fp32 distances (relative L2), and, since that bound alone
    cannot fail (the triangle inequality through the fp32 outputs), within
    2x JAX's own distance, as does the port's own. (Measured on the CPU at
    these shapes: 1.76e-2 apart, own distances 1.27e-2 JAX and 1.41e-2
    port. The timestep embedding's phase rounded to bf16 under autocast
    gives 2.91e-2 apart and fails.)"""
    jmodel, jcfg, variables = jax_unet_random(num_attention=2, seed=4)
    jbf16 = JaxUNet2D(config=jcfg, dtype=jnp.bfloat16)
    tmodel = port_unet(jcfg, variables)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    t = np.asarray([3.0, 700.0], np.float32)
    j32, j16 = (np.asarray(jax.jit(m.apply)(variables, jnp.asarray(x), jnp.asarray(t)),
                           np.float32) for m in (jmodel, jbf16))
    xt, tt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t)
    with torch.inference_mode():
        t32 = tmodel(xt, tt).permute(0, 2, 3, 1).numpy()
        with torch.autocast("cpu", dtype=torch.bfloat16):
            t16 = tmodel(xt, tt).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(t32, j32, atol=2e-4, rtol=2e-3)
    cross, own_jax, own_port = _rel(t16, j16), _rel(j16, j32), _rel(t16, t32)
    assert own_jax > 1e-3 and own_port > 1e-3  # both really ran in bf16
    assert cross <= 2 * max(own_jax, own_port), (cross, own_jax, own_port)
    assert cross <= 2 * own_jax and own_port <= 2 * own_jax, (cross, own_jax, own_port)


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
