"""The model switches of the port against the JAX package: --remat,
--attention_chunk, --tinyhead_attention and the encoder cache that
--encoder_reuse replays (models/unet.py), and zoo.Model's signature.

Weights cross through state_dict_from_flax, as in
tests/test_torch_port_unet.py; the JAX switches change no parameter name, so
a JAX model built with them converts into the port's model built with them.
Tolerances: the UNet's fp32 forward atol 2e-4, rtol 2e-3
(test_torch_port_unet.py), gradients 2e-3 in relative L2 norm over the
model (test_torch_port_train.py); the plain attention under bf16 autocast
bitwise against the JAX einsum route; the attention block under bf16
autocast against JAX's bf16 block within 2 bf16 ulps of the output's
largest entry (2 * 2**-7 relative: the two frameworks' GroupNorm and dense
layers round their bf16 results in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.models import build_unet as jax_build_unet
from masked_diffusion_tpu.models import zoo as jzoo
from masked_diffusion_tpu.models.unet import AttentionBlock as JaxAttentionBlock
from masked_diffusion_tpu.models.unet import UNet2D as JaxUNet2D
from masked_diffusion_tpu.ops.pallas.tinyhead_attention import _einsum_reference
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models import unet as unet_mod
from masked_diffusion_tpu_torch.models import zoo as tzoo
from masked_diffusion_tpu_torch.models.factory import build_model_from_config
from masked_diffusion_tpu_torch.models.unet import AttentionBlock, UNet2D, UNetConfig
from masked_diffusion_tpu_torch.ops.tinyhead_attention import (
    chunked_attention_plain,
    tinyhead_attention_plain,
)
from tests.test_torch_port_unet import SIZE, jax_unet, two_torch_threads  # noqa: F401

TOL = dict(atol=2e-4, rtol=2e-3)


def _perturbed(variables, seed):
    """Every leaf moved by seeded noise, so every block shapes the output."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (a + 0.02 * rng.normal(size=a.shape)).astype(np.float32), variables)


def _switched(jcfg, variables, **switches):
    """The JAX model and the port's model on one topology with the same
    switches and weights."""
    jcfg = dataclasses.replace(jcfg, **switches)
    port = UNet2D(UNetConfig(**{f.name: getattr(jcfg, f.name)
                                for f in dataclasses.fields(UNetConfig)}))
    port.load_state_dict(weights.state_dict_from_flax(variables, jcfg), strict=True)
    return JaxUNet2D(config=jcfg), port


@pytest.fixture(scope="module")
def tiny():
    """A 2-level toy UNet with perturbed weights and one input."""
    _, jcfg, variables = jax_unet(channels=(16, 32), seed=3, jit_init=True)
    variables = _perturbed(variables, 4)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    t = np.asarray([2.0, 9.0], np.float32)
    return jcfg, variables, x, t


def _port_block(params, channels, cfg):
    """The port's AttentionBlock with a JAX AttentionBlock's weights."""
    p = params["params"]
    sd = {"group_norm.weight": p["group_norm"]["scale"], "group_norm.bias": p["group_norm"]["bias"]}
    for name, key in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                      ("to_out.0", "to_out")):
        sd[f"{name}.weight"] = p[key]["kernel"].T
        sd[f"{name}.bias"] = p[key]["bias"]
    blk = AttentionBlock(channels, cfg)
    blk.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    return blk


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


# ------------------------------------------------------------ bf16 attention
def test_plain_attention_under_autocast_equals_the_jax_einsum_bitwise():
    """bf16 q, k, v under bf16 autocast: fp32 scores and softmax, as JAX's
    preferred_element_type=float32 einsum; autocast once rounded the score
    product to bf16 (0.047 off at this shape)."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(0, 2.0, size=(2, 4, 16, 8)).astype(np.float32) for _ in range(3))
    scale = 8 ** -0.5
    want = np.asarray(_einsum_reference(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                        scale).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tinyhead_attention_plain(tq, tk, tv, scale)
        chunked = chunked_attention_plain(tq, tk, tv, scale, 5)
    assert got.dtype == chunked.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    np.testing.assert_array_equal(chunked.float().numpy(), want)


def test_attention_block_under_autocast_matches_jax_bf16():
    """The port's block at S = 64 < 128 (the plain route) under bf16 autocast
    against JAX's AttentionBlock(dtype=bf16) on the same weights."""
    c = 32
    x = np.random.default_rng(1).normal(size=(2, 8, 8, c)).astype(np.float32)
    jblk = JaxAttentionBlock(head_dim=8, dtype=jnp.bfloat16)
    params = _perturbed(jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(2), x)), 3)
    want = np.asarray(jblk.apply(params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    blk = _port_block(params, c, UNetConfig())
    with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = blk(_nchw(x).bfloat16())
    got = got.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2 * 2.0 ** -7 * np.abs(want).max(), rtol=0)


# ------------------------------------------------------------ remat
def _loss_and_grads(model, x, t):
    model.zero_grad()
    xt = _nchw(x).requires_grad_(True)
    out = model(xt, torch.from_numpy(t))
    (out ** 2).sum().backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return out.detach(), xt.grad, grads


def test_remat_is_bitwise_the_model_without_it_and_recomputes_the_path_resnets(
        tiny, monkeypatch):
    """Outputs and gradients bitwise equal without remat; the backward
    recomputes exactly the down and up paths' ResnetBlocks (two norms each),
    not the middle's or the attention's."""
    jcfg, variables, x, t = tiny
    _, plain = _switched(jcfg, variables)
    _, remat = _switched(jcfg, variables, remat=True)
    calls = []
    real = unet_mod.group_norm_silu
    monkeypatch.setattr(unet_mod, "group_norm_silu",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    o1, gx1, g1 = _loss_and_grads(plain, x, t)
    n_plain = len(calls)
    o2, gx2, g2 = _loss_and_grads(remat, x, t)
    path_resnets = sum(len(b.resnets) for b in (*remat.down_blocks, *remat.up_blocks))
    assert len(calls) - n_plain == n_plain + 2 * path_resnets
    assert torch.equal(o1, o2) and torch.equal(gx1, gx2)
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name
    with torch.no_grad():  # no gradient recorded: nothing to recompute
        calls.clear()
        assert torch.equal(remat(_nchw(x), torch.from_numpy(t)), o1)
        assert len(calls) == n_plain


def test_remat_matches_the_jax_remat_model(tiny):
    """The JAX nn.remat model (its names unchanged, so the converter carries
    it) against the port's remat model: the forward and every gradient."""
    jcfg, variables, x, t = tiny
    jmodel, port = _switched(jcfg, variables, remat=True)
    jv = jax.tree.map(jnp.asarray, variables)

    def loss(params, xx):
        return jnp.sum(jmodel.apply({"params": params}, xx, jnp.asarray(t)) ** 2)

    want = np.asarray(jax.jit(jmodel.apply)(jv, jnp.asarray(x), jnp.asarray(t)))
    jgrads, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jv["params"], jnp.asarray(x))
    out, gx, grads = _loss_and_grads(port, x, t)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), want, **TOL)
    jsd = weights.state_dict_from_flax(jax.tree.map(np.asarray, {"params": jgrads}), jcfg)
    num = sum(float(((grads[n] - jsd[n]) ** 2).sum()) for n in jsd)
    den = sum(float((jsd[n] ** 2).sum()) for n in jsd)
    assert den > 0 and (num / den) ** 0.5 < 2e-3
    gx_want = np.asarray(jgx)
    gx = gx.permute(0, 2, 3, 1).numpy()
    assert np.linalg.norm(gx - gx_want) / np.linalg.norm(gx_want) < 2e-3


# ------------------------------------------------------------ chunked attention
@pytest.mark.parametrize("chunk", [4, 7])
def test_chunked_attention_unet_matches_jax_chunked(tiny, chunk):
    """The tiny UNet with --attention_chunk 4 and 7 (7 divides no S) against
    the JAX model with the same chunk (tests/test_unet.py:93)."""
    jcfg, variables, x, t = tiny
    jmodel, port = _switched(jcfg, variables, attention_chunk=chunk)
    want = np.asarray(jax.jit(jmodel.apply)(jax.tree.map(jnp.asarray, variables),
                                            jnp.asarray(x), jnp.asarray(t)))
    with torch.inference_mode():
        got = port(_nchw(x), torch.from_numpy(t)).permute(0, 2, 3, 1).numpy()
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("chunk", [5, 16, 64])
def test_chunked_attention_block_matches_jax(chunk):
    """An S = 36 block, which no chunk here divides or which one chunk
    covers, against JAX's chunk_q block (tests/test_unet.py:120)."""
    x = np.random.default_rng(0).normal(size=(2, 6, 6, 16)).astype(np.float32)
    jblk = JaxAttentionBlock(head_dim=8, norm_groups=4, chunk_q=chunk)
    params = _perturbed(jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(1), x)), 2)
    want = np.asarray(jblk.apply(params, jnp.asarray(x)))
    blk = _port_block(params, 16, UNetConfig(norm_groups=4, attention_chunk=chunk))
    with torch.inference_mode():
        got = blk(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ routing
ROUTES = [  # (tinyhead_attention, attention_chunk, route at S >= 128, at S < 128)
    (None, None, "kernel", "plain"),
    (None, 32, "chunked", "chunked"),
    (True, None, "kernel", "plain"),
    (True, 32, "kernel", "chunked"),
    (False, None, "plain", "plain"),
    (False, 32, "chunked", "chunked"),
]


@pytest.mark.parametrize("tiny_flag,chunk,big,small", ROUTES,
                         ids=[f"{a}-{b}" for a, b, _, _ in ROUTES])
def test_attention_routes(monkeypatch, tiny_flag, chunk, big, small):
    """Each cell of models/unet.py's table, by which function each block
    calls at S = 256 and S = 64, and the same output on every route."""
    taken = []
    for name, route in (("tinyhead_attention", "kernel"), ("chunked_attention_plain", "chunked"),
                        ("tinyhead_attention_plain", "plain")):
        real = getattr(unet_mod, name)
        monkeypatch.setattr(unet_mod, name,
                            lambda *a, real=real, route=route: taken.append(route) or real(*a))
    torch.manual_seed(0)
    blk = AttentionBlock(32, UNetConfig(tinyhead_attention=tiny_flag, attention_chunk=chunk))
    ref = AttentionBlock(32, UNetConfig(tinyhead_attention=False))
    ref.load_state_dict(blk.state_dict())
    with torch.inference_mode():
        for side, route in ((16, big), (8, small)):
            x = torch.randn(2, 32, side, side)
            taken.clear()
            got = blk(x)
            assert taken == [route], (side, taken)
            torch.testing.assert_close(got, ref(x), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------ encoder cache
def test_encoder_cache_decode_is_exact(tiny):
    """return_cached/cached (tests/test_unet.py:136): the decode on the cache
    of the same input and t is the full forward bitwise, x unread; the cache
    passes through unchanged; another t through the same cache changes the
    output. The JAX model's cached decode agrees with the port's."""
    jcfg, variables, x, t = tiny
    jmodel, port = _switched(jcfg, variables)
    tt = torch.from_numpy(t)
    with torch.inference_mode():
        full = port(_nchw(x), tt)
        out, cached = port(_nchw(x), tt, return_cached=True)
        replay, cached2 = port(torch.full_like(full, float("nan")), tt, cached=cached,
                               return_cached=True)
        other = port(torch.zeros_like(full), tt + 3.0, cached=cached)
    assert torch.equal(out, full) and torch.equal(replay, full)
    assert cached2 is cached
    assert len(cached[1]) == 1 + sum(len(b.resnets) + len(b.downsamplers)
                                     for b in port.down_blocks)
    assert not torch.equal(other, full)
    jv = jax.tree.map(jnp.asarray, variables)
    apply = jax.jit(jmodel.apply, static_argnames="return_cached")
    _, jcache = apply(jv, jnp.asarray(x), jnp.asarray(t), return_cached=True)
    jother = apply(jv, jnp.zeros_like(jnp.asarray(x)), jnp.asarray(t) + 3.0, cached=jcache)
    np.testing.assert_allclose(other.permute(0, 2, 3, 1).numpy(), np.asarray(jother), **TOL)


# ------------------------------------------------------------ zoo and factory
def test_zoo_default_routes_to_the_factory_with_the_switches():
    """zoo.Model("default", num_attention=...) is the factory's model, as in
    JAX (tests/test_zoo.py:27); both dispatch arms carry the switches, 0 as
    no chunk (tests/test_zoo.py:141)."""
    with torch.device("meta"):
        for n in (1, 5):
            m = tzoo.Model("default", 3, 32, 32, num_attention=n)
            j = jzoo.Model("default", 3, 32, 32, num_attention=n)
            assert (m.config.block_out_channels, m.config.attn_down, m.config.attn_up) == (
                j.config.block_out_channels, j.config.attn_down, j.config.attn_up)
        for model in ("default", "unet6"):
            cfg = Config(model=model, data_size=32, remat=True, attention_chunk=256,
                         tinyhead_attention=False)
            m = build_model_from_config(cfg).config
            assert (m.remat, m.attention_chunk, m.tinyhead_attention) == (True, 256, False)
            m = build_model_from_config(dataclasses.replace(cfg, attention_chunk=0,
                                                            remat=False)).config
            assert m.attention_chunk is None and m.remat is False, model
            j = jzoo.Model(model, 3, 32, 32, remat=True, attention_chunk=0,
                           tinyhead_attention=True).config
            m = tzoo.Model(model, 3, 32, 32, remat=True, attention_chunk=0,
                           tinyhead_attention=True).config
            assert (m.remat, m.attention_chunk, m.tinyhead_attention) == (
                j.remat, j.attention_chunk, j.tinyhead_attention)


def test_switches_leave_the_checkpoint_meta_and_weights_alone():
    """A JAX model built with every switch converts into the port's model
    built with them (the same names), and meta.json's unet_config has no
    switch in it."""
    kw = dict(dim_channel=3, dim_height=SIZE, dim_width=SIZE, num_attention=1,
              block_out_channels=(16, 32), layers_per_block=1)
    jmodel = jax_build_unet(remat=True, attention_chunk=8, tinyhead_attention=False, **kw)
    args = (jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,)))
    shapes = jax.eval_shape(jmodel.init, *args)
    assert shapes == jax.eval_shape(jax_build_unet(**kw).init, *args)
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)
    port = tzoo.Model("default", 3, SIZE, SIZE, remat=True, attention_chunk=8,
                      tinyhead_attention=False)
    port = UNet2D(dataclasses.replace(port.config, block_out_channels=(16, 32),
                                      layers_per_block=1,
                                      attn_down=jmodel.config.attn_down,
                                      attn_up=jmodel.config.attn_up))
    port.load_state_dict(weights.state_dict_from_flax(variables, jmodel.config), strict=True)
    assert weights.unet_config_meta(port.config) == weights.unet_config_meta(
        dataclasses.replace(port.config, remat=False, attention_chunk=None,
                            tinyhead_attention=None))
    assert set(weights.unet_config_meta(port.config)).isdisjoint(
        {"remat", "attention_chunk", "tinyhead_attention"})
