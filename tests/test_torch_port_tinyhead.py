"""The tiny-head attention of the port (ops/tinyhead_attention.py) against
the JAX package's TPU kernel, run in interpret mode on the CPU as
tests/test_tinyhead_attention.py runs it.

The same numpy inputs go through the JAX kernel (tinyhead_attention(...,
interpret=True)) and through the port's plain version and its CPU autograd
Function. Tolerances: fp32, atol = rtol = 1e-5 (both compute fp32 scores
and an fp32 softmax, in another summation order); bf16, atol = rtol = 4e-3
(both round the probabilities and the output to bf16, so one bf16 ulp,
2^-8, may separate them). Gradients hold against jax.grad through the JAX
custom VJP at the fp32 tolerance. The AttentionBlock routes by shape, as
the JAX block does with tiny_flash on. The CUDA kernel itself is held
against the plain version in fp32 on the card (chip_smoke.py phase 11, and
the cuda-marked test here).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.models.unet import AttentionBlock as JaxAttentionBlock
from masked_diffusion_tpu.ops.pallas import tinyhead_attention as jth
from masked_diffusion_tpu_torch.models import unet as unet_mod
from masked_diffusion_tpu_torch.ops import tinyhead_attention as tth

SHAPES = [(2, 4, 128, 8), (1, 8, 256, 8), (2, 2, 384, 8), (1, 2, 200, 8), (1, 2, 128, 4)]
TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_outputs():
    """{(shape, dtype name): (inputs, JAX interpret-mode output as fp32)}."""
    out = {}
    for i, shape in enumerate(SHAPES):
        q, k, v = _qkv(shape, i)
        scale = 1.0 / math.sqrt(shape[-1])
        for name, jdt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
            got = jth.tinyhead_attention(*(jnp.asarray(t, jdt) for t in (q, k, v)), scale, 256, True)
            out[(shape, name)] = ((q, k, v), np.asarray(got.astype(jnp.float32)))
    return out


def _torch(arrays, name):
    dtype = getattr(torch, name)
    return [torch.from_numpy(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_and_cpu_function_match_the_jax_kernel(jax_outputs, shape, name):
    (q, k, v), want = jax_outputs[(shape, name)]
    qt, kt, vt = _torch((q, k, v), name)
    scale = 1.0 / math.sqrt(shape[-1])
    plain = tth.tinyhead_attention_plain(qt, kt, vt, scale)
    before = tth.tinyhead_attention.launches
    got = tth.tinyhead_attention(qt, kt, vt, scale)
    assert tth.tinyhead_attention.launches == before  # the CPU runs the plain version
    assert got.dtype == qt.dtype and got.shape == shape
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    np.testing.assert_allclose(plain.float().numpy(), want, atol=TOL[name], rtol=TOL[name])


@pytest.mark.parametrize("shape", [(1, 2, 128, 8), (1, 2, 200, 4)])
def test_gradients_match_jax_custom_vjp(shape):
    q, k, v = _qkv(shape, 7)
    g = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    scale = 1.0 / math.sqrt(shape[-1])

    def loss(q_, k_, v_):
        return jnp.sum(jth.tinyhead_attention(q_, k_, v_, scale, 256, True) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(tth.tinyhead_attention(*leaves, scale), leaves,
                              torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL["float32"],
                                   rtol=TOL["float32"])


def test_supported_equals_the_jax_predicate():
    for s in (1, 64, 127, 128, 129, 200, 4096):
        for d in range(1, 17):
            assert tth.tinyhead_supported(s, d) == jth.tinyhead_supported(s, d), (s, d)


def test_wrapper_raises_on_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 64, 8)
    with pytest.raises(ValueError, match="S>=128"):
        tth.tinyhead_attention(q, q, q, 1.0)
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="D<=8"):
        tth.tinyhead_attention(q, q, q, 1.0)
    q = torch.zeros(1, 2, 128, 8)
    with pytest.raises(ValueError, match="equal"):
        tth.tinyhead_attention(q, q[:, :1], q, 1.0)


def _block_inputs(c, size, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, size, size, c)).astype(np.float32)


def _port_block(jparams, c):
    blk = unet_mod.AttentionBlock(c, unet_mod.UNetConfig(norm_groups=8))
    p = jparams["params"]
    sd = {"group_norm.weight": p["group_norm"]["scale"], "group_norm.bias": p["group_norm"]["bias"]}
    for proj, name in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0")):
        sd[f"{name}.weight"] = np.asarray(p[proj]["kernel"]).T
        sd[f"{name}.bias"] = p[proj]["bias"]
    blk.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    return blk.eval()


def _spy(monkeypatch):
    calls = []

    def spy(q, k, v, scale):
        calls.append(tuple(q.shape))
        return tth.tinyhead_attention(q, k, v, scale)

    monkeypatch.setattr(unet_mod, "tinyhead_attention", spy)
    return calls


def test_attention_block_routes_as_the_jax_block(monkeypatch):
    """At S=256 the port's block goes through the wrapper (on the CPU its
    plain version, so bitwise the plain route) and matches the JAX block
    with tiny_flash=True through the interpret-mode kernel; at S=64 it takes
    the plain version, as the JAX block takes its einsum."""
    monkeypatch.setenv("MDT_TINYHEAD_INTERPRET", "1")
    c = 32
    jblk = JaxAttentionBlock(head_dim=8, norm_groups=8, tiny_flash=True)
    for size, want_calls in ((16, [(2, 4, 256, 8)]), (8, [])):  # S = 256, then 64
        x = _block_inputs(c, size, 3)
        params = jax.tree.map(np.asarray, jblk.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        want = np.asarray(jblk.apply(params, jnp.asarray(x)))
        blk = _port_block(params, c)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
        with torch.inference_mode():
            monkeypatch.setattr(unet_mod, "tinyhead_attention", tth.tinyhead_attention_plain)
            plain = blk(xt)
            calls = _spy(monkeypatch)
            got = blk(xt)
        assert calls == want_calls, size
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=2e-4, rtol=2e-3)


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    """The CUDA kernel against its plain version in fp32 on the same inputs
    on the card (TF32 off; bf16 inputs widened exactly; chip_smoke.py's
    TINYHEAD_TOL: the bf16 output within half a bf16 ulp)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in SHAPES + [(4, 16, 1024, 8)]:
        scale = 1.0 / math.sqrt(shape[-1])
        qkv = [torch.randn(shape, generator=gen, device="cuda") for _ in range(3)]
        for dtype, (atol, rtol) in ((torch.float32, (1e-5, 1e-4)),
                                    (torch.bfloat16, (1e-5, 2**-8 + 1e-4))):
            q, k, v = (t.to(dtype) for t in qkv)
            before = tth.tinyhead_attention.launches
            got = tth.tinyhead_attention(q, k, v, scale)
            assert tth.tinyhead_attention.launches == before + 1
            want = tth.tinyhead_attention_plain(q.float(), k.float(), v.float(), scale)
            torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
