"""The port's plain GroupNorm(+SiLU) against the JAX package.

The plain version (the Triton kernel's reference, ops/groupnorm.py) is held
against masked_diffusion_tpu/ops/pallas/groupnorm.py:_gn_reference and
against the Pallas kernel in interpret mode, as tests/test_pallas_groupnorm.py
runs it. NCHW in the port, NHWC in JAX.

Tolerances: fp32 atol 1e-5 (the statistics are summed in another order).
bf16 input: atol 8e-2, rtol 2e-2 — about one bf16 ulp at the outputs'
magnitude; the plain version and _gn_reference round each elementwise op to
bf16, the Pallas kernel normalises in fp32 and rounds once (the tolerance of
tests/test_pallas_groupnorm.py:test_bf16_roundtrip).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops.pallas.groupnorm import _gn_reference, group_norm_silu as pallas_gn
from masked_diffusion_tpu_torch.ops import groupnorm as tgn

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=8e-2, rtol=2e-2)}


def _data(c, seed, b=2, h=4, w=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.7, size=(b, h, w, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, silu, dtype):
    x = torch.from_numpy(x_nhwc.transpose(0, 3, 1, 2).copy()).to(dtype)
    y = tgn.group_norm_silu_plain(
        x, torch.from_numpy(scale).to(dtype), torch.from_numpy(bias).to(dtype), groups, 1e-5, silu
    )
    assert y.dtype == dtype
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("c,groups", [(64, 32), (96, 32), (256, 32), (48, 16)])
def test_plain_matches_gn_reference_and_pallas_kernel(c, groups, silu, dtype):
    x, scale, bias = _data(c, seed=c + silu)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    sj, bj = jnp.asarray(scale).astype(jdt), jnp.asarray(bias).astype(jdt)
    got = _port(x, scale, bias, groups, silu, tdt)
    ref = np.asarray(_gn_reference(xj, sj, bj, groups, 1e-5, silu).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, **TOL[dtype])
    kernel = np.asarray(pallas_gn(xj, sj, bj, groups, 1e-5, silu, True).astype(jnp.float32))
    np.testing.assert_allclose(got, kernel, **TOL[dtype])


def test_wrapper_on_cpu_is_the_plain_version():
    x, scale, bias = _data(64, seed=1)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    before = tgn.group_norm_silu.launches
    y = tgn.group_norm_silu(xt, s, b, 32)
    assert tgn.group_norm_silu.launches == before
    torch.testing.assert_close(y, tgn.group_norm_silu_plain(xt, s, b, 32), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tgn.group_norm_silu(xt, s, b, 24)  # 64 channels do not split into 24 groups
    with pytest.raises(ValueError):
        tgn.group_norm_silu(xt, s[:8], b, 32)
    with pytest.raises(ValueError):
        tgn.group_norm_silu(xt[0], s, b, 32)


def test_plain_matches_torch_group_norm():
    x, scale, bias = _data(96, seed=2)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy())
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    ref = torch.nn.functional.group_norm(xt, 32, s, b, 1e-5)
    torch.testing.assert_close(tgn.group_norm_silu_plain(xt, s, b, 32, silu=False), ref,
                               atol=1e-5, rtol=1e-5)
