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


# ---------------------------------------------------------------- backward
# The plain backward (autograd through group_norm_silu_plain; the Triton
# backward kernel's reference, checked against it on the card by
# chip_smoke.py phase 7) against jax.vjp of the JAX group_norm_silu in
# interpret mode, i.e. its custom VJP (groupnorm.py:164-181), as
# tests/test_pallas_groupnorm.py:46 runs it. fp32: atol 1e-5 (sums in another
# order). bf16 input: both sides recompute the forward in bf16, rounding each
# op at other places; dx at atol 3e-2 + rtol 2e-2, dscale/dbias (bf16 sums
# over B*H*W = 32 terms, up to ~16) at atol 0.125 + rtol 2e-2: a few bf16
# ulps (measured: 0.023 on dx, 0.19 on the sums).
BWD_TOL = {"float32": ((1e-5, 1e-5), (1e-5, 1e-5)),
           "bfloat16": ((3e-2, 2e-2), (0.125, 2e-2))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("c,groups", [(64, 32), (96, 32), (48, 16)])
def test_plain_backward_matches_jax_vjp(c, groups, silu, dtype):
    import jax

    x, scale, bias = _data(c, seed=3 * c + silu)
    g = np.random.default_rng(c).normal(size=x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _, vjp = jax.vjp(lambda a, s, b: pallas_gn(a, s, b, groups, 1e-5, silu, True),
                     *(jnp.asarray(v).astype(jdt) for v in (x, scale, bias)))
    ref = [np.asarray(v.astype(jnp.float32)) for v in vjp(jnp.asarray(g).astype(jdt))]

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt).requires_grad_(True)
    st = torch.from_numpy(scale).to(tdt).requires_grad_(True)
    bt = torch.from_numpy(bias).to(tdt).requires_grad_(True)
    before = (tgn.group_norm_silu.launches, tgn.group_norm_silu_backward.launches)
    y = tgn.group_norm_silu(xt, st, bt, groups, 1e-5, silu)  # the CPU wrapper: plain
    got = torch.autograd.grad(y, (xt, st, bt), torch.from_numpy(
        g.transpose(0, 3, 1, 2).copy()).to(tdt))
    assert (tgn.group_norm_silu.launches, tgn.group_norm_silu_backward.launches) == before
    assert all(v.dtype == tdt for v in got)
    got = [got[0].float().permute(0, 2, 3, 1).numpy(), got[1].float().numpy(),
           got[2].float().numpy()]
    (atol, rtol), (satol, srtol) = BWD_TOL[dtype]
    np.testing.assert_allclose(got[0], ref[0], atol=atol, rtol=rtol, err_msg="dx")
    np.testing.assert_allclose(got[1], ref[1], atol=satol, rtol=srtol, err_msg="dscale")
    np.testing.assert_allclose(got[2], ref[2], atol=satol, rtol=srtol, err_msg="dbias")
