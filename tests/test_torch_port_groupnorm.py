"""The port's plain GroupNorm(+SiLU) against the JAX package.

The plain version (the CUDA kernel's reference, ops/groupnorm.py) is held
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
# The plain backward (autograd through group_norm_silu_plain; the CUDA
# backward kernel is checked against it on the card by
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


# ------------------------------------------- the backward kernel's reference
# group_norm_silu_backward_plain follows the backward kernel's arithmetic
# (fp32 per-channel sums, dx, dscale/dbias summed in image order) and is its
# reference on the card. (a) Against jax.vjp of the JAX group_norm_silu in
# interpret mode, under BWD_TOL above: fp32 sums in another order; in bf16 the
# JAX VJP recomputes the forward in bf16 and the plain backward computes in
# fp32 on the same bf16 values, rounding dx once.


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("c,groups", [(64, 32), (96, 32), (48, 16)])
def test_backward_plain_matches_jax_vjp(c, groups, silu, dtype):
    import jax

    x, scale, bias = _data(c, seed=5 * c + silu)
    g = np.random.default_rng(c + 7).normal(size=x.shape).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    _, vjp = jax.vjp(lambda a, s, b: pallas_gn(a, s, b, groups, 1e-5, silu, True),
                     *(jnp.asarray(v).astype(jdt) for v in (x, scale, bias)))
    ref = [np.asarray(v.astype(jnp.float32)) for v in vjp(jnp.asarray(g).astype(jdt))]

    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(tdt)
    st, bt = torch.from_numpy(scale).to(tdt), torch.from_numpy(bias).to(tdt)
    gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(tdt)
    mean, rstd = tgn.group_norm_stats_plain(xt, groups)
    got = tgn.group_norm_silu_backward_plain(xt, st, bt, gt, mean, rstd, groups, silu)
    assert [v.dtype for v in got] == [tdt] * 3
    (atol, rtol), (satol, srtol) = BWD_TOL[dtype]
    np.testing.assert_allclose(got[0].float().permute(0, 2, 3, 1).numpy(), ref[0],
                               atol=atol, rtol=rtol, err_msg="dx")
    np.testing.assert_allclose(got[1].float().numpy(), ref[1], atol=satol, rtol=srtol,
                               err_msg="dscale")
    np.testing.assert_allclose(got[2].float().numpy(), ref[2], atol=satol, rtol=srtol,
                               err_msg="dbias")


# (b) Against autograd through group_norm_silu_plain in fp32 on the same
# values (bf16 inputs widened exactly): fp32 sums in another order, atol and
# rtol 1e-5 (the sums over the batch: 1e-5 per summed term); a bf16 dx is
# rounded once, 2^-8 relative, as chip_smoke.GN_BWD_TOL's bf16 entry.
AUTOGRAD_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("c,groups,h,w", [(64, 32, 4, 4), (48, 16, 5, 7), (32, 8, 6, 6)])
def test_backward_plain_matches_autograd(c, groups, h, w, silu, dtype):
    rng = np.random.default_rng(c * h + w + silu)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = torch.from_numpy(rng.normal(0.3, 1.7, (3, c, h, w)).astype(np.float32)).to(tdt)
    g = torch.from_numpy(rng.normal(size=(3, c, h, w)).astype(np.float32)).to(tdt)
    scale = torch.from_numpy(rng.normal(1.0, 0.1, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32))
    xr, sr, br = (v.float().clone().requires_grad_(True) for v in (x, scale, bias))
    yr = tgn.group_norm_silu_plain(xr, sr, br, groups, 1e-5, silu)
    ref = torch.autograd.grad(yr, (xr, sr, br), g.float())
    mean, rstd = tgn.group_norm_stats_plain(x, groups)
    got = tgn.group_norm_silu_backward_plain(x, scale, bias, g, mean, rstd, groups, silu)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    atol, rtol = AUTOGRAD_TOL[dtype]
    torch.testing.assert_close(got[0].float(), ref[0], atol=atol, rtol=rtol)
    for what, a, r in (("dscale", got[1], ref[1]), ("dbias", got[2], ref[2])):
        torch.testing.assert_close(a, r, atol=1e-5 * 3 * h * w, rtol=1e-5, msg=what)


# --------------------------------------------------------- the launch plan
# (c) gn_plan over every norm shape of the flagship at 64x64 and of unet6 at
# 128x128 and 256x256 (counted on the meta device, the norm and attention
# stubbed), both dtypes, forward and backward, at the batches the main paths
# run (flagship: serving 16, training 64; unet6: 8).


def _norm_shapes(monkeypatch, name, size):
    from masked_diffusion_tpu_torch.models import unet as unet_mod
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.zoo import Model

    shapes = {}

    def norm(x, scale, bias, groups, eps=1e-5, silu=True):
        key = (tuple(x.shape[1:]), groups)
        shapes[key] = shapes.get(key, 0) + 1
        return x

    monkeypatch.setattr(unet_mod, "group_norm_silu", norm)
    monkeypatch.setattr(unet_mod, "tinyhead_attention", unet_mod.tinyhead_attention_plain)
    with torch.device("meta"):
        model = build_unet(3, size, size) if name == "default" else Model(name, 3, size, size)
        with torch.no_grad():
            model(torch.zeros(1, 3, size, size), torch.full((1,), 10.0))
    return shapes


@pytest.mark.parametrize("name,size,batches,norms", [
    ("default", 64, (16, 64), 71), ("unet6", 128, (8,), 71), ("unet6", 256, (8,), 71)])
def test_gn_plan_covers_every_main_path_shape(monkeypatch, name, size, batches, norms):
    shapes = _norm_shapes(monkeypatch, name, size)
    assert sum(shapes.values()) == norms
    for ((c, h, w), groups) in shapes:
        n = (c // groups) * h * w
        for b in batches:
            for dtype in (torch.bfloat16, torch.float32):
                for backward in (False, True):
                    p = tgn.gn_plan(b, c, h, w, groups, dtype, backward)
                    what = f"{(b, c, h, w)} G={groups} {dtype} backward={backward}: {p}"
                    assert p.smem <= tgn.SMEM_MAX and p.ctas in tgn.CLUSTER_SIZES, what
                    cover = np.zeros(n, dtype=np.int64)
                    if p.per_lane:  # a warp per span, lane l holds j * 32 + l
                        assert p.ctas == 1 and p.threads == 32 * p.spans_per_cta, what
                        assert 0 <= p.grid * p.spans_per_cta - b * groups < p.spans_per_cta
                        idx = (np.arange(p.per_lane)[:, None] * 32 + np.arange(32)).ravel()
                        np.add.at(cover, idx[idx < n], 1)
                    else:
                        assert p.grid == b * groups * p.ctas and p.slice % tgn.GROUP == 0, what
                        for r in range(p.ctas):
                            cover[r * p.slice:min(n, (r + 1) * p.slice)] += 1
                    assert (cover == 1).all(), what
                    if dtype == torch.bfloat16:
                        assert p.on_chip, what


# (B, C, H, W, G): as chip_smoke.GN_BRANCH_SHAPES
GN_BRANCH_SHAPES = ((2, 48, 5, 7, 16), (16, 512, 2, 2, 32), (16, 512, 8, 8, 32),
                    (4, 768, 4, 4, 32), (24, 512, 2, 2, 32), (64, 256, 8, 8, 32),
                    (100, 512, 4, 4, 32),
                    (2, 48, 45, 45, 16), (8, 128, 128, 128, 32), (8, 256, 128, 128, 32),
                    (8, 256, 256, 256, 32))


def test_gn_plan_reaches_every_branch():
    """The shapes chip_smoke.py adds reach every cluster size, the warp
    path's three widths and its 1, 2, 4 and 8 spans a CTA, and a slice
    that does not stay on chip."""
    seen = set()
    for (b, c, h, w, groups) in GN_BRANCH_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for backward in (False, True):
                p = tgn.gn_plan(b, c, h, w, groups, dtype, backward)
                seen.add(("lane", p.per_lane) if p.per_lane else ("ctas", p.ctas))
                seen.add(("on_chip", p.on_chip))
                seen.add(("per_cta", p.spans_per_cta))
    assert seen == {("lane", 2), ("lane", 8), ("lane", 32), ("ctas", 1), ("ctas", 2),
                    ("ctas", 4), ("ctas", 8), ("ctas", 16), ("on_chip", True),
                    ("on_chip", False), ("per_cta", 1), ("per_cta", 2), ("per_cta", 4),
                    ("per_cta", 8)}
    # a card that cannot schedule 16 CTAs a cluster: 8 at most, off chip where needed
    p = tgn.gn_plan(8, 256, 256, 256, 32, torch.bfloat16, True, max_cluster=8)
    assert p.ctas == 8 and not p.on_chip


# (d) The cluster path's split sums: each rank's slice reduced on its own,
# then the ranks' partials added in rank order, as the kernels combine them
# through distributed shared memory. At a ragged span (C=48, G=16, 5x7: 105
# elements, no multiple of the 8-element load group) the statistics and the
# per-channel sums of the backward agree with the plain ones to fp32
# tolerance (atol 1e-6 + rtol 1e-5: sums of 105 terms in another order).


@pytest.mark.parametrize("ctas", [2, 4, 8, 16])
def test_cluster_split_sums_match_plain(ctas):
    rng = np.random.default_rng(ctas)
    b, c, h, w, groups = 2, 48, 5, 7, 16
    cg, n = c // groups, (c // groups) * h * w
    x = torch.from_numpy(rng.normal(0.3, 1.7, (b, c, h, w)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    scale = torch.from_numpy(rng.normal(1.0, 0.1, c).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, c).astype(np.float32))
    sl = tgn.gn_slice(n, ctas)
    assert sl % tgn.GROUP == 0 and sl * ctas >= n
    xs, gs = x.reshape(b * groups, n), g.reshape(b * groups, n)
    mean_ref, rstd_ref = tgn.group_norm_stats_plain(x, groups)
    _, ds_ref, db_ref = tgn.group_norm_silu_backward_plain(
        x, scale, bias, g, mean_ref, rstd_ref, groups, True)
    ds, db = torch.zeros(c), torch.zeros(c)
    for span in range(b * groups):
        grp = span % groups
        parts = [xs[span, r * sl:min(n, (r + 1) * sl)] for r in range(ctas)]
        tot, tot2 = torch.zeros(()), torch.zeros(())
        for p in parts:  # rank order
            tot, tot2 = tot + p.sum(), tot2 + p.square().sum()
        mean = tot / n
        rstd = torch.rsqrt(tot2 / n - mean * mean + 1e-5)
        torch.testing.assert_close(mean, mean_ref[span], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(rstd, rstd_ref[span], atol=1e-6, rtol=1e-5)
        ch = torch.arange(n) // (h * w)  # channel within the group of each element
        gam, bet = scale[grp * cg + ch], bias[grp * cg + ch]
        xh = (xs[span] - mean_ref[span]) * rstd_ref[span]
        y = xh * gam + bet
        s = torch.sigmoid(y)
        dy = gs[span] * s * (1 + y * (1 - s))
        sdy, sdyx = torch.zeros(cg), torch.zeros(cg)
        for r in range(ctas):  # each rank's per-channel parts, added in rank order
            lo, hi = r * sl, min(n, (r + 1) * sl)
            if lo < hi:
                sdy += torch.zeros(cg).index_add_(0, ch[lo:hi], dy[lo:hi])
                sdyx += torch.zeros(cg).index_add_(0, ch[lo:hi], (dy * xh)[lo:hi])
        db[grp * cg:(grp + 1) * cg] += sdy
        ds[grp * cg:(grp + 1) * cg] += sdyx
    torch.testing.assert_close(db, db_ref, atol=1e-6 * b * h * w, rtol=1e-5)
    torch.testing.assert_close(ds, ds_ref, atol=1e-6 * b * h * w, rtol=1e-5)
