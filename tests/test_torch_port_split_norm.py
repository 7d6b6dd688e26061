"""The split GroupNorm(+SiLU) of the spatial-parallel path against the JAX
package's whole-image GroupNorm.

Under --mesh_spatial each model rank holds rows [j*H/M, (j+1)*H/M) of every
(image, group) span. parallel/sp.py normalises them with the whole image's
statistics through ops/groupnorm.py's split pair: group_norm_sums, an
all-reduce, group_norm_apply, and backward group_norm_backward_sums, an
all-reduce, group_norm_backward_apply (kernels 2 and 2b in their split modes
on the card, the plain functions below on the CPU). Here the M ranks are
row pieces split in one process, and the all-reduce is a sum of the pieces'
(2, B*G) tensors in piece order. The result must be what the JAX package
computes under SP: GSPMD's partition of masked_diffusion_tpu/ops/pallas/
groupnorm.py:_gn_reference over the whole image, and its VJP.

Tolerances (fp32): forward atol = rtol = 1e-5, backward atol = rtol = 1e-4,
as chip_smoke.py's GN_TOL / GN_BWD_TOL: the sums are taken in another order
(per piece, then over the pieces). dscale and dbias are each piece's share,
summed over the pieces.
"""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops.pallas.groupnorm import _gn_reference
from masked_diffusion_tpu_torch.models.unet import GroupNormAct
from masked_diffusion_tpu_torch.ops import groupnorm as tgn
from masked_diffusion_tpu_torch.parallel import sp as tsp
from masked_diffusion_tpu_torch.parallel.mesh import PlanRef

FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(atol=1e-4, rtol=1e-4)
EPS = 1e-5

# (B, C, H, W, G): a ragged span (3 channels a group, 8x6), 4 rows that
# leave one row a piece at M = 4, and a span of 8 * 32 * 32 / M > 1024
# elements a piece (the cluster path's size on the card) at every M
SHAPES = ((2, 48, 8, 6, 16), (2, 64, 4, 4, 32), (1, 64, 32, 32, 8))
PIECES = (1, 2, 4)
PLAINS = ("group_norm_sums_plain", "group_norm_apply_plain", "group_norm_backward_sums_plain",
          "group_norm_backward_apply_plain", "group_norm_silu_plain",
          "group_norm_silu_backward_plain", "group_norm_stats_plain")


def _data(shape, seed):
    b, c, h, w, _ = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.7, size=(b, h, w, c)).astype(np.float32)  # NHWC, as JAX holds it
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    scale = rng.normal(1.0, 0.1, size=(c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.1, size=(c,)).astype(np.float32)
    return x, g, scale, bias


def _nchw(a):
    return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())


def _split_forward(x, scale, bias, groups, silu, m):
    """The split forward on m row pieces of NCHW x: each piece's sums, their
    sum (the all-reduce), each piece normalised with it. Returns y and each
    piece's (x, mean, rstd)."""
    pieces = x.chunk(m, dim=2)
    count = float(m * (x.shape[1] // groups) * pieces[0].shape[2] * x.shape[3])
    sums = sum(tgn.group_norm_sums_plain(p, groups) for p in pieces)
    out = [tgn.group_norm_apply_plain(p, scale, bias, sums, count, groups, EPS, silu)
           for p in pieces]
    return torch.cat([y for y, _, _ in out], 2), [(p, mn, rs) for p, (_, mn, rs) in
                                                   zip(pieces, out)], count


@pytest.mark.parametrize("m", PIECES)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_split_forward_matches_gn_reference(shape, silu, m):
    groups = shape[4]
    x, _, scale, bias = _data(shape, seed=sum(shape) + silu + 10 * m)
    y, parts, _ = _split_forward(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias),
                                 groups, silu, m)
    assert y.dtype == torch.float32 and all(mn.shape == (shape[0] * groups,) for _, mn, _ in parts)
    ref = np.asarray(_gn_reference(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                   groups, EPS, silu))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), ref, **FWD_TOL)
    # every piece carries the whole image's statistics, for the backward
    mean, rstd = tgn.group_norm_stats_plain(_nchw(x), groups, EPS)
    for _, mn, rs in parts:
        torch.testing.assert_close(mn, mean, **FWD_TOL)
        torch.testing.assert_close(rs, rstd, **FWD_TOL)


@pytest.mark.parametrize("m", PIECES)
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_split_backward_matches_jax_vjp(shape, silu, m):
    groups = shape[4]
    x, g, scale, bias = _data(shape, seed=3 * sum(shape) + silu + 10 * m)
    _, vjp = jax.vjp(lambda a, s, b: _gn_reference(a, s, b, groups, EPS, silu),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    rx, rs, rb = (np.asarray(v) for v in vjp(jnp.asarray(g)))

    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    _, parts, count = _split_forward(_nchw(x), st, bt, groups, silu, m)
    g_pieces = _nchw(g).chunk(m, dim=2)
    first = [tgn.group_norm_backward_sums_plain(p, st, bt, gp, mn, rsd, groups, silu)
             for (p, mn, rsd), gp in zip(parts, g_pieces)]
    sums = sum(f[0] for f in first)  # the all-reduce of m1, m2
    dx = torch.cat([tgn.group_norm_backward_apply_plain(p, st, bt, gp, mn, rsd, sums, count,
                                                        groups, silu)
                    for (p, mn, rsd), gp in zip(parts, g_pieces)], 2)
    dscale = sum(f[1] for f in first)  # the pieces' shares, as DDP sums them
    dbias = sum(f[2] for f in first)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), rx, err_msg="dx", **BWD_TOL)
    np.testing.assert_allclose(dscale.numpy(), rs, err_msg="dscale", **BWD_TOL)
    np.testing.assert_allclose(dbias.numpy(), rb, err_msg="dbias", **BWD_TOL)


@pytest.mark.parametrize("silu", [True, False])
def test_one_piece_is_the_whole_plain_version(silu):
    """M = 1 through the pair wrappers on the CPU: the whole plain forward
    and backward (fp32 sums in another order)."""
    b, c, h, w, groups = SHAPES[0]
    x, g, scale, bias = (torch.from_numpy(v) for v in _data(SHAPES[0], seed=5))
    x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
    before = tgn.group_norm_split.launches, tgn.group_norm_split_backward.launches
    y, mean, rstd = tgn.group_norm_split(x, scale, bias, groups, EPS, silu, lambda t: t, 1)
    torch.testing.assert_close(y, tgn.group_norm_silu_plain(x, scale, bias, groups, EPS, silu),
                               **FWD_TOL)
    got = tgn.group_norm_split_backward(x, scale, bias, g, mean, rstd, groups, silu,
                                        lambda t: t, 1)
    ref = tgn.group_norm_silu_backward_plain(x, scale, bias, g, mean, rstd, groups, silu)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, **BWD_TOL)
    assert (tgn.group_norm_split.launches, tgn.group_norm_split_backward.launches) == before


class _Plan:
    """Two model ranks whose rows are equal: the all-reduce doubles."""
    model_group = None
    model_size = 2


def test_split_norm_act_routes_through_the_wrappers(monkeypatch):
    """SplitGroupNormAct reaches the plain functions only inside the split
    pair wrappers (on the card the kernels), and gives the whole image's
    norm: two ranks holding the same rows x are the image [x; x]."""
    inside, wrapped, plain = [], [], []
    for name in ("group_norm_split", "group_norm_split_backward"):
        def spy(*a, _orig=getattr(tgn, name), _name=name, **k):
            wrapped.append(_name)
            inside.append(_name)
            try:
                return _orig(*a, **k)
            finally:
                inside.pop()
        monkeypatch.setattr(tsp, name, spy)
    for name in PLAINS:
        def pspy(*a, _orig=getattr(tgn, name), _name=name, **k):
            plain.append((_name, bool(inside)))
            return _orig(*a, **k)
        monkeypatch.setattr(tgn, name, pspy)
    monkeypatch.setattr(tsp, "all_reduce_sum", lambda t, group: t * 2)

    b, c, h, w, groups = SHAPES[0]
    x, g, scale, bias = (torch.from_numpy(v) for v in _data(SHAPES[0], seed=7))
    x, g = x.permute(0, 3, 1, 2).contiguous(), g.permute(0, 3, 1, 2).contiguous()
    norm = GroupNormAct(groups, c, EPS, True)
    with torch.no_grad():
        norm.weight.copy_(scale)
        norm.bias.copy_(bias)
    tsp._swap(norm, tsp.SplitGroupNormAct, PlanRef(_Plan()))
    xg = x.clone().requires_grad_(True)
    y = norm(xg)
    y.backward(g)
    assert wrapped == ["group_norm_split", "group_norm_split_backward"]
    assert [n for n, _ in plain] == list(PLAINS[:4]) and all(i for _, i in plain), plain

    whole = torch.cat([x, x], 2).requires_grad_(True)
    sw, bw = scale.clone().requires_grad_(True), bias.clone().requires_grad_(True)
    yw = tgn.group_norm_silu_plain(whole, sw, bw, groups, EPS, True)
    yw.backward(torch.cat([g, g], 2))
    torch.testing.assert_close(y.detach(), yw.detach()[:, :, :h], **FWD_TOL)
    torch.testing.assert_close(xg.grad, whole.grad[:, :, :h], **BWD_TOL)
    # each rank's share is half the whole image's
    torch.testing.assert_close(norm.weight.grad, sw.grad / 2, **BWD_TOL)
    torch.testing.assert_close(norm.bias.grad, bw.grad / 2, **BWD_TOL)


def test_a_tensor_off_the_cpu_never_takes_the_plain_functions(monkeypatch):
    """The wrappers take the plain functions only for CPU tensors: any other
    device is the kernel's, and without a card it raises."""
    called = []
    for name in PLAINS:
        monkeypatch.setattr(tgn, name, lambda *a, _n=name, **k: called.append(_n))
    x = torch.empty(2, 64, 4, 4, device="meta")
    scale, bias = torch.ones(64, device="meta"), torch.zeros(64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        tgn.group_norm_split(x, scale, bias, 32, EPS, True, lambda t: t, 2)
    stats = torch.empty(64, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        tgn.group_norm_split_backward(x, scale, bias, x, stats, stats, 32, True, lambda t: t, 2)
    assert called == []


def test_sp_names_no_plain_function():
    """parallel/sp.py reaches GroupNorm only through the split pair."""
    tree = ast.parse(open(tsp.__file__).read())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) for a in n.names}
    assert not {n for n in names if "plain" in n}, names
    assert {"group_norm_split", "group_norm_split_backward"} <= names


@pytest.mark.parametrize("backward", [False, True])
def test_gn_plan_split_passes_stage_nothing(backward):
    """The split passes stage nothing. The sums pass takes the whole call's
    path: its warp plan, or its CTAs a span with the cluster path's float
    region alone in shared memory. The apply pass runs the cluster path's
    kernel with the whole call's CTAs a span, one where the whole call takes
    the warp path."""
    for (b, c, h, w, groups) in ((8, 128, 32, 64, 32), (8, 512, 1, 2, 32), (8, 256, 4, 8, 32),
                                 (2, 256, 128, 256, 32), (8, 256, 256, 256, 32)):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            whole = tgn.gn_plan(b, c, h, w, groups, dtype, backward)
            for mode in ("sums", "apply"):
                p = tgn.gn_plan(b, c, h, w, groups, dtype, backward, mode=mode)
                what = f"{(b, c, h, w)} {dtype} backward={backward} {mode}: {p}"
                if whole.per_lane and mode == "sums":
                    assert p == whole, what
                    continue
                span = (c // groups) * h * w
                assert p.per_lane == 0 and p.ctas == whole.ctas and not p.on_chip, what
                assert p.grid == b * groups * p.ctas and p.slice == tgn.gn_slice(span, p.ctas)
                assert p.smem == tgn._float_bytes(c // groups, p.threads), what
    with pytest.raises(ValueError, match="mode"):
        tgn.gn_plan(8, 128, 32, 64, 32, torch.float32, False, mode="split")
