"""The tiny-head attention of the port (ops/tinyhead_attention.py) against
the JAX package's TPU kernel, run in interpret mode on the CPU as
tests/test_tinyhead_attention.py runs it.

The same numpy inputs go through the JAX kernel (tinyhead_attention(...,
interpret=True)) and through the port's plain version and its CPU autograd
Function. Tolerances: fp32, atol = rtol = 1e-5 (both compute fp32 scores
and an fp32 softmax, in another summation order); bf16, atol = rtol = 4e-3
(both round the probabilities and the output to bf16, so one bf16 ulp,
2^-8, may separate them). Gradients hold against jax.grad through the JAX
custom VJP at the fp32 tolerance. The plain forward's log-sum-exp holds
against jax.nn.logsumexp of the JAX einsum scores, and the plain backward
(the backward kernel's arithmetic, from out and that log-sum-exp) against
the JAX custom VJP's backward and against autograd through the plain
version. The AttentionBlock routes by shape, as the JAX block does with
tiny_flash on. The CUDA kernels themselves are held against the plain
versions on the card (chip_smoke.py phase 11, and the cuda-marked test
here). A CPU model of the fp32 kernels' split-TF32 arithmetic (each product
as three tf32 products, tf32 rounding done on the bits as cvt.rna rounds
and as the tensor cores truncate,
dQ summed on the fp32 plan) holds against the JAX fp32 kernel and its
custom VJP within (1e-5, 1e-4), where a model with one tf32 product does
not: the limit tells the two apart.
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
# the plain backward against autograd through the plain version, atol = rtol:
# fp32, sums in another order; bf16, each side rounds its probabilities, its
# dS (or dP) and the result to bf16 (2^-8 relative each) on gradients of
# order 1, so two bf16 ulps of 1 may separate them
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2**-6}


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


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_plain_out_and_lse(shape):
    """out bitwise the plain version's (fp32 and bf16); lse the base-2
    log-sum-exp of the JAX einsum's scaled fp32 scores."""
    arrays = _qkv(shape, 20)
    scale = 1.0 / math.sqrt(shape[-1])
    for name in ("float32", "bfloat16"):
        qt, kt, vt = _torch(arrays, name)
        out, lse = tth.tinyhead_forward_plain(qt, kt, vt, scale)
        torch.testing.assert_close(out, tth.tinyhead_attention_plain(qt, kt, vt, scale),
                                   rtol=0, atol=0)
        assert lse.dtype == torch.float32 and lse.shape == shape[:3]

    @jax.jit
    def jax_lse(q, k):
        scores = jnp.einsum("bhsd,bhtd->bhst", q, k, preferred_element_type=jnp.float32)
        return jax.nn.logsumexp(scores * scale, axis=-1)

    want = np.asarray(jax_lse(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]))) * math.log2(math.e)
    _, lse = tth.tinyhead_forward_plain(*_torch(arrays, "float32"), scale)
    np.testing.assert_allclose(lse.numpy(), want, atol=TOL["float32"], rtol=TOL["float32"])


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_jax_custom_vjp(jax_outputs, shape):
    """From the fixture's inputs and the JAX kernel's own fp32 output, the
    plain backward equals the JAX custom VJP's backward (_bwd, the einsum
    recompute; the interpret-mode kernel is not run again)."""
    (q, k, v), out = jax_outputs[(shape, "float32")]
    g = np.random.default_rng(21).normal(size=shape).astype(np.float32)
    scale = 1.0 / math.sqrt(shape[-1])
    want = jax.jit(lambda *a: jth._bwd(scale, 256, True, a[:3], a[3]))(
        *(jnp.asarray(t) for t in (q, k, v, g)))
    qt, kt, vt = _torch((q, k, v), "float32")
    _, lse = tth.tinyhead_forward_plain(qt, kt, vt, scale)
    got = tth.tinyhead_backward_plain(qt, kt, vt, torch.from_numpy(out.copy()), lse,
                                      torch.from_numpy(g), scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=TOL["float32"],
                                   rtol=TOL["float32"])


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_plain_matches_autograd_through_plain(shape, name):
    arrays = _qkv(shape, 22)
    qt, kt, vt = _torch(arrays, name)
    g = torch.from_numpy(np.random.default_rng(23).normal(size=shape).astype(np.float32))
    g = g.to(qt.dtype)
    scale = 1.0 / math.sqrt(shape[-1])
    out, lse = tth.tinyhead_forward_plain(qt, kt, vt, scale)
    got = tth.tinyhead_backward_plain(qt, kt, vt, out, lse, g, scale)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    want = torch.autograd.grad(tth.tinyhead_attention_plain(*leaves, scale), leaves, g)
    for a, w in zip(got, want):
        assert a.dtype == qt.dtype and a.shape == shape
        torch.testing.assert_close(a.float(), w.float(), atol=GRAD_TOL[name],
                                   rtol=GRAD_TOL[name])


def _counts():
    return (tth.tinyhead_attention.launches, tth.tinyhead_attention_backward.launches,
            tth.tinyhead_attention_fp32.launches, tth.tinyhead_attention_backward_fp32.launches)


def test_cpu_backward_runs_the_plain_version():
    """On the CPU the Function's backward is tinyhead_backward_plain, bitwise,
    and launches no kernel (no count moves, the fp32 instances' neither);
    the backward wrapper takes CPU tensors to it."""
    shape = (1, 2, 128, 8)
    arrays = _qkv(shape, 24)
    g = torch.from_numpy(np.random.default_rng(25).normal(size=shape).astype(np.float32))
    scale = 1.0 / math.sqrt(shape[-1])
    qt, kt, vt = _torch(arrays, "float32")
    out, lse = tth.tinyhead_forward_plain(qt, kt, vt, scale)
    want = tth.tinyhead_backward_plain(qt, kt, vt, out, lse, g, scale)
    before = _counts()
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    got = torch.autograd.grad(tth.tinyhead_attention(*leaves, scale), leaves, g)
    wrapped = tth.tinyhead_attention_backward(qt, kt, vt, out, lse, g, scale)
    assert _counts() == before
    for a, b, w in zip(got, wrapped, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
        torch.testing.assert_close(b, w, rtol=0, atol=0)


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
    # the backward kernel takes a plan in fp32 as in bf16, checked before the device
    lse = torch.zeros(1, 2, 128)
    for dtype in (torch.float32, torch.bfloat16):
        x = q.to(dtype)
        with pytest.raises(ValueError, match="takes a plan"):
            tth.launch_backward(x, x, x, x, lse, x, 1.0, None)
        plan = tth.tinyhead_bwd_plan(2, 128, 132, 8, x.element_size())
        with pytest.raises(RuntimeError, match="no kernel for cpu"):
            tth.launch_backward(x, x, x, x, lse, x, 1.0, plan)


PLAN_S = (128, 200, 256, 384, 1024, 4096)
PLAN_BH = (2, 64, 512)  # the zoo's batch x heads: 4 x 16 at S=4096, 32 x 16 at S=1024
PLAN_ELEM = (2, 4)  # bytes of an element: bf16, fp32


def _plan_warp_keys(plan, s, elem=2):
    """{(slice, pass, warp): the keys it owns}, as the backward kernel maps
    them (csrc/tinyhead_attention_bwd.cu: key0)."""
    wk = tth.BWD_WARP_KEYS[elem]
    passes = plan.keys // (wk * plan.warps)
    out = {}
    for sl in range(plan.slices):
        for p in range(passes):
            for w in range(plan.warps):
                k0 = sl * plan.keys + (p * plan.warps + w) * wk
                out[(sl, p, w)] = range(min(k0, s), min(k0 + wk, s))
    return out


@pytest.mark.parametrize("elem", PLAN_ELEM)
@pytest.mark.parametrize("bh", PLAN_BH)
@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("s", PLAN_S)
def test_bwd_plan_covers_every_key_once(s, d, bh, elem):
    plan = tth.tinyhead_bwd_plan(bh, s, 132, d, elem)
    assert tth.BWD_MIN_WARPS <= plan.warps <= tth.BWD_MAX_WARPS[elem]
    assert plan.keys % (tth.BWD_WARP_KEYS[elem] * plan.warps) == 0
    assert 1 <= plan.slices <= tth.tinyhead_bwd_max_slices(d, elem)
    assert (plan.slices - 1) * plan.keys < s <= plan.slices * plan.keys  # no slice empty
    seen = np.zeros(s, dtype=int)
    for keys in _plan_warp_keys(plan, s, elem).values():
        seen[list(keys)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("elem", PLAN_ELEM)
@pytest.mark.parametrize("bh", PLAN_BH)
@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("s", PLAN_S)
def test_bwd_plan_workspace_within_memory_share(s, d, bh, elem):
    """The workspace, with dq, dk and dv, stays under BWD_MEMORY_SHARE
    times q, k, v, out and dO in the same dtype (phase 11's peak limit); it
    is there exactly when dQ has parts to sum."""
    plan = tth.tinyhead_bwd_plan(bh, s, 132, d, elem)
    inputs = 5 * bh * s * d * elem
    parts = plan.slices > 1 or plan.keys > tth.BWD_WARP_KEYS[elem] * plan.warps
    assert plan.workspace == (plan.slices * bh * s * tth.HEAD_DIM_MAX * 4 if parts else 0)
    assert plan.workspace + 3 * bh * s * d * elem < tth.BWD_MEMORY_SHARE * inputs


@pytest.mark.parametrize("bh, s, sms, d, elem", [
    (0, 256, 132, 8, 2), (8, 127, 132, 8, 2), (8, 256, 132, 9, 2), (8, 256, 0, 8, 2),
    (8, 64, 132, 4, 2), (0, 256, 132, 8, 4), (8, 127, 132, 8, 4), (8, 256, 132, 9, 4),
    (8, 256, 132, 8, 1), (8, 256, 132, 8, 8)])
def test_bwd_plan_refuses_what_the_kernel_does_not_take(bh, s, sms, d, elem):
    with pytest.raises(ValueError, match="tinyhead_bwd_plan"):
        tth.tinyhead_bwd_plan(bh, s, sms, d, elem)


@pytest.mark.parametrize("elem", PLAN_ELEM)
@pytest.mark.parametrize("shape", [(1, 2, 384, 8), (1, 2, 1024, 4), (1, 1, 4096, 8),
                                   (1, 1, 4096, 2)])
def test_dq_summed_by_plan_matches_plain_and_jax(shape, elem):
    """dQ as the kernel sums it on its plan (bf16's, elem 2, or fp32's, 4),
    in fp32 (the plain version's dS): each warp's keys, the warps of a pass
    in order, the passes of a slice in order, then the slices in index
    order, scaled once; against tinyhead_backward_plain's dq and the JAX
    custom VJP's _bwd at the fp32 tolerance. bf16 takes 2, 4, 8 and 2 slices,
    the last in 2 passes; fp32 3, 8, 16 and 4."""
    b, h, s, d = shape
    q, k, v = _qkv(shape, 30)
    g = np.random.default_rng(31).normal(size=shape).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, gt = (torch.from_numpy(t) for t in (q, k, v, g))
    out, lse = tth.tinyhead_forward_plain(qt, kt, vt, scale)
    plan = tth.tinyhead_bwd_plan(b * h, s, 132, d, elem)
    p = torch.exp2(torch.einsum("bhsd,bhtd->bhst", qt, kt) * (scale * tth.LOG2E)
                   - lse[..., None])
    ds = p * (torch.einsum("bhsd,bhtd->bhst", gt, vt) - (gt * out).sum(-1, keepdim=True))
    owned = _plan_warp_keys(plan, s, elem)
    passes = plan.keys // (tth.BWD_WARP_KEYS[elem] * plan.warps)
    total = None
    for sl in range(plan.slices):
        for pas in range(passes):
            pass_sum = None
            for w in range(plan.warps):
                idx = torch.tensor(list(owned[(sl, pas, w)]), dtype=torch.long)
                part = torch.einsum("bhst,bhtd->bhsd", ds[..., idx], kt[:, :, idx])
                pass_sum = part if pass_sum is None else pass_sum + part
            sl_sum = pass_sum if pas == 0 else sl_sum + pass_sum
        total = sl_sum if total is None else total + sl_sum
    got = (total * scale).numpy()
    plain = tth.tinyhead_backward_plain(qt, kt, vt, out, lse, gt, scale)[0].numpy()
    want = jax.jit(lambda *a: jth._bwd(scale, 256, True, a[:3], a[3]))(
        *(jnp.asarray(t) for t in (q, k, v, g)))[0]
    assert plan.slices > 1
    np.testing.assert_allclose(got, plain, atol=TOL["float32"], rtol=TOL["float32"])
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL["float32"], rtol=TOL["float32"])


# the fp32 kernels' arithmetic (csrc/tinyhead_mma.cuh): a split-TF32 product
# against one tf32 product, at S in {128, 200, 384} and d in {4, 8}
MODEL_SHAPES = [(1, 2, s, d) for s in (128, 200, 384) for d in (4, 8)]
MODEL_TOL = (1e-5, 1e-4)  # (atol, rtol): chip_smoke.py's TINYHEAD_FP32_TOL


def _tf32(x):
    """fp32 x rounded to tf32 as cvt.rna.tf32.f32 rounds it: to nearest, ties
    away from zero, on the bits (add 0x1000, clear the 13 low bits)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _truncated(x):
    """fp32 x as a tf32 product reads it: its 13 low bits dropped."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _mm(a, b, split=True):
    """a @ b in fp32 as the fp32 kernels' tensor cores form it: split, the
    three products lo hi + hi lo + hi hi of x = hi + lo (hi = tf32(x), lo = x
    - hi, which the product truncates to tf32); else one tf32 product.
    Products exact, sums in float64."""
    def parts(x):
        hi = _tf32(x)
        return hi.astype(np.float64), _truncated(x - hi).astype(np.float64)

    (ah, al), (bh, bl) = parts(a), parts(b)
    if not split:
        return (ah @ bh).astype(np.float32)
    return (al @ bh + ah @ bl + ah @ bh).astype(np.float32)


def _model_forward(q, k, v, scale, split=True):
    """(out, lse) as tinyhead_fwd_tf32_kernel computes them: scores of q c
    (c = scale log2 e) in base 2, P = 2^(S - max) split into the P V
    product, the row sum in fp32, out = P V / sum, lse = max + log2 sum."""
    c = np.float32(scale * tth.LOG2E)
    sc = _mm(q * c, np.swapaxes(k, -1, -2), split)
    m = sc.max(-1, keepdims=True)
    p = np.exp2(sc - m)
    lsum = p.sum(-1, keepdims=True, dtype=np.float32)
    return _mm(p, v, split) / lsum, (m + np.log2(lsum))[..., 0]


def _model_backward(q, k, v, out, lse, g, scale, split=True):
    """(dq, dk, dv) as the fp32 one-pass kernel computes them: P = 2^(q k^T
    c - lse), dP - D with D = rowsum(dO O), dS = P (dP - D), the five
    products split, dQ summed on the fp32 plan (each warp's keys, the warps
    of a pass, the passes, the slices in order, in fp32) and scaled once."""
    b, h, s, d = q.shape
    c = np.float32(scale * tth.LOG2E)
    p = np.exp2(_mm(q, np.swapaxes(k, -1, -2), split) * c - lse[..., None])
    dsum = (g * out).sum(-1, keepdims=True, dtype=np.float32)
    ds = p * (_mm(g, np.swapaxes(v, -1, -2), split) - dsum)
    dv = _mm(np.swapaxes(p, -1, -2), g, split)
    dk = _mm(np.swapaxes(ds, -1, -2), q, split) * np.float32(scale)
    plan = tth.tinyhead_bwd_plan(b * h, s, 132, d, 4)
    owned = _plan_warp_keys(plan, s, 4)
    passes = plan.keys // (tth.BWD_WARP_KEYS[4] * plan.warps)
    dq = np.zeros_like(q)
    for sl in range(plan.slices):
        for pas in range(passes):
            for w in range(plan.warps):
                idx = list(owned[(sl, pas, w)])
                if idx:
                    dq += _mm(ds[..., idx], k[:, :, idx], split)
    return dq * np.float32(scale), dk, dv


@pytest.fixture(scope="module")
def jax_fp32():
    """{shape: (inputs, g, JAX interpret-mode fp32 output, the custom VJP's
    (dq, dk, dv))} at MODEL_SHAPES."""
    out = {}
    for i, shape in enumerate(MODEL_SHAPES):
        q, k, v = _qkv(shape, 40 + i)
        g = np.random.default_rng(50 + i).normal(size=shape).astype(np.float32)
        scale = 1.0 / math.sqrt(shape[-1])
        jq, jk, jv, jg = (jnp.asarray(t) for t in (q, k, v, g))
        fwd = np.asarray(jth.tinyhead_attention(jq, jk, jv, scale, 256, True))
        grads = [np.asarray(x) for x in jth._bwd(scale, 256, True, (jq, jk, jv), jg)]
        out[shape] = ((q, k, v), g, fwd, grads)
    return out


def _limit_ratio(got, want):
    """The largest |got - want| over the fp32 limit atol + rtol |want|."""
    return float((np.abs(got - want) / (MODEL_TOL[0] + MODEL_TOL[1] * np.abs(want))).max())


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_split_tf32_model_matches_jax_kernel_and_vjp(jax_fp32, shape):
    """The fp32 kernels' split-TF32 arithmetic, forward and one-pass backward
    with the plan's dQ sum, within (1e-5, 1e-4) of the JAX fp32 kernel
    (interpret mode) and its custom VJP; its lse within 1e-5 of the plain
    version's."""
    (q, k, v), g, fwd, grads = jax_fp32[shape]
    scale = 1.0 / math.sqrt(shape[-1])
    out, lse = _model_forward(q, k, v, scale)
    assert out.dtype == np.float32 and lse.dtype == np.float32
    np.testing.assert_allclose(out, fwd, atol=MODEL_TOL[0], rtol=MODEL_TOL[1])
    _, plain_lse = tth.tinyhead_forward_plain(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    np.testing.assert_allclose(lse, plain_lse.numpy(), atol=1e-5, rtol=1e-5)
    for got, want in zip(_model_backward(q, k, v, out, lse, g, scale), grads):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=MODEL_TOL[0], rtol=MODEL_TOL[1])


@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_one_tf32_product_exceeds_the_limit(jax_fp32, shape):
    """With one tf32 product where the kernels take three, the forward and
    the backward leave the same limit (several times over): phase 11's fp32
    limits tell split TF32 apart from TF32."""
    (q, k, v), g, fwd, grads = jax_fp32[shape]
    scale = 1.0 / math.sqrt(shape[-1])
    out, lse = _model_forward(q, k, v, scale, split=False)
    assert _limit_ratio(out, fwd) > 4
    got = _model_backward(q, k, v, out, lse, g, scale, split=False)
    assert max(_limit_ratio(a, w) for a, w in zip(got, grads)) > 4
    split = _model_forward(q, k, v, scale)[0]
    assert _limit_ratio(split, fwd) < 0.25


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
    """The CUDA kernels against their plain versions in fp32 on the same
    inputs on the card (TF32 off; bf16 inputs widened exactly). Forward: fp32
    within 1e-5 + 1e-4 |ref|; bf16 within chip_smoke.py's per-element limit,
    2^-8 of P|V| (P rounded to bf16) and of |ref| (the output rounded) plus
    the fp32 term. Backward, from the kernel's out and lse: dq, dk, dv
    against tinyhead_backward_plain in fp32 within the same terms of the
    magnitude of what each sums (chip_smoke.tinyhead_grad_mags)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = chip_smoke.BF16_U
    for shape in SHAPES + [(4, 16, 1024, 8)]:
        scale = 1.0 / math.sqrt(shape[-1])
        qkvg = [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            q, k, v, g = (t.to(dtype) for t in qkvg)
            wide = [t.float() for t in (q, k, v, g)]
            before = (tth.tinyhead_attention.launches, tth.tinyhead_attention_backward.launches)
            out, lse = tth.tinyhead_forward(q, k, v, scale)
            grads = tth.tinyhead_attention_backward(q, k, v, out, lse, g, scale)
            after = (tth.tinyhead_attention.launches, tth.tinyhead_attention_backward.launches)
            assert after == (before[0] + 1, before[1] + 1)
            ref, ref_lse = tth.tinyhead_forward_plain(*wide[:3], scale)
            plain = tth.tinyhead_backward_plain(*wide[:3], out.float(), lse, wide[3], scale)
            mags = [chip_smoke.tinyhead_out_mag(*wide[:3], scale),
                    *chip_smoke.tinyhead_grad_mags(*wide, scale)]
            torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
            for got, want, mag in zip((out, *grads), (ref, *plain), mags):
                assert got.dtype == dtype
                if bf16:
                    limit = 1e-5 + (u + 1e-4) * mag + u * want.abs()
                else:
                    limit = 1e-5 + 1e-4 * (mag if got is not out else want.abs())
                assert bool(((got.float() - want).abs() <= limit).all()), shape
