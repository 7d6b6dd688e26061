"""The port's plain fused degrade against the JAX row math, on identical bits.

masked_diffusion_tpu/ops/pallas/fused_degrade.py:fused_rows (the math of the
TPU kernel) and the port's fused_rows (the plain version of the CUDA kernel)
get the same numpy uint32 bits, images and amounts: masks must be bitwise
equal and outputs within 1e-6. The cases include tied top bits, k = 0 and
k = HW. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu_torch.ops import fused_degrade as tfd

R, H, W = 8, 8, 8
HW = H * W


def _bits(seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(R, HW), dtype=np.uint64).astype(np.uint32)
    bits[4:] &= np.uint32(0xE0000000)  # 8 distinct top-bit values: heavy ties
    bits[6] = np.uint32(1 << 31)  # an all-tied row
    return bits


def _amounts(select, seed):
    rng = np.random.default_rng(seed)
    if select == "indexing":
        a = rng.integers(0, HW + 1, size=R).astype(np.float32)
        a[0], a[1], a[4], a[6] = 0, HW, HW // 3, HW // 2  # k = 0, k = HW, tied rows
    else:
        a = rng.uniform(0, 1, size=R).astype(np.float32)
        a[0], a[1] = 0.0, 1.0
    return a[:, None]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("mean_mode,mean_value", [("const", 0.25), ("degraded_area", 0.0)])
@pytest.mark.parametrize("rule", ["base_momentum", "base_sampling"])
@pytest.mark.parametrize("select", ["thresholding", "indexing"])
def test_plain_fused_rows_match_jax(select, rule, mean_mode, mean_value, c):
    bt, bn = _bits(1), _bits(2)
    rng = np.random.default_rng(3)
    xt = rng.normal(size=(R, c * HW)).astype(np.float32)
    x0 = rng.normal(size=(R, c * HW)).astype(np.float32)
    at, an = _amounts(select, 4), _amounts(select, 5)
    kw = dict(channels=c, select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule)
    j_out, j_mask = jfd.fused_rows(
        jnp.asarray(bt), jnp.asarray(bn), jnp.asarray(xt), jnp.asarray(x0),
        jnp.asarray(at), jnp.asarray(an), **kw,
    )
    t_out, t_mask = tfd.fused_rows(
        torch.from_numpy(bt.astype(np.int64)), torch.from_numpy(bn.astype(np.int64)),
        torch.from_numpy(xt), torch.from_numpy(x0), torch.from_numpy(at),
        torch.from_numpy(an), **kw,
    )
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-6, rtol=0)
    if select == "indexing":
        np.testing.assert_array_equal((1 - t_mask.numpy()).sum(1), an[:, 0])


def test_exact_k_under_ties_matches_jax():
    bits = _bits(9)
    k = np.asarray([[0], [1], [7], [13], [32], [HW - 1], [HW], [HW // 2]], np.int32)
    j = np.asarray(jfd.exact_k_degrade(jnp.asarray(bits), jnp.asarray(k)))
    t = tfd.exact_k_degrade(torch.from_numpy(bits.astype(np.int64)), torch.from_numpy(k))
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy().sum(1), k[:, 0])


def _wrapper_inputs(select, b=3, c=3, h=8, w=8, seed=0):
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(size=(b, c, h, w)).astype(np.float32))
    if select == "indexing":
        a = torch.tensor([0.0, 20.0, float(h * w)])[:b]
    else:
        a = torch.tensor([0.0, 0.4, 1.0])[:b]
    bits = torch.from_numpy(
        rng.integers(0, 2**32, size=(2, b, h * w), dtype=np.uint64).astype(np.int64)
    )
    return xt, x0, a, bits


@pytest.mark.parametrize("select", ["thresholding", "indexing"])
def test_wrapper_on_cpu_runs_the_plain_version_and_launches_nothing(select):
    xt, x0, a, bits = _wrapper_inputs(select)
    b, c, h, w = xt.shape
    before = tfd.fused_degrade_update.launches
    out, mask = tfd.fused_degrade_update(
        xt, x0, a, a.flip(0), select=select, mean_mode="degraded_area", bits=bits,
    )
    assert tfd.fused_degrade_update.launches == before
    ref_out, ref_mask = tfd.fused_rows(
        bits[0], bits[1], xt.reshape(b, -1), x0.reshape(b, -1), a[:, None],
        a.flip(0)[:, None], channels=c, select=select, mean_mode="degraded_area",
        mean_value=0.0, rule="base_momentum",
    )
    assert out.shape == (b, c, h, w) and mask.shape == (b, 1, h, w)
    torch.testing.assert_close(out.reshape(b, -1), ref_out, rtol=0, atol=0)
    torch.testing.assert_close(mask.reshape(b, -1), ref_mask, rtol=0, atol=0)
    # without bits: drawn from (seed, offset), deterministic, exact k
    o1, m1 = tfd.fused_degrade_update(xt, x0, a, a, select=select,
                                      mean_mode="degraded_area", seed=3, offset=1)
    o2, m2 = tfd.fused_degrade_update(xt, x0, a, a, select=select,
                                      mean_mode="degraded_area", seed=3, offset=1)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    if select == "indexing":
        np.testing.assert_array_equal((1 - m1).sum((1, 2, 3)).numpy(), a.numpy())


def test_wrapper_rejects_wrong_dtype_and_shape():
    xt, x0, a, bits = _wrapper_inputs("thresholding")
    kw = dict(select="thresholding", mean_mode="degraded_area")
    with pytest.raises(TypeError):
        tfd.fused_degrade_update(xt.double(), x0.double(), a, a, **kw)
    with pytest.raises(TypeError):
        tfd.fused_degrade_update(xt, x0, a.double(), a, **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt, x0[:2], a, a, **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt, x0, a[:2], a, **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt.reshape(3, 3, 64), x0.reshape(3, 3, 64), a, a, **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt, x0, a, a, bits=bits.int(), **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt, x0, a, a, bits=bits[:, :2], **kw)
    with pytest.raises(ValueError):
        tfd.fused_degrade_update(xt, x0, a, a, select="bogus", mean_mode="degraded_area")


def test_uint32_bits_reach_the_kernel_as_the_same_bit_patterns():
    bits = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    as32 = tfd.uint32_to_int32(bits)
    assert as32.dtype == torch.int32
    np.testing.assert_array_equal(
        as32.numpy().view(np.uint32), bits.numpy().astype(np.uint32)
    )


@pytest.mark.parametrize("select", ["thresholding", "indexing"])
def test_plain_fused_rows_match_jax_at_256(select):
    """At 256x256x3 (the zoo's largest size, above the kernel's register
    path), B=2, with injected bits: masks bitwise equal, outputs within 1e-6."""
    b, hw, c = 2, 256 * 256, 3
    rng = np.random.default_rng(11)
    bt, bn = (rng.integers(0, 2**32, size=(b, hw), dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    bt[1] &= np.uint32(0xE0000000)  # heavy ties
    xt, x0 = (rng.normal(size=(b, c * hw)).astype(np.float32) for _ in range(2))
    if select == "indexing":
        at, an = np.array([[hw // 3], [hw - 1]], np.float32), np.array([[1], [hw // 2]], np.float32)
    else:
        at, an = np.array([[0.3], [0.9]], np.float32), np.array([[0.0], [0.55]], np.float32)
    kw = dict(channels=c, select=select, mean_mode="degraded_area", mean_value=0.0,
              rule="base_momentum")
    j_out, j_mask = jfd.fused_rows(jnp.asarray(bt), jnp.asarray(bn), jnp.asarray(xt),
                                   jnp.asarray(x0), jnp.asarray(at), jnp.asarray(an), **kw)
    t_out, t_mask = tfd.fused_rows(
        torch.from_numpy(bt.astype(np.int64)), torch.from_numpy(bn.astype(np.int64)),
        torch.from_numpy(xt), torch.from_numpy(x0), torch.from_numpy(at), torch.from_numpy(an),
        **kw,
    )
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=1e-6, rtol=0)
    if select == "indexing":
        np.testing.assert_array_equal((1 - t_mask.numpy()).sum(1), an[:, 0])

