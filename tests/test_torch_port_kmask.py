"""The exact-k mask kernel's plain version (ops/kmask.py) against the JAX
package, and its wrapper on the CPU.

The plain version must select exactly what the TPU kernel's threshold
search (masked_diffusion_tpu/ops/pallas/kmask.py:greedy_kth_threshold)
selects on the same composite keys, and what masks_from_uniforms
(ops/degrade.py) selects where the draws are distinct: bitwise equal masks.
The CUDA kernel itself runs only on the card (chip_smoke.py phase 6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops.degrade import masks_from_uniforms
from masked_diffusion_tpu.ops.pallas.kmask import greedy_kth_threshold
from masked_diffusion_tpu_torch.ops import kmask

H = W = 16
HW = H * W
LANE_BITS = (HW - 1).bit_length()


def _bits(rng, b):
    bits = rng.integers(0, 2**32, size=(b, HW), dtype=np.uint64)
    bits[1] &= 0xE0000000  # 8 values of top bits: heavy ties
    bits[2] &= 0xFF000000
    return bits


def _keys(bits):
    s = np.uint64(LANE_BITS)
    return ((bits >> s) << s | np.arange(HW, dtype=np.uint64)).astype(np.uint32)


def test_plain_matches_greedy_kth_threshold_on_composite_keys():
    rng = np.random.default_rng(0)
    bits = _bits(rng, 8)
    counts = np.array([0, 1, HW - 1, HW, 7, 100, 200, 128], np.int32)
    keys = _keys(bits)
    assert (keys != 0xFFFFFFFF).all()  # so (key < T) also covers k = HW
    thr = jax.vmap(greedy_kth_threshold)(jnp.asarray(keys), jnp.asarray(counts))
    ref = np.where(keys < np.asarray(thr)[:, None], 0.0, 1.0).astype(np.float32)
    got = kmask.exact_count_masks_plain(torch.from_numpy(bits.astype(np.int64)),
                                        torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal((1.0 - got).sum(1), counts)


def test_plain_matches_masks_from_uniforms_on_distinct_draws():
    rng = np.random.default_rng(1)
    perm = np.stack([rng.permutation(HW) for _ in range(6)])
    u = (perm / HW).astype(np.float32)  # distinct, exact in fp32
    bits = (perm.astype(np.uint64) << np.uint64(32 - LANE_BITS)).astype(np.int64)
    counts = np.array([0, 1, 31, HW - 1, HW, 100], np.int32)
    ref = np.asarray(masks_from_uniforms(jnp.asarray(u), jnp.asarray(counts)))
    got = kmask.exact_count_masks_plain(torch.from_numpy(bits), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_cpu_wrapper_exact_counts_and_no_launch():
    rng = np.random.default_rng(2)
    bits = torch.from_numpy(_bits(rng, 6).astype(np.int64))
    counts = torch.tensor([0, 1, HW - 1, HW, -3, HW + 5], dtype=torch.int32)
    before = kmask.exact_count_masks.launches
    m = kmask.exact_count_masks(6, H, W, counts, bits=bits)
    assert m.shape == (6, 1, H, W) and m.dtype == torch.float32
    zeros = (1.0 - m).reshape(6, HW).sum(1).long().tolist()
    assert zeros == [0, 1, HW - 1, HW, 0, HW]
    drawn = kmask.exact_count_masks(6, H, W, counts, generator=torch.Generator().manual_seed(0))
    assert (1.0 - drawn).reshape(6, HW).sum(1).long().tolist() == zeros
    again = kmask.exact_count_masks(6, H, W, counts, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(drawn, again, rtol=0, atol=0)
    assert kmask.exact_count_masks.launches == before


def test_wrapper_raises_on_bad_input():
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="bound"):
        kmask.exact_count_masks(2, 257, 256, counts)  # one row past 256x256
    with pytest.raises(TypeError, match="counts"):
        kmask.exact_count_masks(2, H, W, counts.float())
    with pytest.raises(TypeError, match="counts"):
        kmask.exact_count_masks(3, H, W, counts)
    with pytest.raises(TypeError, match="bits"):
        kmask.exact_count_masks(2, H, W, counts, bits=torch.zeros(2, HW, dtype=torch.int32))


def test_plain_matches_masks_from_uniforms_at_256():
    """256x256, B=2 (the zoo's largest size): the plain version's masks
    equal masks_from_uniforms bitwise on distinct injected draws."""
    hw = 256 * 256
    lane_bits = (hw - 1).bit_length()
    rng = np.random.default_rng(4)
    perm = np.stack([rng.permutation(hw) for _ in range(2)])
    u = (perm / hw).astype(np.float32)  # distinct, exact in fp32
    bits = (perm.astype(np.uint64) << np.uint64(32 - lane_bits)).astype(np.int64)
    counts = np.array([hw // 3, hw - 1], np.int32)
    ref = np.asarray(masks_from_uniforms(jnp.asarray(u), jnp.asarray(counts)))
    got = kmask.exact_count_masks_plain(torch.from_numpy(bits), torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal((1.0 - got).sum(1), counts)
