"""The port's training degrade ops (ops/degrade.py) against the JAX package's
(masked_diffusion_tpu/ops/degrade.py), on the same numpy draws.

NCHW in the port, NHWC in JAX. Masks must be bitwise equal; mean fills and
degraded images agree to atol 1e-6 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu_torch.ops import degrade as tdeg

B, H, W, C = 4, 8, 8, 3
HW = H * W


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _composite_keys(bits):
    s = np.uint64((HW - 1).bit_length())
    return ((bits >> s) << s | np.arange(HW, dtype=np.uint64)).astype(np.uint32)


def test_masks_from_uniforms_bitwise_with_ties():
    """Indexing masks of generate_masks (explicit bits, ties in the top bits)
    against JAX masks_from_uniforms on the same composite keys: one exact-k
    law, ties broken by pixel index, broadcast over channels."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=(6, HW), dtype=np.uint64)
    bits[1] &= 0xE0000000  # 8 values of top bits: ties everywhere
    bits[2] = 0  # all tied
    counts = np.array([0, 17, 40, HW, HW - 1, 1], np.int32)
    keys = _composite_keys(bits)
    ref = np.asarray(jdeg.masks_from_uniforms(jnp.asarray(keys), jnp.asarray(counts)))
    img = torch.zeros(6, C, H, W)
    got = tdeg.generate_masks(img, torch.from_numpy(counts), "indexing", "1-channel",
                              bits=torch.from_numpy(bits.astype(np.int64)))
    assert got.shape == (6, C, H, W)
    for ch in range(C):
        np.testing.assert_array_equal(got[:, ch].reshape(6, HW).numpy(), ref)
    np.testing.assert_array_equal((1.0 - ref).sum(1), counts)


def _masks(kind, rng):
    if kind == "1-channel":
        m = (rng.uniform(size=(B, H, W, 1)) > 0.4).astype(np.float32)
        m = np.broadcast_to(m, (B, H, W, C)).copy()
    else:
        m = (rng.uniform(size=(B, H, W, C)) > 0.4).astype(np.float32)
    m[0] = 1.0  # nothing degraded: the zero-count guard
    m[1] = 0.0  # everything degraded
    return m


@pytest.mark.parametrize("kind", ["1-channel", "3-channel"])
@pytest.mark.parametrize("mean_option,mean_area", [
    (0.25, "image-wise"), ("0", "image-wise"),
    ("degraded_area", "image-wise"), ("degraded_area", "channel-wise"),
    ("non_degraded_area", "image-wise"),
])
def test_compute_mean_pixel_matches_jax(kind, mean_option, mean_area):
    rng = np.random.default_rng(1)
    img = rng.normal(size=(B, H, W, C)).astype(np.float32)
    m = _masks(kind, rng)
    ref = np.asarray(jdeg.compute_mean_pixel(jnp.asarray(img), jnp.asarray(m),
                                             mean_option, mean_area))
    got = tdeg.compute_mean_pixel(_nchw(img), _nchw(m), mean_option, mean_area)
    ref = np.broadcast_to(ref, (B, 1, 1, C))
    np.testing.assert_allclose(np.broadcast_to(_nhwc(got), (B, 1, 1, C)), ref, atol=1e-6, rtol=0)


def test_threshold_masks_shapes_and_law():
    rng = np.random.default_rng(2)
    ratios = torch.tensor([0.0, 1.0, 0.3, 0.7])
    for per_channel, c in ((False, 1), (True, C)):
        u = torch.from_numpy(rng.uniform(size=(B, c, H, W)).astype(np.float32))
        m = tdeg.threshold_masks(B, H, W, C, ratios, per_channel, uniforms=u)
        assert m.shape == (B, c, H, W)
        torch.testing.assert_close(m, (u > ratios[:, None, None, None]).float(), rtol=0, atol=0)
    drawn = tdeg.threshold_masks(B, H, W, C, ratios, True, generator=torch.Generator().manual_seed(0))
    assert drawn.shape == (B, C, H, W) and bool(drawn[0].all()) and not bool(drawn[1].any())
    with pytest.raises(ValueError, match="uniforms must have shape"):
        tdeg.threshold_masks(B, H, W, C, ratios, True, uniforms=torch.zeros(B, 1, H, W))


@pytest.mark.parametrize("select,channel", [
    ("indexing", "1-channel"), ("thresholding", "1-channel"), ("thresholding", "3-channel"),
])
@pytest.mark.parametrize("mean_option,mean_area", [
    ("degraded_area", "image-wise"), ("degraded_area", "channel-wise"),
    ("non_degraded_area", "image-wise"), (0.1, "image-wise"),
])
def test_degrade_training_matches_jax_on_injected_masks(monkeypatch, select, channel,
                                                        mean_option, mean_area):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    if select == "indexing":
        amount = np.array([0, 5, HW - 1, HW], np.int32)
        bits = rng.integers(0, 2**32, size=(B, HW), dtype=np.uint64)
        bits[2] &= 0xF0000000  # tied top bits
        keys = _composite_keys(bits)
        masks = np.asarray(jdeg.masks_from_uniforms(jnp.asarray(keys), jnp.asarray(amount)))
        masks = masks.reshape(B, H, W, 1)
        kw = dict(bits=torch.from_numpy(bits.astype(np.int64)))
    else:
        amount = np.array([0.0, 1.0, 0.3, 0.6], np.float32)
        c = C if channel == "3-channel" else 1
        u = rng.uniform(size=(B, H, W, c)).astype(np.float32)
        masks = (u > amount[:, None, None, None]).astype(np.float32)
        kw = dict(uniforms=_nchw(u))
    monkeypatch.setattr(jdeg, "generate_masks",
                        lambda *a, **k: jnp.broadcast_to(jnp.asarray(masks), img.shape))
    ref = [np.asarray(x) for x in jdeg.degrade_training(
        None, jnp.asarray(img), jnp.asarray(amount), select, channel, mean_option, mean_area)]
    got = [_nhwc(x) for x in tdeg.degrade_training(
        _nchw(img), torch.from_numpy(amount), select, channel, mean_option, mean_area, **kw)]
    np.testing.assert_array_equal(got[1], ref[1])  # masks
    for name, g, r in zip(("degrade_img", "degrade_mask", "mean_mask"),
                          (got[0], got[2], got[3]), (ref[0], ref[2], ref[3])):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=name)


def test_unknown_modes_raise():
    img = torch.zeros(B, C, H, W)
    with pytest.raises(ValueError):
        tdeg.generate_masks(img, torch.zeros(B), "bogus", "1-channel")
    with pytest.raises(ValueError):
        tdeg.compute_mean_pixel(img, img, "degraded_area", "bogus")
    with pytest.raises(ValueError):
        tdeg.compute_mean_pixel(img, img, "bogus", "image-wise")
