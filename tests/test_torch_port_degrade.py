"""The port's degrade ops (ops/degrade.py), for training and for sampling,
against the JAX package's (masked_diffusion_tpu/ops/degrade.py), on the same
numpy draws (uint32 bits, uniforms, pixel permutations), injected on both
sides.

NCHW in the port, NHWC in JAX. Masks must be bitwise equal; mean fills and
degraded images agree to atol 1e-6 (fp32 sums in another order; rtol 1e-6
too where a fill divides a large sum by a small count).
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


# ------------------------------------------------------- sampling-time ops


def _jax_uniform_fixture(u):
    """A stand-in for jax.random.uniform returning the fixed field u."""
    def uniform(key, shape, *a, **k):
        assert tuple(shape) == u.shape, (shape, u.shape)
        return jnp.asarray(u)
    return uniform


@pytest.mark.parametrize("channel", ["1-channel", "3-channel"])
@pytest.mark.parametrize("mean_option,mean_area", [
    ("degraded_area", "image-wise"), ("degraded_area", "channel-wise"),
    ("non_degraded_area", "image-wise"), (0.3, "image-wise"),
])
def test_degrade_dependent_base_sampling_matches_jax(monkeypatch, channel, mean_option,
                                                     mean_area):
    """Nested masks at t and t-1 from one injected uniform field (and
    nested_threshold_masks under it): masks bitwise, fills to 1e-6."""
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    c = C if channel == "3-channel" else 1
    u = rng.uniform(size=(B, H, W, c)).astype(np.float32)
    a_t = np.array([0.0, 1.0, 0.5, 0.7], np.float32)
    a_n = np.array([0.0, 0.6, 0.3, 0.7], np.float32)
    monkeypatch.setattr(jdeg.jax.random, "uniform", _jax_uniform_fixture(u))
    ref = [np.asarray(x) for x in jdeg.degrade_dependent_base_sampling(
        None, jnp.asarray(img), jnp.asarray(a_t), jnp.asarray(a_n), channel, mean_option,
        mean_area)]
    got = [_nhwc(x) for x in tdeg.degrade_dependent_base_sampling(
        _nchw(img), torch.from_numpy(a_t), torch.from_numpy(a_n), channel, mean_option,
        mean_area, uniforms=_nchw(u))]
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in (1, 4):
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0, err_msg=str(i))
    assert (got[4] >= got[1]).all()  # nested: kept at t stays kept at t-1 (a_n <= a_t)
    masks = tdeg.nested_threshold_masks(B, H, W, C, torch.from_numpy(a_t),
                                        torch.from_numpy(a_n), channel == "3-channel",
                                        uniforms=_nchw(u))
    ref_masks = jdeg.nested_threshold_masks(None, B, H, W, C, jnp.asarray(a_t),
                                            jnp.asarray(a_n), channel == "3-channel")
    for g, r in zip(masks, ref_masks):
        np.testing.assert_array_equal(_nhwc(g), np.asarray(r))


@pytest.mark.parametrize("select,channel", [
    ("indexing", "1-channel"), ("thresholding", "1-channel"), ("thresholding", "3-channel"),
])
@pytest.mark.parametrize("mean_option,mean_area", [
    ("degraded_area", "channel-wise"), ("non_degraded_area", "image-wise"), (0.1, "image-wise"),
])
def test_degrade_independent_base_sampling_and_with_mask_match_jax(monkeypatch, select, channel,
                                                                   mean_option, mean_area):
    """The binary mask (not training's degrade_mask), bitwise; then
    degrade_with_mask on that mask."""
    rng = np.random.default_rng(5)
    img = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    if select == "indexing":
        amount = np.array([0, 7, HW - 1, HW], np.int32)
        bits = rng.integers(0, 2**32, size=(B, HW), dtype=np.uint64)
        bits[1] &= 0xF0000000
        masks = np.asarray(jdeg.masks_from_uniforms(jnp.asarray(_composite_keys(bits)),
                                                    jnp.asarray(amount))).reshape(B, H, W, 1)
        kw = dict(bits=torch.from_numpy(bits.astype(np.int64)))
    else:
        amount = np.array([0.0, 1.0, 0.4, 0.8], np.float32)
        u = rng.uniform(size=(B, H, W, C if channel == "3-channel" else 1)).astype(np.float32)
        masks = (u > amount[:, None, None, None]).astype(np.float32)
        kw = dict(uniforms=_nchw(u))
    monkeypatch.setattr(jdeg, "generate_masks",
                        lambda *a, **k: jnp.broadcast_to(jnp.asarray(masks), img.shape))
    ref = [np.asarray(x) for x in jdeg.degrade_independent_base_sampling(
        None, jnp.asarray(img), jnp.asarray(amount), select, channel, mean_option, mean_area)]
    got = [_nhwc(x) for x in tdeg.degrade_independent_base_sampling(
        _nchw(img), torch.from_numpy(amount), select, channel, mean_option, mean_area, **kw)]
    np.testing.assert_array_equal(got[1], ref[1])
    assert set(np.unique(got[1])) <= {0.0, 1.0}
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
    ref_w = np.asarray(jdeg.degrade_with_mask(jnp.asarray(img), jnp.asarray(ref[1]),
                                              mean_option, mean_area))
    got_w = _nhwc(tdeg.degrade_with_mask(_nchw(img), _nchw(got[1]), mean_option, mean_area))
    np.testing.assert_allclose(got_w, ref_w, atol=1e-6, rtol=0)


def _permutations(rng, n=B):
    return np.stack([rng.permutation(HW) for _ in range(n)]).astype(np.int32)


@pytest.mark.parametrize("count", [0, 1, 23, HW - 1, HW])
@pytest.mark.parametrize("mean_option,mean_area", [
    ("degraded_area", "image-wise"), ("non_degraded_area", "image-wise"),
])
def test_degrade_index_sampling_matches_jax(count, mean_option, mean_area):
    """A ragged count per image: only count_t[0] counts, as in the reference.
    The fills agree to 1e-6 absolute and relative: at count 1 the
    'non_degraded_area' fill is a sum of 63 kept pixels over one, ~4 in
    magnitude, where fp32 sums in another order differ by a few ulp."""
    rng = np.random.default_rng(count)
    img = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    index = _permutations(rng)
    count_t = np.array([count, 3, 50, 11], np.int32)
    ref = [np.asarray(x) for x in jdeg.degrade_index_sampling(
        jnp.asarray(index), jnp.asarray(count_t), jnp.asarray(img), mean_option, mean_area)]
    got = [_nhwc(x) for x in tdeg.degrade_index_sampling(
        torch.from_numpy(index), torch.from_numpy(count_t), _nchw(img), mean_option,
        mean_area)]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal((1.0 - got[1][..., 0]).reshape(B, HW).sum(1), count)
    for g, r in ((got[0], ref[0]), (got[2], ref[2])):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mean_option", [0.25, "non_degraded_area"])
@pytest.mark.parametrize("start,end", [(0, 0), (5, 30), (20, HW), (HW, HW)])
def test_degrade_dependent_momentum_sampling_matches_jax(mean_option, start, end):
    rng = np.random.default_rng(start + end)
    x_t = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    x_0 = rng.uniform(-1, 1, size=(B, H, W, C)).astype(np.float32)
    index = _permutations(rng)
    ref = [np.asarray(x) for x in jdeg.degrade_dependent_momentum_sampling(
        jnp.asarray(x_t), jnp.asarray(x_0), jnp.asarray(index), start, end, mean_option)]
    got = [_nhwc(x) for x in tdeg.degrade_dependent_momentum_sampling(
        _nchw(x_t), _nchw(x_0), torch.from_numpy(index), torch.tensor(start), end,
        mean_option)]
    for name, g, r in zip(("noisy_img", "mean_masks", "mean_pixel"), got, ref):
        np.testing.assert_allclose(g, r, atol=1e-6, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("mean_option", ["degraded_area", "bogus"])
def test_degrade_dependent_momentum_sampling_refuses_other_means(mean_option):
    rng = np.random.default_rng(0)
    x = torch.zeros(B, C, H, W)
    index = torch.from_numpy(_permutations(rng))
    with pytest.raises(ValueError):
        jdeg.degrade_dependent_momentum_sampling(jnp.zeros((B, H, W, C)), jnp.zeros((B, H, W, C)),
                                                 jnp.asarray(index.numpy()), 1, 2, mean_option)
    with pytest.raises(ValueError):
        tdeg.degrade_dependent_momentum_sampling(x, x, index, 1, 2, mean_option)


def test_indexing_on_the_cpu_is_the_kernels_plain_version():
    """CPU tensors take exact_count_masks_plain on the generator's bits; no
    kernel launch is counted."""
    from masked_diffusion_tpu_torch.ops.kmask import exact_count_masks, exact_count_masks_plain

    img = torch.zeros(B, C, H, W)
    amount = torch.tensor([0.0, 9.0, 40.0, HW])
    launches = exact_count_masks.launches
    _, masks, _ = tdeg.degrade_independent_base_sampling(
        img, amount, "indexing", "1-channel", "degraded_area", "image-wise",
        generator=torch.Generator().manual_seed(3))
    bits = torch.randint(0, 2**32, (B, HW), generator=torch.Generator().manual_seed(3),
                         dtype=torch.int64)
    want = exact_count_masks_plain(bits, amount.to(torch.int32)).reshape(B, 1, H, W)
    torch.testing.assert_close(masks, want.expand(B, C, H, W), rtol=0, atol=0)
    assert exact_count_masks.launches == launches
