"""The exact-k kernels' algorithm, draws and launch plan, on the CPU.

csrc/exact_k.cuh selects the k-th smallest key by an 8-bit radix select
across a cluster of CTAs, with a gather finish once the selected bin is
small; ops/fused_degrade.py:radix_kth_threshold is its plain model, which
the plain versions of both kernels now run. These tests hold the model
equal to the JAX package's 32-pass scan (rowwise_kth_threshold) over tied
rows, every special k, ragged row lengths and every cluster size; the plain
Philox (philox4x32_10_first and the two counter layouts) against
Random123's published known-answer vectors and a transcription in Python
ints; and the launch plan (exact_k_plan) against the limits the C entry
points check. The kernels themselves run on the card (chip_smoke.py phases
2, 6, 12 and 18).
"""

import ctypes

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu_torch.ops import build
from masked_diffusion_tpu_torch.ops import fused_degrade as fd
from masked_diffusion_tpu_torch.ops import kmask
from masked_diffusion_tpu_torch.ops.shard import fold_seed
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan

M32 = 0xFFFFFFFF
H100_SMS = 132


# ---------------------------------------------------------------- Philox

# Random123's known-answer vectors for Philox4x32-10 (kat_vectors): counter,
# key, first output word
PHILOX_KAT = (
    ((0, 0, 0, 0), (0, 0), 0x6627E8D5),
    ((M32, M32, M32, M32), (M32, M32), 0x408F276D),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0), 0xD16CFE09),
)


def _philox_ints(c, k):
    """Philox4x32-10's first word in Python ints (csrc/exact_k.cuh)."""
    c0, c1, c2, c3 = c
    k0, k1 = k
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & M32, (p0 >> 32) ^ c3 ^ k1, p0 & M32
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c0


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    assert int(fd.philox4x32_10_first(*counter, *key)) == want
    assert _philox_ints(counter, key) == want


def test_philox_matches_python_ints_on_random_words():
    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, size=(6, 64), dtype=np.uint64).astype(np.int64)
    got = fd.philox4x32_10_first(*(torch.from_numpy(w) for w in words))
    want = [_philox_ints(tuple(int(w) for w in words[:4, j]), tuple(int(w) for w in words[4:, j]))
            for j in range(words.shape[1])]
    assert got.tolist() == want


@pytest.mark.parametrize("seed,offset", [(0, 0), (1234, 7), (2**63 + 5, 2**40 + 3),
                                         (-1, -2)])
def test_counter_layouts(seed, offset):
    """The fused kernel's draws at (pixel, image, (offset_hi << 1) | {0, 1},
    offset_lo) and the exact-k kernel's at (pixel, image, 0x80000000 |
    offset_hi, offset_lo), keyed by (seed_lo, seed_hi), both mod 2^64."""
    b, hw = 3, 10
    fused = fd.philox_fused_bits(seed, offset, b, hw)
    masks = fd.philox_kmask_bits(seed, offset, b, hw)
    assert fused.shape == (2, b, hw) and masks.shape == (b, hw)
    s, o = seed % 2**64, offset % 2**64
    key = (s & M32, s >> 32)
    for img, p in ((0, 0), (2, 9), (1, 4)):
        for tag in (0, 1):
            c2 = ((o >> 32) << 1 & M32) | tag
            assert int(fused[tag, img, p]) == _philox_ints((p, img, c2, o & M32), key)
        c2 = 0x80000000 | (o >> 32)
        assert int(masks[img, p]) == _philox_ints((p, img, c2, o & M32), key)
    assert not torch.equal(fused[0], fused[1]) and not torch.equal(fused[0], masks)


def test_philox_seed_is_two_draws_of_the_generator():
    seed, offset = kmask.philox_seed(torch.Generator().manual_seed(9))
    want = torch.randint(0, 2**62, (2,), generator=torch.Generator().manual_seed(9)).tolist()
    assert [seed, offset] == want


# ---------------------------------------------------------- radix select


def _row(data, n, kind):
    rng = np.random.default_rng(data)
    bits = rng.integers(0, 2**32, size=n, dtype=np.uint64)
    if kind == "tied_top":
        bits &= 0xE0000000  # 8 values of top bits
    elif kind == "tied_low":
        bits &= 0xFFFFF000  # ties below the first digits only
    elif kind == "all_equal":
        bits[:] = bits[0]
    elif kind == "few":
        bits = rng.choice(np.array([0, 1, 2**31, M32], np.uint64), size=n)
    return bits.astype(np.int64)


@settings(deadline=None, derandomize=True, max_examples=40)
@given(n=st.integers(1, 300), kind=st.sampled_from(["random", "tied_top", "tied_low",
                                                    "all_equal", "few"]),
       data=st.integers(0, 2**16), k_rand=st.integers(-5, 305),
       digit_bits=st.sampled_from([8, 11]), gather=st.sampled_from([0, 1, 64, 10**6]))
def _check_radix(slices, n, kind, data, k_rand, digit_bits, gather):
    bits = torch.from_numpy(np.stack([_row(data + i, n, kind) for i in range(7)]))
    k = torch.tensor([[-1], [0], [1], [n - 1], [n], [n + 3], [k_rand]])
    want = fd.rowwise_kth_threshold(bits, k)
    got = fd.radix_kth_threshold(bits, k, digit_bits=digit_bits, slices=slices, gather=gather)
    assert torch.equal(got, want), (bits, k, got, want)


@pytest.mark.parametrize("slices", [1, 2, 4, 8, 16])
def test_radix_select_equals_the_scan(slices):
    """radix_kth_threshold (the kernels' select, histograms summed over
    `slices` CTAs) gives rowwise_kth_threshold's threshold on every row."""
    _check_radix(slices)


@settings(deadline=None, derandomize=True, max_examples=25)
@given(n=st.integers(2, 4096), data=st.integers(0, 2**16), tied=st.booleans())
def test_exact_k_degrade_selects_exactly_k_as_jax_does(n, data, tied):
    rng = np.random.default_rng(data)
    bits = rng.integers(0, 2**32, size=(3, n), dtype=np.uint64).astype(np.uint32)
    if tied:
        bits &= np.uint32(0xE0000000)
    k = np.array([[0], [int(rng.integers(0, n + 1))], [n]], np.int32)
    got = fd.exact_k_degrade(torch.from_numpy(bits.astype(np.int64)), torch.from_numpy(k))
    want = np.asarray(jfd.exact_k_degrade(bits, k))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(1), k[:, 0])


def test_plain_path_runs_the_radix_select(monkeypatch):
    calls = []

    def spy(keys, k, *args, **kw):
        calls.append(keys.shape)
        return fd.rowwise_kth_threshold(keys, k)

    monkeypatch.setattr(fd, "radix_kth_threshold", spy)
    bits = torch.randint(0, 2**32, (2, 64), generator=torch.Generator().manual_seed(0))
    kmask.exact_count_masks_plain(bits, torch.tensor([3, 60]))
    assert calls == [(2, 64)]


# ------------------------------------------------------------ launch plan

# (batch, hw) -> the plan on 132 SMs: the smoke check's branch shapes
PLANS_ON_H100 = {
    (1, 64 * 64): fd.ExactKPlan(4, 256, 4, True),
    (16, 64 * 64): fd.ExactKPlan(4, 256, 4, True),
    (32, 64 * 64): fd.ExactKPlan(2, 512, 4, True),
    (64, 64 * 64): fd.ExactKPlan(1, 512, 8, True),
    (8, 160 * 160): fd.ExactKPlan(8, 416, 8, True),
    (8, 256 * 256): fd.ExactKPlan(8, 512, 16, True),
    (1, 256 * 256): fd.ExactKPlan(16, 512, 8, True),
    (1, 45 * 45): fd.ExactKPlan(1, 512, 4, False),
    (1, 5 * 7): fd.ExactKPlan(1, 64, 1, False),
}


@pytest.mark.parametrize("batch,hw", sorted(PLANS_ON_H100))
def test_plan_at_the_branch_shapes(batch, hw):
    plan = fd.exact_k_plan(batch, hw, H100_SMS)
    assert plan == PLANS_ON_H100[(batch, hw)]
    assert fd.exact_k_plan_ok(plan, batch, hw)


def test_branch_shapes_reach_every_cluster_size_and_both_paths():
    plans = list(PLANS_ON_H100.values())
    assert {p.cs for p in plans} == set(fd.EXACT_K_CLUSTER_SIZES)
    assert {p.vec for p in plans} == {True, False}


@pytest.mark.parametrize("sms", [8, 66, 114, 132, 264])
def test_plan_fits_registers_and_is_taken_at_every_size(sms):
    for hw in (1, 2, 3, 16, 35, 1000, 2025, 4096, 25600, 16384 + 4, fd.MAX_HW):
        for batch in (1, 3, 8, 64, 300):
            plan = fd.exact_k_plan(batch, hw, sms)
            assert plan.per_thread <= fd.EXACT_K_MAX_PER_THREAD
            assert plan.threads <= fd.EXACT_K_MAX_THREADS
            assert fd.exact_k_plan_ok(plan, batch, hw), (batch, hw, sms, plan)
            assert plan.vec == (hw % 4 == 0)


def test_plan_respects_the_sm_count():
    """More SMs, or fewer images, never take fewer CTAs an image; at the
    largest size the slice still fits in registers (16 a thread)."""
    for hw in (4096, 25600, fd.MAX_HW):
        for batch in (1, 8, 16, 64):
            by_sms = [fd.exact_k_plan(batch, hw, sms).cs for sms in (16, 66, 132, 264)]
            assert by_sms == sorted(by_sms)
            by_batch = [fd.exact_k_plan(b, hw, 132).cs for b in (batch, 2 * batch, 4 * batch)]
            assert by_batch == sorted(by_batch, reverse=True)
    big = fd.exact_k_plan(1000, fd.MAX_HW, 132)
    assert big.cs * big.threads * big.per_thread >= fd.MAX_HW and big.per_thread == 16


def test_ragged_or_unaligned_rows_take_single_pixels():
    assert not fd.exact_k_plan(4, 45 * 45, H100_SMS).vec
    assert not fd.exact_k_plan(4, 4096, H100_SMS, aligned=False).vec
    plan = fd.exact_k_plan(4, 4096, H100_SMS, aligned=False)
    assert fd.exact_k_plan_ok(plan, 4, 4096)


@pytest.mark.parametrize("plan,batch,hw", [
    (fd.ExactKPlan(3, 256, 4, True), 4, 4096),    # cluster size not a power of 2
    (fd.ExactKPlan(32, 64, 4, True), 4, 4096),    # above 16 CTAs
    (fd.ExactKPlan(2, 48, 4, True), 4, 4096),     # not whole warps
    (fd.ExactKPlan(2, 1024, 4, True), 4, 4096),   # above 512 threads
    (fd.ExactKPlan(2, 512, 32, True), 4, 4096),   # above 16 pixels a thread
    (fd.ExactKPlan(2, 512, 3, False), 4, 4096),   # pixels a thread not a power of 2
    (fd.ExactKPlan(2, 256, 4, True), 4, 4096),    # threads short of the slice
    (fd.ExactKPlan(1, 512, 4, True), 1, 2025),    # float4 groups on a ragged row
    (fd.ExactKPlan(1, 512, 2, True), 1, 1024),    # a thread holding half a group
    (fd.ExactKPlan(1, 64, 1, False), 0, 35),      # no images
    (fd.ExactKPlan(16, 512, 16, True), 1, fd.MAX_HW + 4),  # above 256x256
])
def test_plans_the_kernels_refuse(plan, batch, hw):
    assert not fd.exact_k_plan_ok(plan, batch, hw)


def test_plan_rejects_sizes_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        fd.exact_k_plan(0, 4096, H100_SMS)
    with pytest.raises(ValueError):
        fd.exact_k_plan(1, fd.MAX_HW + 1, H100_SMS)


def test_plan_slices_cover_the_image():
    for hw in (35, 2025, 4096, 25600, fd.MAX_HW):
        for cs in fd.EXACT_K_CLUSTER_SIZES:
            for vec in ((False, True) if hw % 4 == 0 else (False,)):
                slice_ = fd.exact_k_slice(hw, cs, vec)
                assert cs * slice_ >= hw and (not vec or slice_ % 4 == 0)
                plan = fd.exact_k_plan_at(hw, cs, vec)
                fits = slice_ <= fd.EXACT_K_MAX_THREADS * fd.EXACT_K_MAX_PER_THREAD
                assert fd.exact_k_plan_ok(plan, 1, hw) == fits
                assert plan.threads * plan.per_thread >= slice_


# --------------------------------------------------------------- wrappers


class _FakeLib:
    """Records the ctypes declarations made on it."""

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_entry_points_take_a_plan_and_no_key_scratch():
    lib = _FakeLib()
    build.declare_exact_k(lib)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    plan = [i32] * 4
    # xt, x0, amount_t, amount_next, bits, out, mask_next, stream: no scratch
    assert lib.mdt_fused_degrade.argtypes.count(vp) == 8
    assert lib.mdt_fused_degrade.argtypes[-5:] == plan + [vp]
    # counts, bits, out, stream
    assert lib.mdt_kmask.argtypes.count(vp) == 4
    assert lib.mdt_kmask.argtypes[-5:] == plan + [vp]
    assert not hasattr(fd, "REGISTER_HW") and not hasattr(kmask, "REGISTER_HW")


def test_cpu_path_builds_and_launches_nothing(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(build, "load_library", refuse)
    before = (fd.fused_degrade_update.launches, kmask.exact_count_masks.launches,
              fd.fused_degrade_update_sharded.launches,
              kmask.exact_count_masks_sharded.launches)
    x = torch.randn(4, 3, 8, 8)
    a = torch.tensor([0.0, 10.0, 33.0, 64.0])
    fd.fused_degrade_update(x, x, a, a, select="indexing", mean_mode="degraded_area", seed=1)
    fd.fused_degrade_update_sharded(x[2:], x[2:], a[2:], a[2:], plan=MeshPlan(x.device, 2, 1),
                                    batch=4, select="indexing", mean_mode="degraded_area",
                                    seed=1)
    counts = a.to(torch.int32)
    kmask.exact_count_masks(4, 8, 8, counts, generator=torch.Generator().manual_seed(0))
    kmask.exact_count_masks_sharded(4, 8, 8, counts[:2], plan=MeshPlan(x.device, 2, 0),
                                    generator=torch.Generator().manual_seed(0))
    after = (fd.fused_degrade_update.launches, kmask.exact_count_masks.launches,
             fd.fused_degrade_update_sharded.launches,
             kmask.exact_count_masks_sharded.launches)
    assert after == before


def test_plain_philox_route_matches_its_rank_fold():
    """The plain version fed philox_fused_bits at a rank's folded seed is
    what the smoke check holds each rank's kernel launch against; ranks get
    different draws, rank 0 the shared seed's."""
    seed = 4242
    assert fold_seed(seed, 0) == seed
    r0 = fd.philox_fused_bits(fold_seed(seed, 0), 5, 2, 64)
    r1 = fd.philox_fused_bits(fold_seed(seed, 1), 5, 2, 64)
    assert torch.equal(r0, fd.philox_fused_bits(seed, 5, 2, 64))
    assert not torch.equal(r0, r1)
