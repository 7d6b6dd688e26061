"""Fused degrade + update for the reverse loop: the CUDA kernel, its launch
plan and its plain PyTorch version.

Counterpart of masked_diffusion_tpu/ops/pallas/fused_degrade.py. The kernel
is csrc/fused_degrade.cu (its header says what it computes and what bounds
it; csrc/exact_k.cuh has the layout and the select it shares with
csrc/kmask.cu). Each image is served by a cluster of `cs` CTAs, each
holding a contiguous slice of the image's pixels in registers (at most 16 a
thread, at every H*W up to 256 * 256); an 8-bit radix select over
histograms summed across the cluster finds the k-th smallest key in 4
rounds. `exact_k_plan` is the launch plan both exact-k kernels take, a pure
host function the wrappers use and the CPU tests hold.

The plain version transliterates the JAX row math with the JAX row
signature, so the tests compare the two packages on identical bits, and
selects with the kernels' own algorithm:

  rowwise_kth_threshold  greedy MSB-first scan, max T with count(< T) <= k
                         (the JAX package's; the tests' reference)
  radix_kth_threshold    the kernels' radix select: the same threshold
  exact_k_degrade        exactly k degraded pixels via lane-index keys
  fused_rows             masks, masked means, fills and the update rule

`philox4x32_10_first` and the two counter layouts (`philox_fused_bits`,
`philox_kmask_bits`) are the kernels' draws in tensor ops, so the Philox
route is checked bit for bit. Random bits are uint32 values carried in int64
tensors (PyTorch's uint32 lacks shifts and comparisons on the CPU).

`fused_degrade_update` is the wrapper the sampling loop calls. For CPU
tensors it runs the plain version; for CUDA tensors it launches the kernel
or raises. It never falls back from one to the other.
`fused_degrade_update_sharded` is its data-parallel form (one launch per
rank on its rows, the seed folded with the rank: ops/shard.py), through
which the sampling loop reaches it, with a 1-rank plan in one process.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from masked_diffusion_tpu_torch.ops import build
from masked_diffusion_tpu_torch.ops.shard import data_parallel_kernel

#: Largest H*W the kernels take (256 * 256).
MAX_HW = 256 * 256
#: The exact-k plan's limits (csrc/exact_k.cuh): threads a CTA, pixels a
#: thread (registers), CTAs an image (16 is above the portable cluster size).
EXACT_K_MAX_THREADS = 512
EXACT_K_MAX_PER_THREAD = 16
EXACT_K_CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: pixels a CTA owns, at least, once an image has more than one CTA, and the
#: share of the SMs the CTAs of a launch reach before an image takes no more
#: of them: more, smaller CTAs each pay the select's cluster barriers and
#: DSMEM sums (tools/exact_k_variants.py: at 64x64 batch 16, 4 CTAs an image
#: beat 8, and at batch 64 the kernels are fastest at 64-128 CTAs)
EXACT_K_MIN_SLICE = 1024
EXACT_K_SM_SHARE = 4
#: bits of the radix select's digit (4 rounds)
DIGIT_BITS = 8
#: keys at most in the selected bin for the select's gather finish
GATHER_MAX = 64

_SELECT = {"thresholding": 0, "indexing": 1}
_MEAN_MODE = {"const": 0, "degraded_area": 1}
_RULE = {"base_momentum": 0, "base_sampling": 1}
_U32 = 0xFFFFFFFF


class ExactKPlan(NamedTuple):
    cs: int  # CTAs an image: the cluster size (1: no cluster)
    threads: int  # threads a CTA
    per_thread: int  # pixels a thread holds in registers
    vec: bool  # groups of 4 pixels moved as float4; False: the ragged path


def exact_k_slice(hw: int, cs: int, vec: bool) -> int:
    """Pixels of an image each of its cs CTAs owns: ceil(hw / cs), rounded up
    to a group of 4 on the vector path."""
    v = 4 if vec else 1
    return -(-(-(-hw // cs)) // v) * v


def exact_k_plan(batch: int, hw: int, sms: int, aligned: bool = True) -> ExactKPlan:
    """The launch plan of the exact-k kernels (csrc/fused_degrade.cu,
    csrc/kmask.cu) for `batch` images of hw pixels on a card of `sms` SMs.

    cs: the smallest cluster size whose slice fits in registers (512 threads
    of 16 pixels) and for which batch * cs reaches a quarter of the SM count
    (EXACT_K_SM_SHARE), not split below EXACT_K_MIN_SLICE pixels a CTA nor
    above 16 CTAs; then exact_k_plan_at that size. The vector path needs
    hw % 4 == 0 and 16-byte aligned rows (`aligned`)."""
    if batch <= 0 or not 0 < hw <= MAX_HW:
        raise ValueError(f"exact_k_plan: batch {batch}, {hw} pixels (at most {MAX_HW})")
    vec = aligned and hw % 4 == 0
    reach = EXACT_K_MAX_THREADS * EXACT_K_MAX_PER_THREAD
    cs = None
    for k in EXACT_K_CLUSTER_SIZES:
        if exact_k_slice(hw, k, vec) > reach:
            continue
        cs = k
        if (batch * k * EXACT_K_SM_SHARE >= sms or k == EXACT_K_CLUSTER_SIZES[-1]
                or exact_k_slice(hw, 2 * k, vec) < EXACT_K_MIN_SLICE):
            break
    return exact_k_plan_at(hw, cs, vec)


def exact_k_plan_at(hw: int, cs: int, vec: bool) -> ExactKPlan:
    """The plan at a given cluster size: the fewest pixels a thread (a power
    of 2, at least a group of 4 on the vector path) that 512 threads cover
    the slice with, and whole warps to hold it."""
    slice_ = exact_k_slice(hw, cs, vec)
    per = next((p for p in (1, 2, 4, 8, 16)
                if p >= (4 if vec else 1) and p * EXACT_K_MAX_THREADS >= slice_),
               EXACT_K_MAX_PER_THREAD)
    threads = -(-(-(-slice_ // per)) // 32) * 32
    return ExactKPlan(cs, threads, per, vec)


def exact_k_plan_ok(plan: ExactKPlan, batch: int, hw: int) -> bool:
    """Whether the kernels take `plan` (csrc/exact_k.cuh:plan_ok, which the
    C entry points check before a launch; a refused plan raises there)."""
    cs, threads, per, vec = plan

    def pow2_upto(x, hi):
        return 1 <= x <= hi and x & (x - 1) == 0

    if (batch <= 0 or not 0 < hw <= MAX_HW or not pow2_upto(cs, EXACT_K_CLUSTER_SIZES[-1])
            or not pow2_upto(per, EXACT_K_MAX_PER_THREAD)
            or not 32 <= threads <= EXACT_K_MAX_THREADS or threads % 32):
        return False
    if vec and (hw % 4 or per < 4):
        return False
    return threads * per >= exact_k_slice(hw, cs, vec)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_plan(batch: int, hw: int, device: torch.device, *tensors) -> ExactKPlan:
    """exact_k_plan on `device`'s SM count, the vector path only where
    every tensor's data is 16-byte aligned."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return exact_k_plan(batch, hw, _sm_count(device.index if device.index is not None
                                              else torch.cuda.current_device()), aligned)


def _mulhilo(m: int, x: torch.Tensor):
    """(low, high) 32-bit words of m * x, m and x uint32 (x in int64), in
    16-bit halves so no product leaves int64."""
    a = m * (x & 0xFFFF)
    t = m * (x >> 16) + (a >> 16)
    return ((t & 0xFFFF) << 16) | (a & 0xFFFF), t >> 16


def philox4x32_10_first(c0, c1, c2, c3, k0, k1) -> torch.Tensor:
    """First 32-bit word of Philox4x32-10 at counter (c0, c1, c2, c3), key
    (k0, k1): csrc/exact_k.cuh:philox4x32_10_first in tensor ops. Arguments
    are uint32 values as int64 tensors or ints (broadcast together); returns
    int64."""
    words = (c0, c1, c2, c3, k0, k1)
    device = next((v.device for v in words if isinstance(v, torch.Tensor)), None)
    c0, c1, c2, c3, k0, k1 = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.int64, device=device) for v in words))
    for _ in range(10):
        lo0, hi0 = _mulhilo(0xD2511F53, c0)
        lo1, hi1 = _mulhilo(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _U32
        k1 = (k1 + 0xBB67AE85) & _U32
    return c0


def _philox_rows(seed: int, offset: int, tags, batch: int, hw: int, device) -> torch.Tensor:
    seed, offset = seed % 2**64, offset % 2**64
    pixel = torch.arange(hw, dtype=torch.int64, device=device)
    image = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    return torch.stack([philox4x32_10_first(pixel, image, tag, offset & _U32, seed & _U32,
                                            seed >> 32) for tag in tags])


def philox_fused_bits(seed: int, offset: int, batch: int, hw: int, device=None) -> torch.Tensor:
    """(2, batch, hw) int64: the fused kernel's draws at (seed, offset),
    counter (pixel, image, (offset_hi << 1) | {0 for t, 1 for t-1},
    offset_lo), key (seed_lo, seed_hi)."""
    hi = (offset % 2**64) >> 32
    tags = ((hi << 1) & _U32, ((hi << 1) & _U32) | 1)
    return _philox_rows(seed, offset, tags, batch, hw, device)


def philox_kmask_bits(seed: int, offset: int, batch: int, hw: int, device=None) -> torch.Tensor:
    """(batch, hw) int64: the exact-k kernel's draws at (seed, offset),
    counter (pixel, image, 0x80000000 | offset_hi, offset_lo), key (seed_lo,
    seed_hi)."""
    tag = 0x80000000 | ((offset % 2**64) >> 32)
    return _philox_rows(seed, offset, (tag,), batch, hw, device)[0]


def rowwise_kth_threshold(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row maximum T with count(row < T) <= k[row], by the JAX package's
    32-pass MSB-first scan.

    bits: (R, N) int64 holding uint32 values; k: (R, 1) int. Returns (R, 1)
    int64. Ties at T leave count(< T) < k; exact_k_degrade removes them."""
    t = torch.zeros((bits.shape[0], 1), dtype=torch.int64, device=bits.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        cnt = (bits < cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt <= k, cand, t)
    return t


def radix_kth_threshold(bits: torch.Tensor, k: torch.Tensor, digit_bits: int = DIGIT_BITS,
                        slices: int = 1, gather: int = GATHER_MAX) -> torch.Tensor:
    """rowwise_kth_threshold by the kernels' radix select
    (csrc/exact_k.cuh:radix_select): for 0 <= k < N the k-th smallest value
    of the row (0-indexed), found a digit of `digit_bits` at a time from the
    top. Each round counts the digit of the values whose higher digits equal
    the prefix so far, in `slices` contiguous slices (a cluster's CTAs)
    whose histograms are summed, then takes the digit d with below(d) <=
    k_rem < below(d) + hist(d). Once the selected bin holds at most `gather`
    values (before the last round), the row finishes by ranking them: the
    value with k_rem of them below it (the kernels' gather finish). k >= N
    gives 0xFFFFFFFF and k < 0 gives 0, as the scan does, without a select.

    bits: (R, N) int64 uint32 values; k: (R, 1) int. Returns (R, 1) int64."""
    r, n = bits.shape
    k = k.to(torch.int64).reshape(r, 1)
    krem = k.clamp(0, n - 1)
    prefix = torch.zeros((r, 1), dtype=torch.int64, device=bits.device)
    # the digit position at which a row's bin got small enough to gather (-1:
    # never) and its k_rem then; no host sync, so a CUDA graph can hold it
    fin_pos = torch.full_like(prefix, -1)
    fin_krem = torch.zeros_like(prefix)
    per = -(-n // slices)
    pos = 32
    while pos > 0:
        width = min(digit_bits, pos)
        pos -= width
        bins = 1 << width
        match = ((bits >> (pos + width)) == (prefix >> (pos + width))).to(torch.int64)
        digit = (bits >> pos) & (bins - 1)
        hist = torch.zeros((r, bins), dtype=torch.int64, device=bits.device)
        for s in range(slices):
            cols = slice(s * per, min(n, (s + 1) * per))
            hist += torch.zeros_like(hist).scatter_add_(1, digit[:, cols], match[:, cols])
        cum = hist.cumsum(1)
        d = (cum <= krem).sum(1, keepdim=True)
        prefix |= d << pos
        krem -= cum.gather(1, d) - hist.gather(1, d)
        if pos > 0:
            small = (hist.gather(1, d) <= gather) & (fin_pos < 0)
            fin_pos = torch.where(small, pos, fin_pos)
            fin_krem = torch.where(small, krem, fin_krem)
    # the gather finish: rank the values of the bin a row finished in
    at = fin_pos.clamp(min=0)
    inside = (bits >> at) == (prefix >> at)
    ranked = torch.where(inside, bits, torch.full_like(bits, 2**33)).sort(1).values
    prefix = torch.where(fin_pos >= 0, ranked.gather(1, fin_krem), prefix)
    return torch.where(k >= n, torch.full_like(prefix, _U32),
                       torch.where(k < 0, torch.zeros_like(prefix), prefix))


def exact_k_degrade(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row boolean degrade-set of exactly k[row] pixels: the k smallest
    draws, boundary ties broken by lane order. The low ceil(log2 N) bits of
    each draw are replaced by the lane index, so keys are unique and the
    radix select's threshold leaves exactly k below it. k >= N degrades
    every pixel.

    bits: (R, N) int64 uint32 values; k: (R, 1) int in [0, N]."""
    n = bits.shape[1]
    lane_bits = max(1, (n - 1).bit_length())
    hi = (0xFFFFFFFF << lane_bits) & 0xFFFFFFFF
    lane = torch.arange(n, dtype=torch.int64, device=bits.device)[None, :]
    keys = (bits & hi) | lane
    thr = radix_kth_threshold(keys, k)
    return (keys < thr) | (k >= n)


def fused_rows(
    bits_t: torch.Tensor,
    bits_n: torch.Tensor,
    sample_t: torch.Tensor,
    sample_0: torch.Tensor,
    amount_t: torch.Tensor,
    amount_next: torch.Tensor,
    *,
    channels: int,
    select: str,
    mean_mode: str,
    mean_value: float,
    rule: str,
):
    """Plain row math of the fused step.

    bits_*: (R, HW) int64 uint32 values; sample_*: (R, C*HW) f32
    channel-major; amount_*: (R, 1) f32 (ratios for thresholding, counts for
    indexing). Returns (out (R, C*HW), mask_n (R, HW)), mask_n the keep-mask
    at t-1."""
    if select == "thresholding":
        # top 24 bits, exact in f32: u uniform on [0, 1) at 2^-24 resolution
        inv24 = 1.0 / 16777216.0
        keep_t = (bits_t >> 8).to(torch.float32) * inv24 > amount_t
        keep_n = (bits_n >> 8).to(torch.float32) * inv24 > amount_next
    elif select == "indexing":
        keep_t = ~exact_k_degrade(bits_t, amount_t.to(torch.int32))
        keep_n = ~exact_k_degrade(bits_n, amount_next.to(torch.int32))
    else:
        raise ValueError(f"unknown select: {select!r}")

    mask_t = keep_t.to(torch.float32)
    mask_n = keep_n.to(torch.float32)
    # the shared 1-channel mask expands across channel-major lanes
    m_t = mask_t.repeat(1, channels)
    m_n = mask_n.repeat(1, channels)

    def mean_of(mask_full):
        if mean_mode == "const":
            return torch.tensor(float(mean_value), dtype=torch.float32,
                                device=sample_0.device)
        inv = 1.0 - mask_full
        s = (sample_0 * inv).sum(dim=1, keepdim=True)
        cnt = inv.sum(dim=1, keepdim=True)
        return torch.where(cnt > 0, s / cnt.clamp(min=1.0), torch.zeros_like(s))

    mu_t = mean_of(m_t)
    mu_n = mean_of(m_n)
    d_t = m_t * sample_0 + (1.0 - m_t) * mu_t
    d_n = m_n * sample_0 + (1.0 - m_n) * mu_n
    if rule == "base_momentum":
        out = sample_t - d_t + d_n  # cold diffusion (sampler.py:209-216)
    elif rule == "base_sampling":
        out = d_n  # sampler.py:199-207
    else:
        raise ValueError(f"unknown rule: {rule!r}")
    return out, mask_n


def uint32_to_int32(bits: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bit patterns."""
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)


def _check(sample_t, sample_0, amount_t, amount_next, bits):
    if sample_t.dim() != 4 or sample_t.shape != sample_0.shape:
        raise ValueError(
            f"sample_t/sample_0 must be equal (B, C, H, W) tensors, got "
            f"{tuple(sample_t.shape)} and {tuple(sample_0.shape)}"
        )
    b, c, h, w = sample_t.shape
    for name, x in (("sample_t", sample_t), ("sample_0", sample_0),
                    ("amount_t", amount_t), ("amount_next", amount_next)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != sample_t.device:
            raise ValueError(f"{name} is on {x.device}, sample_t on {sample_t.device}")
    for name, x in (("amount_t", amount_t), ("amount_next", amount_next)):
        if tuple(x.shape) != (b,):
            raise ValueError(f"{name} must have shape ({b},), got {tuple(x.shape)}")
    if bits is not None:
        if bits.dtype != torch.int64 or tuple(bits.shape) != (2, b, h * w):
            raise ValueError(
                f"bits must be an int64 (2, {b}, {h * w}) tensor of uint32 values, "
                f"got {bits.dtype} {tuple(bits.shape)}"
            )
        if bits.device != sample_t.device:
            raise ValueError(f"bits is on {bits.device}, sample_t on {sample_t.device}")


def fused_degrade_update(
    sample_t: torch.Tensor,
    sample_0: torch.Tensor,
    amount_t: torch.Tensor,
    amount_next: torch.Tensor,
    *,
    select: str,
    mean_mode: str,
    mean_value: float = 0.0,
    rule: str = "base_momentum",
    seed: int = 0,
    offset: int = 0,
    bits: Optional[torch.Tensor] = None,
    launch_plan: Optional[ExactKPlan] = None,
):
    """Fused degrade(t) + degrade(t-1) + update for the sampling loop.

    sample_t, sample_0: (B, C, H, W) f32; amount_*: (B,) f32 schedule
    amounts. Random bits come from Philox at (seed, offset) on the card
    (philox_fused_bits), or from `bits`, an int64 (2, B, H*W) tensor of
    uint32 values (bits for t, then for t-1). Returns (new_sample_t
    (B, C, H, W), mask_next (B, 1, H, W)).

    CPU tensors take the plain version (bits drawn from a generator seeded
    by (seed, offset) when not given); CUDA tensors launch the kernel, and
    anything it cannot take raises. The kernel runs `launch_plan`, by
    default exact_k_plan for the batch on the tensors' card; a plan the
    kernel refuses raises.
    """
    _check(sample_t, sample_0, amount_t, amount_next, bits)
    b, c, h, w = sample_t.shape
    hw = h * w
    if select not in _SELECT or mean_mode not in _MEAN_MODE or rule not in _RULE:
        raise ValueError(f"unsupported mode: {select!r}, {mean_mode!r}, {rule!r}")

    if sample_t.device.type == "cpu":
        if bits is None:
            gen = torch.Generator().manual_seed((seed * 1000003 + offset) % 2**63)
            bits = torch.randint(0, 2**32, (2, b, hw), generator=gen, dtype=torch.int64)
        out, mask_n = fused_rows(
            bits[0], bits[1], sample_t.reshape(b, c * hw), sample_0.reshape(b, c * hw),
            amount_t[:, None], amount_next[:, None], channels=c, select=select,
            mean_mode=mean_mode, mean_value=mean_value, rule=rule,
        )
        return out.reshape(b, c, h, w), mask_n.reshape(b, 1, h, w)

    if sample_t.device.type != "cuda":
        raise RuntimeError(f"fused_degrade_update: no kernel for {sample_t.device}")
    if hw > MAX_HW:
        raise ValueError(
            f"fused_degrade_update: {h}x{w} exceeds the kernel's bound of "
            f"{MAX_HW} pixels per image"
        )
    lib = build.load_library()
    xt = sample_t.contiguous()
    x0 = sample_0.contiguous()
    amt = amount_t.contiguous()
    amn = amount_next.contiguous()
    bits32 = uint32_to_int32(bits).contiguous() if bits is not None else None
    out = torch.empty_like(xt)
    mask_n = torch.empty((b, 1, h, w), dtype=torch.float32, device=xt.device)
    if launch_plan is None:
        launch_plan = device_plan(b, hw, xt.device, xt, x0, out, mask_n)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_fused_degrade(
            xt.data_ptr(), x0.data_ptr(), amt.data_ptr(), amn.data_ptr(),
            bits32.data_ptr() if bits32 is not None else None,
            seed % 2**64, offset % 2**64, out.data_ptr(), mask_n.data_ptr(),
            b, c, hw, _SELECT[select], _MEAN_MODE[mean_mode], float(mean_value),
            _RULE[rule], *launch_plan, stream,
        )
    build.check(lib, code, "fused_degrade_update")
    fused_degrade_update.launches += 1
    return out, mask_n


#: kernel launches since the count was last set to 0 (the plain path adds none)
fused_degrade_update.launches = 0


def fused_degrade_update_sharded(
    sample_t: torch.Tensor,
    sample_0: torch.Tensor,
    amount_t: torch.Tensor,
    amount_next: torch.Tensor,
    *,
    plan,
    batch: int,
    select: str,
    mean_mode: str,
    mean_value: float = 0.0,
    rule: str = "base_momentum",
    seed: int = 0,
    offset: int = 0,
    bits: Optional[torch.Tensor] = None,
):
    """Data-parallel form of fused_degrade_update (JAX
    fused_degrade_update_sharded, ops/pallas/fused_degrade.py:295): this
    rank's rows of a global batch of `batch` images (sample_*, amount_* and
    `bits` hold the rank's batch // N rows), one kernel launch with the
    Philox seed folded with plan.rank (ops/shard.py). Returns the rank's
    (new_sample_t, mask_next)."""

    def fn(folded, xt, x0, amt, amn, bits_rows):
        out = fused_degrade_update(
            xt, x0, amt, amn, select=select, mean_mode=mean_mode, mean_value=mean_value,
            rule=rule, seed=folded, offset=offset,
            bits=None if bits_rows is None else bits_rows.transpose(0, 1),
        )
        if xt.device.type == "cuda":
            fused_degrade_update_sharded.launches += 1
        return out

    # the harness slices batch-major arguments: bits travel as (b, 2, HW)
    return data_parallel_kernel(fn, plan)(
        batch, seed, sample_t, sample_0, amount_t, amount_next,
        None if bits is None else bits.transpose(0, 1))


#: kernel launches through the sharded form since the count was last set to 0
fused_degrade_update_sharded.launches = 0
