"""Fused degrade + update for the reverse loop: the CUDA kernel and its plain
PyTorch version.

Counterpart of masked_diffusion_tpu/ops/pallas/fused_degrade.py. The kernel
is csrc/fused_degrade.cu (its header says what it computes and what bounds
it); the plain version below transliterates the JAX row math with the JAX
row signature, so the tests compare the two packages on identical bits:

  rowwise_kth_threshold  greedy MSB-first scan, max T with count(< T) <= k
  exact_k_degrade        exactly k degraded pixels via lane-index keys
  fused_rows             masks, masked means, fills and the update rule

Random bits are uint32 values carried in int64 tensors (PyTorch's uint32
lacks shifts and comparisons on the CPU).

`fused_degrade_update` is the wrapper the sampling loop calls. For CPU
tensors it runs the plain version; for CUDA tensors it launches the kernel
or raises. It never falls back from one to the other.
`fused_degrade_update_sharded` is its data-parallel form (one launch per
rank on its rows, the seed folded with the rank: ops/shard.py), through
which the sampling loop reaches it, with a 1-rank plan in one process.
"""

from __future__ import annotations

from typing import Optional

import torch

from masked_diffusion_tpu_torch.ops import build
from masked_diffusion_tpu_torch.ops.shard import data_parallel_kernel

#: Largest H*W the kernel takes (256 * 256).
MAX_HW = 256 * 256
#: Above this H*W (16 pixels for each of 1024 threads) the kernel keeps its
#: keys in device memory instead of registers: on the Philox route, in a
#: (2, B, H*W) scratch the wrapper allocates.
REGISTER_HW = 128 * 128

_SELECT = {"thresholding": 0, "indexing": 1}
_MEAN_MODE = {"const": 0, "degraded_area": 1}
_RULE = {"base_momentum": 0, "base_sampling": 1}


def rowwise_kth_threshold(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row maximum T with count(row < T) <= k[row].

    bits: (R, N) int64 holding uint32 values; k: (R, 1) int. Returns (R, 1)
    int64. Ties at T leave count(< T) < k; exact_k_degrade removes them."""
    t = torch.zeros((bits.shape[0], 1), dtype=torch.int64, device=bits.device)
    for b in range(32):
        cand = t | (1 << (31 - b))
        cnt = (bits < cand).sum(dim=1, keepdim=True)
        t = torch.where(cnt <= k, cand, t)
    return t


def exact_k_degrade(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-row boolean degrade-set of exactly k[row] pixels: the k smallest
    draws, boundary ties broken by lane order. The low ceil(log2 N) bits of
    each draw are replaced by the lane index, so keys are unique and one
    32-pass scan selects exactly k. k >= N degrades every pixel.

    bits: (R, N) int64 uint32 values; k: (R, 1) int in [0, N]."""
    n = bits.shape[1]
    lane_bits = max(1, (n - 1).bit_length())
    hi = (0xFFFFFFFF << lane_bits) & 0xFFFFFFFF
    lane = torch.arange(n, dtype=torch.int64, device=bits.device)[None, :]
    keys = (bits & hi) | lane
    thr = rowwise_kth_threshold(keys, k)
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
):
    """Fused degrade(t) + degrade(t-1) + update for the sampling loop.

    sample_t, sample_0: (B, C, H, W) f32; amount_*: (B,) f32 schedule
    amounts. Random bits come from Philox at (seed, offset) on the card, or
    from `bits`, an int64 (2, B, H*W) tensor of uint32 values (bits for t,
    then for t-1). Returns (new_sample_t (B, C, H, W), mask_next (B, 1, H, W)).

    CPU tensors take the plain version (bits drawn from a generator seeded
    by (seed, offset) when not given); CUDA tensors launch the kernel, and
    anything it cannot take raises.
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
    keys = None
    if hw > REGISTER_HW and bits is None:
        keys = torch.empty((2, b, hw), dtype=torch.int32, device=xt.device)
    with torch.cuda.device(xt.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_fused_degrade(
            xt.data_ptr(), x0.data_ptr(), amt.data_ptr(), amn.data_ptr(),
            bits32.data_ptr() if bits32 is not None else None,
            seed % 2**64, offset % 2**64, out.data_ptr(), mask_n.data_ptr(),
            keys.data_ptr() if keys is not None else None,
            b, c, hw, _SELECT[select], _MEAN_MODE[mean_mode], float(mean_value),
            _RULE[rule], stream,
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
