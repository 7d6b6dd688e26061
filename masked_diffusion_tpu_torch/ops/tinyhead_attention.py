"""Exact softmax attention for tiny heads, forward and backward: the CUDA
kernels and their plain PyTorch versions.

Counterpart of masked_diffusion_tpu/ops/pallas/tinyhead_attention.py. The
kernels are csrc/tinyhead_attention.cu (forward) and
csrc/tinyhead_attention_bwd.cu (backward); their headers say what they
compute, what bounds them and what their design does about that. Public
layout as in the JAX package: q, k, v (B, heads, S, D) in, (B, heads, S, D)
out in q's dtype.

  tinyhead_supported           the JAX predicate: D <= 8 and S >= 128
  tinyhead_attention_plain     the JAX _einsum_reference: fp32 scores, fp32
                               softmax cast to v's dtype, then the second
                               product, with autocast off (the JAX einsum's
                               preferred_element_type=float32)
  chunked_attention_plain      the same math one block of query rows at a
                               time (JAX models/unet.py AttentionBlock
                               chunk_q, --attention_chunk): the live scores
                               are (B, heads, chunk, S), not (B, heads, S, S)
  tinyhead_forward_plain       the same out, and the base-2 log-sum-exp of
                               each row's scaled scores (fp32, (B, heads, S))
  tinyhead_backward_plain      (dq, dk, dv) from out and that log-sum-exp, in
                               the backward kernel's arithmetic, no autograd
  tinyhead_attention           the wrapper the UNet's attention blocks call,
                               differentiable in q, k and v
  tinyhead_forward             the forward's wrapper: (out, lse)
  tinyhead_attention_backward  the backward's wrapper: (dq, dk, dv)
  tinyhead_bwd_plan            the backward kernel's launch plan: keys a
                               CTA, slices a head, warps a CTA, workspace

The gradient is an autograd Function, as the JAX custom VJP (whose `_bwd`
recomputes through the einsums): its forward saves q, k, v, out and the
log-sum-exp, and its backward runs the backward kernel. CPU tensors run the
plain versions, forward and backward; CUDA tensors launch the kernels, or
raise on what they do not take. Each wrapper counts its launches, and
apart its fp32 instances' (tinyhead_attention_fp32,
tinyhead_attention_backward_fp32: split-TF32 kernels on the tensor cores).
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch

from masked_diffusion_tpu_torch.ops import build

HEAD_DIM_MAX = 8
SEQ_MIN = 128
LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: keys a warp of the backward kernel owns, by element size: bf16 four
#: 16-key mma tiles, fp32 two (its split-TF32 fragments take four times
#: bf16's registers)
BWD_WARP_KEYS = {2: 64, 4: 32}
#: warps a CTA of the backward kernel: at least 4 (a thread a query row of a
#: 64-query chunk; fp32 two), at most, by element size, 16 in bf16 (1024 keys
#: a pass) and 8 in fp32 (256)
BWD_MIN_WARPS = 4
BWD_MAX_WARPS = {2: 16, 4: 8}
#: the backward's peak extra device memory (its outputs and workspace)
#: stays under this many times the bytes of q, k, v, out and dO
BWD_MEMORY_SHARE = 4


def tinyhead_supported(s: int, d: int) -> bool:
    """Shapes the kernel takes: heads at most 8 wide, S of at least 128."""
    return d <= HEAD_DIM_MAX and s >= SEQ_MIN


def _autocast_off(device: torch.device):
    """Autocast turned off on the CPU and CUDA, where a caller may have it
    on; other devices (the meta device that counts shapes) have none."""
    if device.type in ("cpu", "cuda"):
        return torch.autocast(device.type, enabled=False)
    return contextlib.nullcontext()


def tinyhead_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 scores and softmax, the
    probabilities cast to v's dtype for the second product. Autocast is off
    inside: under it the fp32 score product would come out in bf16."""
    with _autocast_off(q.device):
        a = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
        a = torch.softmax(a * scale, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bhtd->bhsd", a, v)


def chunked_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            scale: float, chunk: int) -> torch.Tensor:
    """tinyhead_attention_plain over blocks of `chunk` query rows, each
    against all keys. Rows are independent, so the last, shorter block gives
    what the JAX zero-padded and trimmed block gives."""
    return torch.cat([tinyhead_attention_plain(q[:, :, i:i + chunk], k, v, scale)
                      for i in range(0, q.shape[2], int(chunk))], dim=2)


def tinyhead_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float):
    """(out, lse): out exactly as tinyhead_attention_plain, and lse =
    log2 sum_j 2^(scale log2(e) q k_j^T), fp32 (B, heads, S), what the
    backward rebuilds the probabilities from. Autocast is off inside."""
    with _autocast_off(q.device):
        a = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
        lse = torch.logsumexp(a, dim=-1) * LOG2E
        a = torch.softmax(a, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bhtd->bhsd", a, v), lse


def tinyhead_backward_plain(q, k, v, out, lse, g, scale: float):
    """(dq, dk, dv) in q's dtype, the backward kernel's arithmetic: P =
    2^(q k^T scale log2 e - lse), D = rowsum(g * out), dS = P (g v^T - D);
    fp32 products of the inputs as given, with P and dS rounded to q's dtype
    where they enter a product (as the bf16 kernel feeds its tensor cores)."""
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, g))
    p = torch.exp2(torch.einsum("bhsd,bhtd->bhst", qf, kf) * (scale * LOG2E)
                   - lse.float()[..., None])
    dp = torch.einsum("bhsd,bhtd->bhst", gf, vf)
    ds = p * (dp - (gf * of).sum(-1, keepdim=True))
    p, ds = (t.to(q.dtype).float() for t in (p, ds))
    dv = torch.einsum("bhst,bhsd->bhtd", p, gf)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


class TinyheadBwdPlan(NamedTuple):
    """Launch plan of the backward kernel (csrc/tinyhead_attention_bwd.cu).
    With n = BWD_WARP_KEYS of the dtype (bf16 64, fp32 32), CTA i of a head
    owns keys [i * keys, (i + 1) * keys) and covers them in keys / (n *
    warps) passes; warp w of pass p owns the n keys from i * keys + (p *
    warps + w) * n."""

    keys: int  # keys a CTA
    slices: int  # CTAs a head
    warps: int  # warps a CTA
    workspace: int  # bytes of the (slices, B*heads, S, 8) fp32 dQ sums; 0: one slice
    # of one pass, and the kernel writes dq itself


def tinyhead_bwd_max_slices(d: int, elem: int = 2) -> int:
    """Most slices whose fp32 workspace (32 bytes a row a slice) and dq,
    dk, dv stay under BWD_MEMORY_SHARE times q, k, v, out and dO (elem * d
    bytes a row each; elem 2 for bf16, 4 for fp32)."""
    return max(1, (BWD_MEMORY_SHARE * 5 * elem * d - 3 * elem * d - 1) // (4 * HEAD_DIM_MAX))


def tinyhead_bwd_plan(bh: int, s: int, sms: int, d: int = HEAD_DIM_MAX,
                      elem: int = 2) -> TinyheadBwdPlan:
    """The backward kernel's plan for bh heads of S queries and keys of
    width d and elem bytes (2 bf16, 4 fp32) on a card of `sms` SMs. With n
    = BWD_WARP_KEYS[elem] and W = BWD_MAX_WARPS[elem]: slices, the fewest
    that give each CTA at most W warps of n keys in one pass, doubled while
    bh * slices stays under one CTA an SM and a CTA keeps 4 warps, never
    more than tinyhead_bwd_max_slices(d, elem); a wider slice runs in
    passes. Warps: the fewest that cover a slice's share of a pass. Raises
    on what the kernel does not take (bh < 1; S < 128 or d > 8; elem not 2
    or 4)."""
    if bh <= 0 or sms <= 0 or not tinyhead_supported(s, d) or elem not in BWD_WARP_KEYS:
        raise ValueError(f"tinyhead_bwd_plan: bh {bh}, S {s}, d {d}, {elem}-byte elements, "
                         f"{sms} SMs: the kernel takes bh >= 1, S >= {SEQ_MIN}, "
                         f"d <= {HEAD_DIM_MAX}, bf16 or fp32")

    def ceil(a, b):
        return -(-a // b)

    warp_keys = BWD_WARP_KEYS[elem]
    pass_keys = warp_keys * BWD_MAX_WARPS[elem]
    cap = tinyhead_bwd_max_slices(d, elem)
    slices = min(cap, ceil(s, pass_keys))
    most = min(cap, ceil(s, warp_keys * BWD_MIN_WARPS))
    while slices < most and bh * slices < sms:
        slices = min(most, 2 * slices)
    while True:
        passes = ceil(s, slices * pass_keys)
        warps = max(BWD_MIN_WARPS, ceil(s, slices * passes * warp_keys))
        keys = warps * warp_keys * passes
        if (slices - 1) * keys < s:  # no slice empty
            break
        slices -= 1
    parts = slices > 1 or passes > 1
    return TinyheadBwdPlan(keys, slices, warps,
                           slices * bh * s * HEAD_DIM_MAX * 4 if parts else 0)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"tinyhead_attention: q, k, v must be equal (B, heads, S, D) tensors, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    _, _, s, d = q.shape
    if not tinyhead_supported(s, d):
        raise ValueError(f"tinyhead_attention needs D<={HEAD_DIM_MAX}, S>={SEQ_MIN}; "
                         f"got S={s} D={d}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"tinyhead_attention: q on {q.device}, k on {k.device}, "
                         f"v on {v.device}")


def _kernel_inputs(what: str, ts, lse=None):
    """Raise on what the kernels do not take: CUDA tensors of one device, fp32
    or bf16 of one dtype, contiguous and 16-byte aligned; lse fp32."""
    q = ts[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for {q.device}")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{what}: the kernel takes fp32 or bf16 tensors of one dtype, got "
                        f"{[t.dtype for t in ts]}")
    every = list(ts) + ([lse] if lse is not None else [])
    if any(t.device != q.device for t in every):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in every]}")
    if any(t.shape != q.shape for t in ts):
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in ts]} differ")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != q.shape[:3]):
        raise ValueError(f"{what}: lse must be fp32 {tuple(q.shape[:3])}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in every):
        raise ValueError(f"{what}: the kernel takes contiguous, 16-byte aligned tensors")


def tinyhead_forward(q, k, v, scale: float, with_lse: bool = True):
    """(out, lse or None) of the tiny-head attention for (B, heads, S, D)
    q, k, v as the kernels lay them out; lse only when asked for (a
    gradient will be taken). CPU tensors run the plain versions; CUDA tensors
    launch the forward kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        if not with_lse:
            return tinyhead_attention_plain(q, k, v, scale).to(q.dtype), None
        out, lse = tinyhead_forward_plain(q, k, v, scale)
        return out.to(q.dtype), lse
    _kernel_inputs("tinyhead_attention", (q, k, v))
    b, h, s, d = q.shape
    lib = build.load_library()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_tinyhead_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b * h, s, d, float(scale),
            _DTYPES[q.dtype], stream,
        )
    build.check(lib, code, "tinyhead_attention")
    tinyhead_attention.launches += 1
    if q.dtype == torch.float32:
        tinyhead_attention_fp32.launches += 1
    return out, lse


def tinyhead_attention_backward(q, k, v, out, lse, g, scale: float):
    """(dq, dk, dv) of the tiny-head attention from the forward's out and
    lse and the output gradient g, all as the kernels lay them out (g
    contiguous, in q's dtype). CPU tensors run tinyhead_backward_plain; CUDA
    tensors launch the backward kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        return tinyhead_backward_plain(q, k, v, out, lse, g, scale)
    b, h, s, d = q.shape
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    plan = tinyhead_bwd_plan(b * h, s, _sm_count(index), d, q.element_size())
    return launch_backward(q, k, v, out, lse, g, scale, plan)


def launch_backward(q, k, v, out, lse, g, scale: float, plan):
    """The backward kernel on CUDA tensors on `plan` (a TinyheadBwdPlan,
    bf16 or fp32 alike; the kernel refuses one it does not take, and the
    wrapper raises). Allocates dq, dk, dv and the plan's workspace. One
    launch of kernel 4b to the count, the slice sum included."""
    what = "tinyhead_attention_backward"
    if not isinstance(plan, TinyheadBwdPlan):
        raise ValueError(f"{what}: the kernel takes a plan (tinyhead_bwd_plan), got {plan!r}")
    _kernel_inputs(what, (q, k, v, out, g), lse)
    b, h, s, d = q.shape
    lib = build.load_library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    ws = None
    if plan.workspace:
        ws = torch.empty((plan.slices, b * h, s, HEAD_DIM_MAX), dtype=torch.float32,
                         device=q.device)
    keys, slices, warps = plan[:3]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_tinyhead_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            ws.data_ptr() if ws is not None else None, b * h, s, d, float(scale),
            _DTYPES[q.dtype], keys, slices, warps, stream,
        )
    build.check(lib, code, what)
    tinyhead_attention_backward.launches += 1
    if q.dtype == torch.float32:
        tinyhead_attention_backward_fp32.launches += 1
    return dq, dk, dv


class _TinyheadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        grad = any(ctx.needs_input_grad[:3])  # serving: no lse, nothing saved
        out, lse = tinyhead_forward(q, k, v, scale, grad)
        if grad:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        # the plain version's own dtypes, whatever autocast the caller runs under
        with torch.autocast(q.device.type, enabled=False):
            dq, dk, dv = tinyhead_attention_backward(q, k, v, out, lse,
                                                     g.to(q.dtype).contiguous(), ctx.scale)
        return dq, dk, dv, None


def tinyhead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, heads, S, D <= 8) inputs with S >= 128;
    (B, heads, S, D) out in q's dtype, differentiable in q, k and v."""
    _check(q, k, v)
    return _TinyheadAttention.apply(q, k, v, float(scale))


#: forward kernel launches since the count was last set to 0 (the plain path adds none)
tinyhead_attention.launches = 0
#: backward kernel launches since the count was last set to 0
tinyhead_attention_backward.launches = 0


class _InstanceCount:
    """The launch count of one dtype's kernel among those one wrapper
    launches; ops/launches.py reads and sets it beside the wrappers'."""

    def __init__(self, name: str):
        self.__name__ = name
        self.launches = 0


#: the fp32 (split-TF32) forward kernel's launches, also in tinyhead_attention's
tinyhead_attention_fp32 = _InstanceCount("tinyhead_attention_fp32")
#: the fp32 backward kernel's launches, also in tinyhead_attention_backward's
tinyhead_attention_backward_fp32 = _InstanceCount("tinyhead_attention_backward_fp32")
