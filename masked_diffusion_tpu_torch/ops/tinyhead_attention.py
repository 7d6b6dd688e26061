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
                               product
  tinyhead_forward_plain       the same out, and the base-2 log-sum-exp of
                               each row's scaled scores (fp32, (B, heads, S))
  tinyhead_backward_plain      (dq, dk, dv) from out and that log-sum-exp, in
                               the backward kernel's arithmetic, no autograd
  tinyhead_attention           the wrapper the UNet's attention blocks call,
                               differentiable in q, k and v
  tinyhead_forward             the forward's wrapper: (out, lse)
  tinyhead_attention_backward  the backward's wrapper: (dq, dk, dv)

The gradient is an autograd Function, as the JAX custom VJP (whose `_bwd`
recomputes through the einsums): its forward saves q, k, v, out and the
log-sum-exp, and its backward runs the backward kernel. CPU tensors run the
plain versions, forward and backward; CUDA tensors launch the kernels, or
raise on what they do not take. Each wrapper counts its launches.
"""

from __future__ import annotations

import math

import torch

from masked_diffusion_tpu_torch.ops import build

HEAD_DIM_MAX = 8
SEQ_MIN = 128
LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def tinyhead_supported(s: int, d: int) -> bool:
    """Shapes the kernel takes: heads at most 8 wide, S of at least 128."""
    return d <= HEAD_DIM_MAX and s >= SEQ_MIN


def tinyhead_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v with fp32 scores and softmax, the
    probabilities cast to v's dtype for the second product."""
    a = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float())
    a = torch.softmax(a * scale, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", a, v)


def tinyhead_forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float):
    """(out, lse): out exactly as tinyhead_attention_plain, and lse =
    log2 sum_j 2^(scale log2(e) q k_j^T), fp32 (B, heads, S), what the
    backward rebuilds the probabilities from."""
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
    return out, lse


def tinyhead_attention_backward(q, k, v, out, lse, g, scale: float):
    """(dq, dk, dv) of the tiny-head attention from the forward's out and
    lse and the output gradient g, all as the kernels lay them out (g
    contiguous, in q's dtype). CPU tensors run tinyhead_backward_plain; CUDA
    tensors launch the backward kernel, or raise on what it does not take."""
    if q.device.type == "cpu":
        return tinyhead_backward_plain(q, k, v, out, lse, g, scale)
    _kernel_inputs("tinyhead_attention_backward", (q, k, v, out, g), lse)
    b, h, s, d = q.shape
    lib = build.load_library()
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_tinyhead_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, s, d,
            float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(lib, code, "tinyhead_attention_backward")
    tinyhead_attention_backward.launches += 1
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
