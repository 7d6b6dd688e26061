"""Exact softmax attention for tiny heads: the CUDA kernel and its plain
PyTorch version.

Counterpart of masked_diffusion_tpu/ops/pallas/tinyhead_attention.py. The
kernel is csrc/tinyhead_attention.cu (its header says what it computes, what
bounds it and what its design does about that). Public layout as in the JAX
package: q, k, v (B, heads, S, D) in, (B, heads, S, D) out in q's dtype.

  tinyhead_supported        the JAX predicate: D <= 8 and S >= 128
  tinyhead_attention_plain  the JAX _einsum_reference: fp32 scores, fp32
                            softmax cast to v's dtype, then the second product
  tinyhead_attention        the wrapper the UNet's attention blocks call: CPU
                            tensors run the plain version; CUDA tensors launch
                            the kernel, or raise on what it does not take

The gradient is an autograd Function, as the JAX custom VJP: its forward is
the wrapper (the kernel on the card) and saves q, k and v; its backward
recomputes through the plain version under autograd (JAX `_bwd`). There is
no backward kernel, so the backward materialises the (B, heads, S, S)
scores: 1 GiB of fp32 per image and block at S = 4096 with 16 heads.
"""

from __future__ import annotations

import torch

from masked_diffusion_tpu_torch.ops import build

HEAD_DIM_MAX = 8
SEQ_MIN = 128
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


def _launch(q, k, v, scale):
    if q.device.type != "cuda":
        raise RuntimeError(f"tinyhead_attention: no kernel for {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"tinyhead_attention: the kernel takes fp32 or bf16 q, k, v of "
                        f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("tinyhead_attention: the kernel takes contiguous q, k, v")
    b, h, s, d = q.shape
    lib = build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.mdt_tinyhead_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, s, d,
            float(scale), _DTYPES[q.dtype], stream,
        )
    build.check(lib, code, "tinyhead_attention")
    tinyhead_attention.launches += 1
    return out


class _TinyheadAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        if q.device.type == "cpu":
            return tinyhead_attention_plain(q, k, v, scale).to(q.dtype)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # the plain formulation's own dtypes: fp32 scores whatever autocast
        # the forward ran under
        with torch.enable_grad(), torch.autocast(q.device.type, enabled=False):
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = tinyhead_attention_plain(*leaves, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, leaves, g.to(out.dtype))
        return dq, dk, dv, None


def tinyhead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v for (B, heads, S, D <= 8) inputs with S >= 128;
    (B, heads, S, D) out in q's dtype, differentiable in q, k and v."""
    _check(q, k, v)
    return _TinyheadAttention.apply(q, k, v, float(scale))


#: kernel launches since the count was last set to 0 (the plain path adds none)
tinyhead_attention.launches = 0
