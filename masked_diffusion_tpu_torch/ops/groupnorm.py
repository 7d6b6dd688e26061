"""GroupNorm (+ affine) (+ SiLU) forward: a Triton kernel and its plain
PyTorch version, NCHW.

Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/groupnorm.py:
group_norm_silu (pallas_call at :113, body _gn_silu_kernel :55). Every
GroupNorm of the port's UNet goes through `group_norm_silu`.

Kernel design. In NCHW the group g of image b is one contiguous span of
C/G * H*W elements, so one program owns one (image, group): it reduces fp32
sum and sum of squares over its span in blocks, then walks the span again to
normalise, apply the per-channel affine and the optional SiLU, and writes in
the input's dtype. The span (at most 64 KB of fp32 at the flagship's widest
level) is read twice; the second read comes from L2. Bound: device-memory
bytes, one read and one write of the tensor. The TPU kernel's one-hot MXU
matmul for group sums has no counterpart: contiguous spans make it a plain
reduction.

The plain version transliterates the JAX package's _gn_reference
(groupnorm.py:132-154): fp32 statistics, normalise/affine/SiLU in the input
dtype.

No backward yet: on CUDA with grad enabled and an input that requires grad,
the wrapper raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_kernel = None  # the @triton.jit function, built at first launch


def group_norm_silu_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    """GroupNorm(+SiLU) over NCHW x: fp32 statistics, without an fp32 copy
    of x for the mean; elementwise math in x's dtype."""
    b, c, h, w = x.shape
    xg = x.reshape(b, groups, (c // groups) * h * w)
    mean = xg.mean(dim=2, keepdim=True, dtype=torch.float32)
    mean_sq = xg.float().square().mean(dim=2, keepdim=True)
    rstd = torch.rsqrt(mean_sq - mean.square() + eps)
    y = (xg - mean.to(x.dtype)) * rstd.to(x.dtype)
    y = y.reshape(b, c, h, w) * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]
    if silu:
        y = F.silu(y)
    return y.to(x.dtype)


def _build_kernel():
    global _kernel
    if _kernel is not None:
        return _kernel
    from masked_diffusion_tpu_torch.ops import build

    build.triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def gn_silu_kernel(
        x_ptr, w_ptr, b_ptr, y_ptr, span, hw, cg, groups, eps,
        SILU: tl.constexpr, BLOCK: tl.constexpr,
    ):
        pid = tl.program_id(0)  # image * groups + group
        g = pid % groups
        base = pid.to(tl.int64) * span
        offs = tl.arange(0, BLOCK)
        acc = tl.zeros([BLOCK], dtype=tl.float32)
        acc_sq = tl.zeros([BLOCK], dtype=tl.float32)
        for start in range(0, span, BLOCK):
            idx = start + offs
            m = idx < span
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            acc += v
            acc_sq += v * v
        n = span.to(tl.float32)
        mean = tl.sum(acc, axis=0) / n
        var = tl.sum(acc_sq, axis=0) / n - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        for start in range(0, span, BLOCK):
            idx = start + offs
            m = idx < span
            ch = g * cg + idx // hw
            v = tl.load(x_ptr + base + idx, mask=m, other=0.0).to(tl.float32)
            wv = tl.load(w_ptr + ch, mask=m, other=1.0).to(tl.float32)
            bv = tl.load(b_ptr + ch, mask=m, other=0.0).to(tl.float32)
            y = (v - mean) * rstd * wv + bv
            if SILU:
                y = y * tl.sigmoid(y)
            tl.store(y_ptr + base + idx, y.to(y_ptr.dtype.element_ty), mask=m)

    _kernel = gn_silu_kernel
    return _kernel


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    """Fused GroupNorm + affine + optional SiLU over NCHW x.

    CPU tensors take the plain version; CUDA tensors launch the Triton kernel
    or raise (no backward yet)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    b, c, h, w = x.shape
    if c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale and bias must have shape ({c},)")
    if x.device.type == "cpu":
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError(
            "group_norm_silu has no backward yet: call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"group_norm_silu: unsupported dtype {x.dtype}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must lie on x's device")

    kernel = _build_kernel()
    xc = x.contiguous()
    y = torch.empty_like(xc)
    cg = c // groups
    span = cg * h * w
    block = min(4096, max(128, 1 << (span - 1).bit_length()))
    with torch.cuda.device(x.device):
        kernel[(b * groups,)](
            xc, scale.contiguous(), bias.contiguous(), y, span, h * w, cg, groups,
            float(eps), SILU=bool(silu), BLOCK=block, num_warps=4 if block <= 1024 else 8,
        )
    group_norm_silu.launches += 1
    return y


#: kernel launches since the count was last set to 0 (the plain path adds none)
group_norm_silu.launches = 0
