"""GroupNorm (+ affine) (+ SiLU), forward and backward: Triton kernels and
their plain PyTorch version, NCHW.

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

The forward also writes the per-(image, group) fp32 mean and rstd, which
the backward reads instead of recomputing them.

Backward kernel. The JAX package's backward is a jnp recompute through
_gn_reference (groupnorm.py:169-178), not a Pallas kernel; the port writes
it as one because a training step runs it once per norm (71 times in the
flagship UNet). One program per (image, group) again, over the group's
(channels, pixels) tile:
  1. recompute x^ = (x - mean) * rstd and y = gamma * x^ + beta; with SiLU,
     dy = g * s * (1 + y * (1 - s)), s = sigmoid(y); without, dy = g;
  2. reduce fp32 per-channel sums of dy and dy * x^ over the pixels: the
     (image, channel) partials of dbeta and dgamma, written to a (B, C) fp32
     buffer, and from them sum(dy * gamma) and sum(dy * gamma * x^);
  3. a second pass writes dx = rstd * (dy * gamma - mean(dy * gamma)
     - x^ * mean(dy * gamma * x^)) in x's dtype.
dgamma and dbeta are the partials summed over B (a torch.sum over the small
buffer). Bound: device-memory bytes, one read of x and of g and one write of
dx (the second pass reads the group's span again from L2).

The plain version transliterates the JAX package's _gn_reference
(groupnorm.py:132-154): fp32 statistics, normalise/affine/SiLU in the input
dtype. Its backward is autograd through it.

`group_norm_silu` is a torch.autograd.Function on CUDA: forward kernel, then
the backward kernel (`group_norm_silu_backward`). Each has its own launch
count. CPU tensors take the plain version, forward and backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_kernels = None  # the @triton.jit functions (forward, backward), built at first launch


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


def _build_kernels():
    global _kernels
    if _kernels is not None:
        return _kernels
    from masked_diffusion_tpu_torch.ops import build

    build.triton_cache_env()
    import triton
    import triton.language as tl

    @triton.jit
    def gn_silu_kernel(
        x_ptr, w_ptr, b_ptr, y_ptr, mean_ptr, rstd_ptr, span, hw, cg, groups, eps,
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
        tl.store(mean_ptr + pid, mean)
        tl.store(rstd_ptr + pid, rstd)
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

    @triton.jit
    def gn_silu_bwd_kernel(
        x_ptr, g_ptr, w_ptr, b_ptr, mean_ptr, rstd_ptr, dx_ptr, dw_ptr, db_ptr,
        hw, cg, groups, channels, n,
        SILU: tl.constexpr, BLOCK_C: tl.constexpr, BLOCK_HW: tl.constexpr,
    ):
        pid = tl.program_id(0)  # image * groups + group
        img = pid // groups
        grp = pid % groups
        base = pid.to(tl.int64) * cg * hw
        mean = tl.load(mean_ptr + pid)
        rstd = tl.load(rstd_ptr + pid)
        c_offs = tl.arange(0, BLOCK_C)
        c_m = c_offs < cg
        ch = grp * cg + c_offs
        wv = tl.load(w_ptr + ch, mask=c_m, other=0.0).to(tl.float32)
        bv = tl.load(b_ptr + ch, mask=c_m, other=0.0).to(tl.float32)
        p_offs = tl.arange(0, BLOCK_HW)
        acc_db = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
        acc_dg = tl.zeros([BLOCK_C, BLOCK_HW], dtype=tl.float32)
        for start in range(0, hw, BLOCK_HW):
            p = start + p_offs
            m = c_m[:, None] & (p < hw)[None, :]
            off = base + c_offs[:, None] * hw + p[None, :]
            xv = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            gv = tl.load(g_ptr + off, mask=m, other=0.0).to(tl.float32)
            xh = (xv - mean) * rstd
            if SILU:
                y = xh * wv[:, None] + bv[:, None]
                s = tl.sigmoid(y)
                gv = gv * s * (1.0 + y * (1.0 - s))
            dy = tl.where(m, gv, 0.0)
            acc_db += dy
            acc_dg += dy * xh
        db_c = tl.sum(acc_db, axis=1)  # (BLOCK_C,) per-channel partials
        dg_c = tl.sum(acc_dg, axis=1)
        tl.store(db_ptr + img * channels + ch, db_c, mask=c_m)
        tl.store(dw_ptr + img * channels + ch, dg_c, mask=c_m)
        mean_dyw = tl.sum(db_c * wv, axis=0) / n
        mean_dyw_xh = tl.sum(dg_c * wv, axis=0) / n
        for start in range(0, hw, BLOCK_HW):
            p = start + p_offs
            m = c_m[:, None] & (p < hw)[None, :]
            off = base + c_offs[:, None] * hw + p[None, :]
            xv = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            gv = tl.load(g_ptr + off, mask=m, other=0.0).to(tl.float32)
            xh = (xv - mean) * rstd
            if SILU:
                y = xh * wv[:, None] + bv[:, None]
                s = tl.sigmoid(y)
                gv = gv * s * (1.0 + y * (1.0 - s))
            dx = rstd * (gv * wv[:, None] - mean_dyw - xh * mean_dyw_xh)
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=m)

    _kernels = (gn_silu_kernel, gn_silu_bwd_kernel)
    return _kernels


def _check(x, scale, bias, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    if c % groups != 0:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale and bias must have shape ({c},)")


def _check_cuda(x, scale, bias):
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"group_norm_silu: unsupported dtype {x.dtype}")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must lie on x's device")


def group_norm_silu_forward(x, scale, bias, groups: int, eps: float, silu: bool):
    """Launch the forward kernel on CUDA x. Returns (y in x's dtype, fp32
    mean (B*G,), fp32 rstd (B*G,))."""
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    kernel, _ = _build_kernels()
    b, c, h, w = x.shape
    xc = x.contiguous()
    y = torch.empty_like(xc)
    stats = torch.empty((2, b * groups), dtype=torch.float32, device=x.device)
    cg = c // groups
    span = cg * h * w
    block = min(4096, max(128, 1 << (span - 1).bit_length()))
    with torch.cuda.device(x.device):
        kernel[(b * groups,)](
            xc, scale.contiguous(), bias.contiguous(), y, stats[0], stats[1],
            span, h * w, cg, groups, float(eps), SILU=bool(silu), BLOCK=block,
            num_warps=4 if block <= 1024 else 8,
        )
    group_norm_silu.launches += 1
    return y, stats[0], stats[1]


def group_norm_silu_backward(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool):
    """Launch the backward kernel on CUDA tensors. x, grad_out: (B, C, H, W);
    mean, rstd: the forward's fp32 (B*G,) statistics. Returns (dx in x's
    dtype, dscale, dbias in scale's and bias's dtypes)."""
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    if grad_out.shape != x.shape:
        raise ValueError(f"grad_out {tuple(grad_out.shape)} != x {tuple(x.shape)}")
    _, kernel = _build_kernels()
    b, c, h, w = x.shape
    hw = h * w
    cg = c // groups
    xc = x.contiguous()
    gc = grad_out.contiguous()
    dx = torch.empty_like(xc)
    partials = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    block_c = max(2, 1 << (cg - 1).bit_length())
    block_hw = max(16, min(1 << (hw - 1).bit_length(), 4096 // block_c))
    with torch.cuda.device(x.device):
        kernel[(b * groups,)](
            xc, gc, scale.contiguous(), bias.contiguous(), mean, rstd, dx,
            partials[0], partials[1], hw, cg, groups, c, float(cg * hw), SILU=bool(silu),
            BLOCK_C=block_c, BLOCK_HW=block_hw,
            num_warps=4 if block_c * block_hw <= 1024 else 8,
        )
    group_norm_silu_backward.launches += 1
    dscale, dbias = partials.sum(dim=1)  # the (B, C) partials over B
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype)


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, silu):
        y, mean, rstd = group_norm_silu_forward(x, scale, bias, groups, eps, silu)
        ctx.save_for_backward(x, scale, bias, mean, rstd)
        ctx.groups, ctx.silu = groups, silu
        return y

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = group_norm_silu_backward(
            x, scale, bias, grad_out, mean, rstd, ctx.groups, ctx.silu)
        return dx, dscale, dbias, None, None, None


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-5,
    silu: bool = True,
) -> torch.Tensor:
    """Fused GroupNorm + affine + optional SiLU over NCHW x, differentiable.

    CPU tensors take the plain version (its backward is autograd's); CUDA
    tensors launch the Triton forward kernel, and its backward kernel when
    a gradient flows back, or raise."""
    if x.device.type == "cpu":
        _check(x, scale, bias, groups)
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, scale, bias, groups, float(eps), bool(silu))
    return group_norm_silu_forward(x, scale, bias, groups, eps, silu)[0]


#: forward kernel launches since the count was last set to 0 (the plain path adds none)
group_norm_silu.launches = 0
#: backward kernel launches since the count was last set to 0
group_norm_silu_backward.launches = 0
