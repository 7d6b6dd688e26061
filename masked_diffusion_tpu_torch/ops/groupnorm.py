"""GroupNorm (+ affine) (+ SiLU), forward and backward: the CUDA kernels'
wrappers, their launch plan, and their plain PyTorch versions, NCHW.

Replaces the TPU kernel masked_diffusion_tpu/ops/pallas/groupnorm.py:
group_norm_silu (pallas_call at :113, body _gn_silu_kernel :55) and its
custom VJP's backward (_bwd :169, a jnp recompute on the TPU). Every
GroupNorm of the port's UNet goes through `group_norm_silu`.

The kernels are csrc/groupnorm.cu (its header has the design): in NCHW an
(image, group) is a span of C/G * H*W elements, which the kernels read from
device memory once. Spans above 1024 elements take the cluster path: `ctas`
CTAs per span (a thread-block cluster when above 1), each staging its slice
of the span in shared memory and meeting its peers' partial sums through
distributed shared memory, in rank order. Smaller spans take the warp path:
a warp per span, up to eight spans per CTA, the span in registers (the
backward's dy and x^ in shared memory). The backward writes dx, dgamma and
dbeta in one launch: each span's per-channel parts go to a (2, B, C) fp32
scratch, and the last span of a group to finish (a per-group arrival
counter) sums them in image order. The counters are one buffer per
(device, stream), which the kernel leaves at zero: launches on two streams
in flight at once never share one, and launches on one stream run in
order. A CUDA graph's launches use their capture stream's buffer, which must
exist before the capture (`reserve_counters`). Bound: device-memory bytes,
one read of x (and of the incoming gradient) and one write of y (dx).

`gn_plan` is the launch plan, a pure host function the wrappers use and the
CPU tests hold: cluster size, spans per CTA, threads, shared memory, and
whether each CTA's slice stays on chip.

The plain forward transliterates the JAX package's _gn_reference
(groupnorm.py:132-154): fp32 statistics, normalise/affine/SiLU in the input
dtype. The plain backward, `group_norm_silu_backward_plain`, follows the
backward kernel's arithmetic in fp32 (the JAX custom VJP's formula,
groupnorm.py:164-181): per-channel sums of dy and dy * x^, then dx, and
dgamma/dbeta summed over the batch in image order.

`group_norm_silu` is a torch.autograd.Function on CUDA: the forward kernel,
then the backward kernel (`group_norm_silu_backward`). Each has its own
launch count. CPU tensors take the plain forward, and autograd through it.

Split modes, for a span whose rows lie on M ranks (parallel/sp.py): the
same kernels in two passes each, with an all-reduce of a (2, B*G) fp32
tensor between them. Forward: `group_norm_sums` (each span's sums of x and
x^2 over the rank's rows), then `group_norm_apply` (the statistics over the
whole count n*M, y, and the statistics for the backward). Backward:
`group_norm_backward_sums` (dscale and dbias of the rank's rows, and each
span's m1, m2), then `group_norm_backward_apply` (dx). The pair wrappers
`group_norm_split` and `group_norm_split_backward` run both passes around
the caller's all-reduce and count a launch pair each; on CPU tensors every
pass is its plain version (`group_norm_sums_plain`, `group_norm_apply_plain`,
`group_norm_backward_sums_plain`, `group_norm_backward_apply_plain`: the
arithmetic of the plain forward and backward above, taken apart at the
all-reduce). The split passes stage nothing (`gn_plan(..., mode=)`), so the
forward pair reads x twice and the backward pair x and the gradient twice.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from masked_diffusion_tpu_torch.ops import build

SMEM_MAX = 232448  # bytes of shared memory a CTA may use on an H100 (227 KB)
# staged bytes per CTA (forward, backward) up to which a span keeps fewer CTAs;
# a larger span takes the next cluster size. Fewer, larger slices save the
# forward cluster barriers and waves; the backward's CTAs carry twice the
# arithmetic and do better six to an SM (readings in PERF.md)
STAGE_TARGET = (64 * 1024, 32 * 1024)
# staged bytes per CTA (forward, backward) above which a slice is read twice
# from device memory instead of staged
STAGE_MAX = (SMEM_MAX, SMEM_MAX)
STREAM_SLICE = 32768  # elements per CTA, at most, of a slice read twice
WARP_SPAN_MAX = 1024  # spans up to this many elements take the warp path
WARP_LANE_WIDTHS = (2, 8, 32)  # elements a lane holds: the warp kernels' instances
WARP_SPANS = 8  # spans per CTA on the warp path, at most
WARP_MIN_CTAS = 264  # fewer spans per CTA until the launch has two CTAs per SM
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # 16 is above the portable limit of 8
GROUP = 8  # elements of one load group (16 bytes of bf16)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the kernels' modes: the whole span, or the split passes before and after the all-reduce
MODES = {"whole": 0, "sums": 1, "apply": 2}


class GnPlan(NamedTuple):
    ctas: int  # CTAs per span: the cluster size (1: no cluster)
    spans_per_cta: int  # (image, group) spans per CTA: above 1 only on the warp path
    threads: int
    smem: int  # dynamic shared memory bytes per CTA
    on_chip: bool  # each slice held in shared memory or registers; False: read twice
    slice: int  # elements of a span per CTA (the cluster path's slice)
    per_lane: int  # the warp path's elements per lane; 0 on the cluster path
    grid: int  # CTAs of the launch


def gn_slice(span: int, ctas: int) -> int:
    """Elements of a span per CTA: ceil(span / ctas), rounded up to a load
    group; rank r owns [r * slice, min(span, (r + 1) * slice))."""
    per_cta = -(-span // ctas)
    return -(-per_cta // GROUP) * GROUP


def _block_threads(slice_: int) -> int:
    return 512 if slice_ >= 16384 else 256 if slice_ >= 8192 else 128


def _float_bytes(cg: int, threads: int) -> int:
    """The cluster path's float region (csrc/groupnorm.cu:float_region)."""
    return 4 * (2 * cg * (threads // 32 + 3) + 68)


def gn_plan(b: int, c: int, h: int, w: int, groups: int, dtype: torch.dtype,
            backward: bool, max_cluster: int = 16, mode: str = "whole") -> GnPlan:
    """The launch plan of one forward (or backward) call on (b, c, h, w). A
    split pass (`mode` "sums" or "apply") stages nothing: it takes the whole
    call's path and CTAs a span, its slices read from device memory; an
    apply pass whose whole call takes the warp path runs the cluster path's
    kernel, one CTA a span."""
    if mode not in MODES:
        raise ValueError(f"gn_plan: mode {mode!r} is not one of {sorted(MODES)}")
    cg = c // groups
    span = cg * h * w
    spans = b * groups
    if span <= WARP_SPAN_MAX and mode != "apply":
        per_lane = next(v for v in WARP_LANE_WIDTHS if 32 * v >= span)
        per_cta = WARP_SPANS
        while per_cta > 1 and -(-spans // per_cta) < WARP_MIN_CTAS:
            per_cta //= 2
        # the backward keeps each warp's dy and x^ in shared memory, fp32, a pad
        # word every 32 (csrc/groupnorm.cu:warp_words)
        smem = per_cta * 2 * 33 * per_lane * 4 if backward else 0
        return GnPlan(1, per_cta, 32 * per_cta, smem, True, span, per_lane,
                      -(-spans // per_cta))
    elt = dtype.itemsize
    tensors = 2 if backward else 1
    sizes = [k for k in CLUSTER_SIZES if k <= max_cluster]

    def plan(k: int, staged: bool) -> GnPlan:
        slice_ = gn_slice(span, k)
        threads = _block_threads(slice_)
        tile = tensors * (-(-slice_ * elt // 16) * 16) if staged else 0
        return GnPlan(k, 1, threads, tile + _float_bytes(cg, threads), staged, slice_, 0,
                      spans * k)

    if mode != "whole":  # the whole call's CTAs a span, nothing staged
        return plan(gn_plan(b, c, h, w, groups, dtype, backward, max_cluster).ctas, False)
    for k in sizes:  # the smallest cluster whose slices are within the target
        p = plan(k, True)
        if k <= 8 and p.smem - _float_bytes(cg, p.threads) <= STAGE_TARGET[backward]:
            return p
    for k in sizes:  # else the smallest whose slices fit at all
        p = plan(k, True)
        if p.smem <= SMEM_MAX and p.smem - _float_bytes(cg, p.threads) <= STAGE_MAX[backward]:
            return p
    return plan(next(k for k in sizes if gn_slice(span, k) <= STREAM_SLICE or k == sizes[-1]),
                False)


def _affine_silu(xg, mean, rstd, scale, bias, shape, silu: bool) -> torch.Tensor:
    """The plain normalise, affine and SiLU of x grouped as (B, G, -1), from
    fp32 (B, G, 1) statistics, elementwise in x's dtype."""
    dtype = xg.dtype
    y = (xg - mean.to(dtype)) * rstd.to(dtype)
    y = y.reshape(shape) * scale.to(dtype)[:, None, None] + bias.to(dtype)[:, None, None]
    if silu:
        y = F.silu(y)
    return y.to(dtype)


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
    b = x.shape[0]
    xg = x.reshape(b, groups, -1)
    mean = xg.mean(dim=2, keepdim=True, dtype=torch.float32)
    mean_sq = xg.float().square().mean(dim=2, keepdim=True)
    rstd = torch.rsqrt(mean_sq - mean.square() + eps)
    return _affine_silu(xg, mean, rstd, scale, bias, x.shape, silu)


def group_norm_stats_plain(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """The fp32 (B*G,) mean and rstd that the forward kernel saves."""
    b = x.shape[0]
    xg = x.reshape(b, groups, -1).float()
    mean = xg.mean(dim=2)
    rstd = torch.rsqrt(xg.square().mean(dim=2) - mean.square() + eps)
    return mean.reshape(-1), rstd.reshape(-1)


def group_norm_sums_plain(x: torch.Tensor, groups: int) -> torch.Tensor:
    """The split forward's first pass: each (image, group)'s fp32 sum of x
    and of x^2 over x's rows, (2, B*G)."""
    b = x.shape[0]
    xg = x.reshape(b, groups, -1)
    return torch.stack([xg.sum(dim=2, dtype=torch.float32),
                        xg.float().square().sum(dim=2)]).reshape(2, b * groups)


def group_norm_apply_plain(x, scale, bias, sums, count: float, groups: int,
                           eps: float = 1e-5, silu: bool = True):
    """The split forward's second pass: GroupNorm(+SiLU) of x's rows with the
    statistics of `sums` (the all-reduced group_norm_sums_plain) over `count`
    elements a span, as group_norm_silu_plain normalises. Returns (y in x's
    dtype, fp32 mean (B*G,), fp32 rstd (B*G,))."""
    b = x.shape[0]
    mean, mean_sq = (sums / count).reshape(2, b, groups, 1)
    rstd = torch.rsqrt(mean_sq - mean.square() + eps)
    y = _affine_silu(x.reshape(b, groups, -1), mean, rstd, scale, bias, x.shape, silu)
    return y, mean.reshape(-1), rstd.reshape(-1)


def _backward_terms(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool):
    """fp32 x^ and dy (the gradient through SiLU), (B, G, C/G, H*W), and
    gamma (1, G, C/G, 1), from the forward's (B*G,) statistics."""
    b, c, h, w = x.shape
    cg = c // groups
    xh = (x.float().reshape(b, groups, cg, h * w) - mean.reshape(b, groups, 1, 1)) \
        * rstd.reshape(b, groups, 1, 1)
    gam = scale.float().reshape(1, groups, cg, 1)
    dy = grad_out.float().reshape(b, groups, cg, h * w)
    if silu:
        y = xh * gam + bias.float().reshape(1, groups, cg, 1)
        s = torch.sigmoid(y)
        dy = dy * s * (1 + y * (1 - s))
    return xh, gam, dy


def _params_in_image_order(dg, db, scale, bias):
    """dscale, dbias: the (B, G, C/G) parts summed over images in image
    order, as the kernel sums them, in scale's and bias's dtypes."""
    c = scale.shape[0]
    dscale, dbias = dg[0].reshape(c).clone(), db[0].reshape(c).clone()
    for i in range(1, dg.shape[0]):
        dscale += dg[i].reshape(c)
        dbias += db[i].reshape(c)
    return dscale.to(scale.dtype), dbias.to(bias.dtype)


def group_norm_silu_backward_plain(x, scale, bias, grad_out, mean, rstd, groups: int,
                                   silu: bool):
    """The backward kernel's arithmetic in fp32: per-channel sums of dy and
    dy * x^, then dx (in x's dtype), and dscale, dbias summed over the batch
    in image order (in scale's and bias's dtypes). mean, rstd: the forward's
    fp32 (B*G,) statistics."""
    b, c, h, w = x.shape
    xh, gam, dy = _backward_terms(x, scale, bias, grad_out, mean, rstd, groups, silu)
    db = dy.sum(dim=3)  # (B, G, cg): the (image, channel) parts of dbias
    dg = (dy * xh).sum(dim=3)  # and of dscale
    n = (c // groups) * h * w
    m1 = (db * gam[..., 0]).sum(dim=2)[..., None, None] / n
    m2 = (dg * gam[..., 0]).sum(dim=2)[..., None, None] / n
    dx = rstd.reshape(b, groups, 1, 1) * (dy * gam - m1 - xh * m2)
    return (dx.reshape(b, c, h, w).to(x.dtype), *_params_in_image_order(dg, db, scale, bias))


def group_norm_backward_sums_plain(x, scale, bias, grad_out, mean, rstd, groups: int,
                                   silu: bool):
    """The split backward's first pass, from the forward's global (B*G,)
    statistics: (fp32 (2, B*G) of each span's m1 = sum_c gamma_c Sdy_c and
    m2 = sum_c gamma_c Sdy*x^_c over x's rows, undivided; dscale; dbias),
    dscale and dbias those rows' share, as group_norm_silu_backward_plain
    sums them."""
    xh, gam, dy = _backward_terms(x, scale, bias, grad_out, mean, rstd, groups, silu)
    db = dy.sum(dim=3)
    dg = (dy * xh).sum(dim=3)
    sums = torch.stack([(db * gam[..., 0]).sum(dim=2), (dg * gam[..., 0]).sum(dim=2)])
    return (sums.reshape(2, -1), *_params_in_image_order(dg, db, scale, bias))


def group_norm_backward_apply_plain(x, scale, bias, grad_out, mean, rstd, sums,
                                    count: float, groups: int, silu: bool) -> torch.Tensor:
    """The split backward's second pass: dx (in x's dtype) from the
    all-reduced group_norm_backward_sums_plain over `count` elements a span."""
    b, c, h, w = x.shape
    xh, gam, dy = _backward_terms(x, scale, bias, grad_out, mean, rstd, groups, silu)
    m1, m2 = (sums / count).reshape(2, b, groups, 1, 1)
    dx = rstd.reshape(b, groups, 1, 1) * (dy * gam - m1 - xh * m2)
    return dx.reshape(b, c, h, w).to(x.dtype)


def _check_x(x, groups):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.shape[1] % groups != 0:
        raise ValueError(f"{x.shape[1]} channels do not split into {groups} groups")


def _check(x, scale, bias, groups):
    _check_x(x, groups)
    c = x.shape[1]
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"scale and bias must have shape ({c},)")


def _check_cuda_x(x):
    if x.device.type != "cuda":
        raise RuntimeError(f"group_norm_silu: no kernel for {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_silu: unsupported dtype {x.dtype}")


def _check_cuda(x, scale, bias):
    _check_cuda_x(x)
    if scale.dtype not in _DTYPES or bias.dtype != scale.dtype:
        raise TypeError(f"group_norm_silu: scale {scale.dtype} and bias {bias.dtype} "
                        "must share one of float32, bfloat16, float16")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("scale and bias must lie on x's device")
    if not (scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError("scale and bias must be contiguous")


def _flat_strides(t: torch.Tensor, what: str):
    """(image, channel, pixel) strides of a (B, C, H, W) tensor whose H*W
    run flattens to one stride; anything else raises."""
    sb, sc, sh, sw = t.stride()
    h, w = t.shape[2], t.shape[3]
    if w == 1:
        sp = sh
    elif h == 1 or sh == w * sw:
        sp = sw
    else:
        raise ValueError(f"group_norm_silu: {what} with strides {t.stride()} has no "
                         "flat H*W run; the kernels do not take that layout")
    return sb, sc, sp


_max_clusters: dict = {}  # (backward, dtype, ctas, threads, smem) -> resident clusters
# (device, stream handle) -> the backward's per-group arrival counters (int32)
_counters: dict = {}
COUNTERS_MIN = 64  # groups the counters of a stream cover at least


def reserve_counters(device: torch.device, stream=None, groups: int = COUNTERS_MIN):
    """The backward's arrival counters of `stream` (default: the device's
    current stream), made now if missing or too short. A CUDA graph's
    captured backward launches use the capture stream's counters; call this
    (or run the backward once on that stream) before the capture."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    if stream is None:
        stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < groups:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "group_norm_silu_backward: no arrival counters for the stream under capture; "
                "reserve them (ops/groupnorm.py:reserve_counters) before capturing")
        counters = torch.zeros(max(groups, COUNTERS_MIN), dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


def max_active_clusters(backward: bool, dtype: torch.dtype, plan: GnPlan) -> int:
    """cudaOccupancyMaxActiveClusters for a cluster-path plan on the current
    card: 0 means the cluster size cannot be scheduled."""
    key = (backward, dtype, plan.ctas, plan.threads, plan.smem)
    if key not in _max_clusters:
        import ctypes

        lib = build.load_library()
        out = ctypes.c_int(0)
        code = lib.mdt_group_norm_max_clusters(int(backward), _DTYPES[dtype], plan.ctas,
                                               plan.threads, plan.smem, ctypes.byref(out))
        build.check(lib, code, "group_norm_silu: cluster occupancy")
        _max_clusters[key] = out.value
    return _max_clusters[key]


@functools.lru_cache(maxsize=None)
def _cuda_plan(b: int, c: int, h: int, w: int, groups: int, dtype: torch.dtype,
               backward: bool, mode: str = "whole") -> GnPlan:
    """gn_plan, without the cluster of 16 where this card cannot schedule it
    (the apply passes launch no cluster)."""
    plan = gn_plan(b, c, h, w, groups, dtype, backward, mode=mode)
    if plan.ctas == 16 and mode != "apply" and max_active_clusters(backward, dtype, plan) == 0:
        plan = gn_plan(b, c, h, w, groups, dtype, backward, max_cluster=8, mode=mode)
    return plan


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_forward(x, scale, bias, groups: int, eps: float, silu: bool, mode: str,
                    y=None, mean=None, rstd=None, sums=None, count: float = 0.0):
    """One launch of the forward kernel in `mode` on CUDA x (any image and
    channel strides with a flat H*W run), into the given outputs."""
    b, c, h, w = x.shape
    xs = _flat_strides(x, "x")
    plan = _cuda_plan(b, c, h, w, groups, x.dtype, False, mode)
    lib = build.load_library()
    with torch.cuda.device(x.device):
        code = lib.mdt_group_norm_fwd(
            x.data_ptr(), _ptr(scale), _ptr(bias), _ptr(y), _ptr(mean), _ptr(rstd),
            b, c, h * w, groups, *xs, float(eps), int(silu), _DTYPES[x.dtype],
            _DTYPES[scale.dtype] if scale is not None else 0, plan.ctas, plan.per_lane,
            plan.threads, plan.smem, int(plan.on_chip), MODES[mode], _ptr(sums), float(count),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "group_norm_silu" if mode == "whole" else f"group_norm_{mode}")


def _check_backward(x, scale, bias, grad_out, mean, rstd, groups):
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    if grad_out.shape != x.shape or grad_out.dtype != x.dtype or grad_out.device != x.device:
        raise ValueError(f"grad_out {grad_out.dtype} {tuple(grad_out.shape)} on "
                         f"{grad_out.device} does not match x {x.dtype} {tuple(x.shape)}")
    n = x.shape[0] * groups
    for t, what in ((mean, "mean"), (rstd, "rstd")):
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"{what} must be a contiguous fp32 ({n},) tensor")


def _check_sums(sums, x, groups):
    want = (2, x.shape[0] * groups)
    if (sums.dtype != torch.float32 or tuple(sums.shape) != want or not sums.is_contiguous()
            or sums.device != x.device):
        raise ValueError(f"sums must be a contiguous fp32 {want} tensor on {x.device}, got "
                         f"{sums.dtype} {tuple(sums.shape)} on {sums.device}")


def _launch_backward(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool, mode: str,
                     dx=None, dscale=None, dbias=None, sums=None, count: float = 0.0):
    """One launch of the backward kernel in `mode` on CUDA tensors checked by
    _check_backward, into the given outputs; the whole and sums passes take
    a (2, B, C) fp32 scratch and the stream's arrival counters."""
    b, c, h, w = x.shape
    xs = _flat_strides(x, "x")
    gs = _flat_strides(grad_out, "grad_out")
    plan = _cuda_plan(b, c, h, w, groups, x.dtype, True, mode)
    lib = build.load_library()
    parts = counters = None
    if mode != "apply":
        parts = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        if mode != "apply":
            counters = reserve_counters(x.device, groups=groups)
        code = lib.mdt_group_norm_bwd(
            x.data_ptr(), grad_out.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), _ptr(dx), _ptr(dscale), _ptr(dbias),
            _ptr(parts), _ptr(counters), b, c, h * w, groups, *xs, *gs, int(silu),
            _DTYPES[x.dtype], _DTYPES[scale.dtype], plan.ctas, plan.per_lane, plan.threads,
            plan.smem, int(plan.on_chip), MODES[mode], _ptr(sums), float(count),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "group_norm_silu_backward" if mode == "whole"
                else f"group_norm_backward_{mode}")


def group_norm_silu_forward(x, scale, bias, groups: int, eps: float, silu: bool,
                            stats: bool = True):
    """Launch the forward kernel on CUDA x (any image and channel strides
    with a flat H*W run). Returns (y in x's dtype, contiguous; fp32 mean
    (B*G,); fp32 rstd (B*G,)), the statistics None when not `stats`."""
    _check(x, scale, bias, groups)
    _check_cuda(x, scale, bias)
    b = x.shape[0]
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    mean = rstd = None
    if stats:
        st = torch.empty((2, b * groups), dtype=torch.float32, device=x.device)
        mean, rstd = st[0], st[1]
    _launch_forward(x, scale, bias, groups, eps, silu, "whole", y, mean, rstd)
    group_norm_silu.launches += 1
    return y, mean, rstd


def group_norm_silu_backward(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool):
    """Launch the backward kernel on CUDA tensors: dx, dscale and dbias in
    one launch. x, grad_out: (B, C, H, W), any image and channel strides
    with a flat H*W run (a gradient that is not contiguous is counted in
    `.strided`); mean, rstd: the forward's fp32 (B*G,) statistics. Returns
    (dx in x's dtype, contiguous; dscale, dbias in scale's dtype)."""
    _check_backward(x, scale, bias, grad_out, mean, rstd, groups)
    if not grad_out.is_contiguous():
        group_norm_silu_backward.strided += 1
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dscale = torch.empty(scale.shape, dtype=scale.dtype, device=x.device)
    dbias = torch.empty(scale.shape, dtype=scale.dtype, device=x.device)
    _launch_backward(x, scale, bias, grad_out, mean, rstd, groups, silu, "whole", dx, dscale,
                     dbias)
    group_norm_silu_backward.launches += 1
    return dx, dscale, dbias


def group_norm_sums(x, groups: int) -> torch.Tensor:
    """The split forward's first pass: each (image, group)'s fp32 sum of x
    and of x^2 over x's rows, (2, B*G). The kernel on CUDA x, the plain
    version on the CPU."""
    _check_x(x, groups)
    if x.device.type == "cpu":
        return group_norm_sums_plain(x, groups)
    _check_cuda_x(x)
    sums = torch.empty((2, x.shape[0] * groups), dtype=torch.float32, device=x.device)
    _launch_forward(x, None, None, groups, 0.0, False, "sums", sums=sums)
    return sums


def group_norm_apply(x, scale, bias, sums, count: float, groups: int, eps: float, silu: bool):
    """The split forward's second pass: y of x's rows with the statistics of
    the all-reduced `sums` over `count` elements a span. Returns (y in x's
    dtype; fp32 mean (B*G,); fp32 rstd (B*G,)). The kernel on CUDA x, the
    plain version on the CPU."""
    _check(x, scale, bias, groups)
    if x.device.type == "cpu":
        return group_norm_apply_plain(x, scale, bias, sums, count, groups, eps, silu)
    _check_cuda(x, scale, bias)
    _check_sums(sums, x, groups)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    st = torch.empty((2, x.shape[0] * groups), dtype=torch.float32, device=x.device)
    _launch_forward(x, scale, bias, groups, eps, silu, "apply", y, st[0], st[1], sums, count)
    return y, st[0], st[1]


def group_norm_backward_sums(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool):
    """The split backward's first pass, from the forward's global fp32 (B*G,)
    statistics. Returns (fp32 (2, B*G) of each span's undivided m1 and m2
    over x's rows; dscale and dbias of those rows, in scale's dtype). The
    kernel on CUDA tensors, the plain version on the CPU."""
    if x.device.type == "cpu":
        _check(x, scale, bias, groups)
        return group_norm_backward_sums_plain(x, scale, bias, grad_out, mean, rstd, groups,
                                              silu)
    _check_backward(x, scale, bias, grad_out, mean, rstd, groups)
    sums = torch.empty((2, x.shape[0] * groups), dtype=torch.float32, device=x.device)
    dscale = torch.empty(scale.shape, dtype=scale.dtype, device=x.device)
    dbias = torch.empty(scale.shape, dtype=scale.dtype, device=x.device)
    _launch_backward(x, scale, bias, grad_out, mean, rstd, groups, silu, "sums",
                     dscale=dscale, dbias=dbias, sums=sums)
    return sums, dscale, dbias


def group_norm_backward_apply(x, scale, bias, grad_out, mean, rstd, sums, count: float,
                              groups: int, silu: bool) -> torch.Tensor:
    """The split backward's second pass: dx (in x's dtype) from the
    all-reduced group_norm_backward_sums over `count` elements a span. The
    kernel on CUDA tensors, the plain version on the CPU."""
    if x.device.type == "cpu":
        _check(x, scale, bias, groups)
        return group_norm_backward_apply_plain(x, scale, bias, grad_out, mean, rstd, sums,
                                               count, groups, silu)
    _check_backward(x, scale, bias, grad_out, mean, rstd, groups)
    _check_sums(sums, x, groups)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _launch_backward(x, scale, bias, grad_out, mean, rstd, groups, silu, "apply", dx=dx,
                     sums=sums, count=count)
    return dx


def _split_count(x, groups: int, pieces: int) -> float:
    """Elements of a span over all `pieces` row pieces of the image."""
    return float(pieces * (x.shape[1] // groups) * x.shape[2] * x.shape[3])


def group_norm_split(x, scale, bias, groups: int, eps: float, silu: bool, reduce,
                     pieces: int):
    """GroupNorm(+SiLU) of x's rows, one of `pieces` equal row pieces of an
    image, with the whole image's statistics: group_norm_sums, then
    `reduce` (the all-reduce of the (2, B*G) fp32 sums over the pieces),
    then group_norm_apply. Returns (y, fp32 mean (B*G,), fp32 rstd (B*G,)).
    On CUDA one launch pair, counted in `.launches`."""
    sums = reduce(group_norm_sums(x, groups))
    out = group_norm_apply(x, scale, bias, sums, _split_count(x, groups, pieces), groups, eps,
                           silu)
    if x.device.type == "cuda":
        group_norm_split.launches += 1
    return out


def group_norm_split_backward(x, scale, bias, grad_out, mean, rstd, groups: int, silu: bool,
                              reduce, pieces: int):
    """The gradient of group_norm_split from its saved global statistics:
    group_norm_backward_sums, `reduce` of its (2, B*G) m1 and m2, then
    group_norm_backward_apply. Returns (dx; dscale, dbias of x's rows). On
    CUDA one launch pair, counted in `.launches`."""
    sums, dscale, dbias = group_norm_backward_sums(x, scale, bias, grad_out, mean, rstd,
                                                   groups, silu)
    dx = group_norm_backward_apply(x, scale, bias, grad_out, mean, rstd, reduce(sums),
                                   _split_count(x, groups, pieces), groups, silu)
    if x.device.type == "cuda":
        group_norm_split_backward.launches += 1
    return dx, dscale, dbias


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
    tensors launch the forward kernel, and the backward kernel when a
    gradient flows back, or raise."""
    if x.device.type == "cpu":
        _check(x, scale, bias, groups)
        return group_norm_silu_plain(x, scale, bias, groups, eps, silu)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNormSiLU.apply(x, scale, bias, groups, float(eps), bool(silu))
    return group_norm_silu_forward(x, scale, bias, groups, eps, silu, stats=False)[0]


#: forward kernel launches since the count was last set to 0 (the plain path adds none)
group_norm_silu.launches = 0
#: backward kernel launches since the count was last set to 0
group_norm_silu_backward.launches = 0
#: backward calls whose incoming gradient was not contiguous (the kernel takes its strides)
group_norm_silu_backward.strided = 0
#: split forward launch pairs (sums, apply) since the count was last set to 0
group_norm_split.launches = 0
#: split backward launch pairs since the count was last set to 0
group_norm_split_backward.launches = 0
