"""One torch.profiler window of a train step on the card.

    python -m masked_diffusion_tpu_torch.tools.profile_train [--config flagship]
        [--mixed_precision bf16] [--steps 5] [--out FILE]
    python -m masked_diffusion_tpu_torch.tools.profile_train --compare A.json B.json

Builds a UNet and the port's train step (AdamW + cosine at lr 1e-4, EMA on,
mean_shift with a 1-d_constant shift) at --mixed_precision (bf16, the
default, or no: fp32, the CLI's default). --config picks it:

  flagship   the factory default (113.7M parameters) at 64x64x3, batch 64,
             linear+thresholding (T=1000) and log+indexing (T=4096)
  celeba_hq  --num_attention 5 at 64x64x3, batch 32, log+indexing at T=16
             (scripts/train/celeba_hq/base/script_main.sh)
  unet6_256  the zoo's unet6 at 256x256x3, batch 8, log+indexing at T=16

Per mode: the wall time per step over 20 steps without the profiler, and
over the same steps the host time spent inside the GroupNorm wrappers
(ops/groupnorm.py: group_norm_silu_forward and group_norm_silu_backward,
timed by wrapping them) with the count of their calls whose x or incoming
gradient was not contiguous (a wrapper that copies such a tensor copies it
there); then a profiled window of --steps steps after a warm-up. From the
window: wall and device-busy ms per step, the device's idle share, the
kernels run per step, the top kernels by device time, with the device ms
and shares of the port's own kernels (GroupNorm forward and backward,
exact-k masks, tiny-head attention), the host operators with the most
self CPU time, and per step every kernel's and every host operator's calls
and the host's launch calls (cudaLaunchKernel, cuLaunchKernelEx, ...) by
name.
Prints one JSON object per mode and writes them all to --out (default
build/profile_train_<config>.json, or _<config>_fp32.json at
--mixed_precision no). Needs CUDA.

--compare reads two such files (say, the parent tree's and a change's,
both written by this script back to back on one card) and prints, per
mode, both wall times, device-busy ms, the port's own kernels' ms and
shares and launch counts a step, and the kernels and host operators whose
calls a step differ most: where the launches went.

The script imports only what every tree since the port's train step has
(make_train_step, create_train_state, build_optimizer), so it also
profiles another checkout of the package: run it from that checkout's
root with PYTHONPATH=. and this file's path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from masked_diffusion_tpu_torch.utils.profiling import device_rows

# kernel name fragments of the port's own kernels (the GroupNorm kernels'
# CUDA names, and the Triton names they had before, for runs on older trees)
OWN = {"gn_fwd": ("gn_fwd_", "gn_silu_kernel"), "gn_bwd": ("gn_bwd_", "gn_silu_bwd_kernel"),
       "kmask": ("kmask_kernel",), "tinyhead": ("tinyhead_fwd",),
       "tinyhead_bwd": ("tinyhead_bwd",)}
# the host's launch calls, by the CUDA runtime's and driver's names
HOST_LAUNCHES = ("cudaGraphLaunch", "cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")
# name: (zoo name, --num_attention, image size, batch, [(schedule, selection, T)])
CONFIGS = {
    "flagship": ("default", 1, 64, 64, (("linear", "thresholding", 1000),
                                        ("log", "indexing", 4096))),
    "celeba_hq": ("default", 5, 64, 32, (("log", "indexing", 16),)),
    "unet6_256": ("unet6", 1, 256, 8, (("log", "indexing", 16),)),
}


def _host_rows(prof, steps: int, top: int = 12):
    """The host operators with the most self CPU time per step: where the
    host's share of the wall time goes."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    rows.sort(key=lambda r: -r[1])
    return [{"name": n[:120], "self_cpu_ms_per_step": t, "calls_per_step": c}
            for n, t, c in rows[:top]]


def _host_counts(prof, steps: int):
    """({host operator: calls a step}, {launch call: calls a step}) of the
    window's CPU events."""
    from torch.autograd import DeviceType

    ops, launches = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CPU:
            continue
        table = launches if e.key.startswith(HOST_LAUNCHES) else ops
        table[e.key[:120]] = e.count / steps
    return ops, launches


def _timed_wrappers():
    """Wrap the GroupNorm wrappers in ops/groupnorm.py with host timers: the
    module's own calls (the autograd Function, the no-grad path) look them
    up by name. Returns (stats dict, restore function)."""
    import functools

    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    stats = {"host_s": 0.0, "calls": 0, "strided_inputs": 0}
    saved = {}
    # name: positions of the tensors whose layout a wrapper may have to copy
    for name, checked in (("group_norm_silu_forward", (0,)), ("group_norm_silu_backward", (0, 3))):
        fn = getattr(gn, name)
        saved[name] = fn

        def timed(*args, _fn=fn, _checked=checked, **kwargs):
            stats["strided_inputs"] += sum(not args[i].is_contiguous() for i in _checked)
            t0 = time.perf_counter()
            out = _fn(*args, **kwargs)
            stats["host_s"] += time.perf_counter() - t0
            stats["calls"] += 1
            return out

        setattr(gn, name, functools.wraps(fn)(timed))

    def restore():
        for name, fn in saved.items():
            setattr(gn, name, fn)

    return stats, restore


def profile_mode(config: str, sched: str, select: str, t_steps: int, steps: int,
                 precision: str = "bf16") -> dict:
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.zoo import Model
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import create_train_state, make_train_step

    name, num_attention, size, batch, _ = CONFIGS[config]
    cfg, _ = parse([
        "--method", "mean_shift", "--data_size", str(size), "--ddpm_schedule", sched,
        "--ddpm_num_steps", str(t_steps), "--select_degrade_pixel", select,
        "--mean_option", "degraded_area", "--shift_type", "1-d_constant",
        "--mixed_precision", precision, "--optim", "adamw", "--lr_scheduler", "cosine",
        "--lr", "1e-4", "--lr_warmup_steps", "0",
    ])
    schedule = build_schedule(sched, t_steps, size, select)
    used = schedule.timesteps_for_epoch(0, 10, 1)
    torch.manual_seed(0)
    model = (build_unet(3, size, size, num_attention) if name == "default"
             else Model(name, 3, size, size))
    lr = build_lr_schedule("cosine", 1e-4, 0, 1000)
    opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 1)
    state = create_train_state(model, opt, use_ema=True)
    step = make_train_step(model, schedule, cfg, opt, used, lr, device="cuda")
    data = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (batch, size, size, 3)).astype(np.float32)).cuda()
    gen = torch.Generator().manual_seed(0)
    for _ in range(5):
        step(state, data, gen)
    torch.cuda.synchronize()
    gn_host, restore = _timed_wrappers()
    t0 = time.perf_counter()
    for _ in range(20):
        step(state, data, gen)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / 20
    restore()

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, data, gen)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0) / steps
    rows = device_rows(prof)
    host_ops, host_launches = _host_counts(prof, steps)
    busy = sum(r[1] for r in rows) / steps
    own = {k: sum(r[1] for r in rows if any(f in r[0] for f in frags)) / steps
           for k, frags in OWN.items()}
    return {
        "config": config, "mode": f"{sched}+{select}", "precision": precision, "batch": batch,
        "size": size,
        "steps_profiled": steps,
        "wall_ms_per_step": wall_ms, "profiled_wall_ms_per_step": window_ms,
        "device_busy_ms_per_step": busy,
        # against the profiled window's wall, and against the wall without
        # the profiler (whose host overhead lengthens the window)
        "idle_share": max(0.0, 1.0 - busy / window_ms),
        "idle_share_unprofiled": max(0.0, 1.0 - busy / wall_ms),
        "kernels_per_step": sum(r[2] for r in rows) / steps,
        "own_kernels_ms_per_step": own,
        "own_kernels_share": {k: v / busy for k, v in own.items()},
        "own_kernels_per_step": {k: sum(r[2] for r in rows if any(f in r[0] for f in frags))
                                 / steps for k, frags in OWN.items()},
        # host time inside the GroupNorm wrappers, per step, over the 20 unprofiled steps
        "gn_wrapper_host_ms_per_step": 1e3 * gn_host["host_s"] / 20,
        "gn_wrapper_calls_per_step": gn_host["calls"] / 20,
        "gn_strided_inputs_per_step": gn_host["strided_inputs"] / 20,
        "top": [{"name": n[:120], "ms_per_step": t / steps, "share": t / steps / busy,
                 "calls_per_step": c / steps} for n, t, c in rows[:15]],
        "host_top": _host_rows(prof, steps),
        "host_launches_per_step": sum(v for k, v in host_launches.items()
                                      if k.startswith(("cudaLaunch", "cuLaunch"))),
        "host_calls_per_step": host_launches,
        "kernel_calls_per_step": {n[:160]: c / steps for n, _, c in rows},
        "host_op_calls_per_step": host_ops,
    }


def compare(path_a: str, path_b: str, top: int = 20) -> list:
    """Per mode in both files: the wall ms and launches a step of each and
    the kernels and host operators whose calls a step differ most (b - a)."""
    with open(path_a) as f:
        a = {r["mode"]: r for r in json.load(f)}
    with open(path_b) as f:
        b = {r["mode"]: r for r in json.load(f)}

    def diff(key, ra, rb):
        x, y = ra.get(key, {}), rb.get(key, {})
        d = {n: y.get(n, 0.0) - x.get(n, 0.0) for n in set(x) | set(y)}
        d = sorted(((n, v) for n, v in d.items() if abs(v) > 1e-9), key=lambda r: -abs(r[1]))
        return [{"name": n, "a": x.get(n, 0.0), "b": y.get(n, 0.0), "b_minus_a": v}
                for n, v in d[:top]]

    out = []
    for mode in a:
        if mode not in b:
            continue
        ra, rb = a[mode], b[mode]
        row = {"mode": mode, "a": path_a, "b": path_b, "card": [ra.get("card"), rb.get("card")]}
        for key in ("wall_ms_per_step", "device_busy_ms_per_step", "idle_share_unprofiled",
                    "kernels_per_step", "host_launches_per_step", "own_kernels_ms_per_step",
                    "own_kernels_share"):
            row[key] = [ra.get(key), rb.get(key)]
        row["kernels"] = diff("kernel_calls_per_step", ra, rb)
        row["host_ops"] = diff("host_op_calls_per_step", ra, rb)
        row["host_calls"] = diff("host_calls_per_step", ra, rb)
        out.append(row)
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", choices=sorted(CONFIGS), default="flagship")
    p.add_argument("--mixed_precision", choices=("bf16", "no"), default="bf16",
                   help="the step's precision: bf16 autocast, or no (fp32)")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None)
    p.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                   help="two files this script wrote: print where their steps differ")
    args = p.parse_args(argv)
    if args.compare:
        for row in compare(*args.compare):
            print(json.dumps(row), flush=True)
        return 0
    tag = "" if args.mixed_precision == "bf16" else "_fp32"
    out = args.out or os.path.join("build", f"profile_train_{args.config}{tag}.json")
    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    results = []
    for sched, select, t_steps in CONFIGS[args.config][4]:
        r = profile_mode(args.config, sched, select, t_steps, args.steps, args.mixed_precision)
        r["card"] = card
        results.append(r)
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
