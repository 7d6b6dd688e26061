#!/usr/bin/env python3
"""Smoke check of the PyTorch port (masked_diffusion_tpu_torch) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and triton. It builds the port's kernels from the checkout's sources,
holds each against its plain PyTorch version on the card, checks the
sampling slice against the plain CPU path, and serves images through the
port's CLI at the flagship width. Every phase raises on failure. Phases:

  1. environment: card name and power limit, torch/CUDA versions, build time
  2. fused degrade kernel vs its plain version, explicit bits (64x64x3,
     batch 64); then its Philox path's exact counts and kept share
  3. GroupNorm(+SiLU) kernel vs its plain version at every (C, H, W) the
     flagship UNet normalises, fp32 and bf16, with both times
  4. slice parity: the sampler with both kernels on CUDA vs the plain
     versions on the CPU, same weights and draws, fp32 with TF32 off
  5. serving through the CLI: a seeded random flagship checkpoint, two
     requests of 16 images at 64x64 in bf16, linear+thresholding (100
     steps) and log+indexing (200 steps); kernel launch counts checked

Its last two lines are one JSON object of kernel results and
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints neither.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B_KERNEL = 64  # the bench's batch (bench.py BENCH_BATCH)
SIZE = 64
FUSED_TOL = 1e-6  # kernel and plain differ only in the masked sums' order
GN_TOL = {"float32": (1e-5, 1e-5),  # (atol, rtol): fp32 sums in another order
          "bfloat16": (8e-2, 2e-2)}  # plain rounds each op to bf16, the kernel once
SLICE_TOL = 2e-3  # atol = rtol: cuDNN vs CPU conv sums over a 113.7M-param UNet, 10 steps


def log(msg: str) -> None:
    print(msg, flush=True)


def _event_ms(run, iters: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms(fn, reps: int = 20, iters: int = 10):
    """(device ms, eager ms) of one fn() call. Device: `reps` calls captured
    in a CUDA graph and replayed `iters` times, so no host launch cost
    enters; eager: back-to-back calls, host launch cost included."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture (compiles, plans)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    device = _event_ms(graph.replay, iters) / reps
    return device, _event_ms(fn, reps * iters)


def phase_env():
    import torch

    from masked_diffusion_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    build.load_library()
    log(f"[1] fused_degrade.cu built and loaded in {time.perf_counter() - t0:.2f} s "
        f"-> {os.path.relpath(build.library_path(), ROOT)}")
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"[1]   ptxas: {line.strip()}")
    return smi


def phase_fused():
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.ops.fused_degrade import fused_degrade_update, fused_rows

    dev = torch.device("cuda")
    b, c, hw = B_KERNEL, 3, SIZE * SIZE
    rng = np.random.default_rng(0)
    bits_np = rng.integers(0, 2**32, size=(2, b, hw), dtype=np.uint64).astype(np.int64)
    bits_np[:, 8:16] &= 0xE0000000  # 8 values of top bits: heavy ties for exact k
    bits = torch.from_numpy(bits_np).to(dev)
    xt = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    x0 = torch.from_numpy(rng.normal(size=(b, c, SIZE, SIZE)).astype(np.float32)).to(dev)
    counts = rng.integers(0, hw + 1, size=(2, b)).astype(np.float32)
    counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3] = 0, hw, 1, hw - 1  # k=0, k=HW
    ratios = rng.uniform(0, 1, size=(2, b)).astype(np.float32)
    ratios[:, 0], ratios[:, 1] = 0.0, 1.0
    worst = 0.0
    for select, amounts in (("thresholding", ratios), ("indexing", counts)):
        amt = torch.from_numpy(amounts).to(dev)
        for rule in ("base_momentum", "base_sampling"):
            for mean_mode, mean_value in (("degraded_area", 0.0), ("const", 0.25)):
                kw = dict(select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule)
                out, mask = fused_degrade_update(xt, x0, amt[0], amt[1], bits=bits, **kw)
                ref_out, ref_mask = fused_rows(
                    bits[0], bits[1], xt.reshape(b, -1), x0.reshape(b, -1),
                    amt[0][:, None], amt[1][:, None], channels=c, **kw,
                )
                torch.cuda.synchronize()
                if not torch.equal(mask.reshape(b, hw), ref_mask):
                    raise AssertionError(f"fused_degrade {kw}: masks differ from the plain version")
                err = (out.reshape(b, -1) - ref_out).abs().max().item()
                worst = max(worst, err)
                if not err <= FUSED_TOL:
                    raise AssertionError(f"fused_degrade {kw}: max |out - plain| {err} > {FUSED_TOL}")
    log(f"[2] fused_degrade: 8 mode cases x (k=0, k=HW, ties) at {b}x{SIZE}x{SIZE}x{c}: "
        f"masks bitwise equal, max |out - plain| = {worst:.3g} (tol {FUSED_TOL})")

    # Philox path: exact k (indexing) and the kept share (thresholding)
    k = torch.from_numpy(counts[1]).to(dev)
    kw = dict(select="indexing", mean_mode="degraded_area", rule="base_momentum")
    _, m1 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=7, **kw)
    _, m2 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=7, **kw)
    _, m3 = fused_degrade_update(xt, x0, k, k, seed=1234, offset=8, **kw)
    degraded = (hw - m1.reshape(b, hw).sum(1)).long()
    if not torch.equal(degraded, k.long()):
        raise AssertionError("fused_degrade Philox indexing: degraded counts != k")
    if not torch.equal(m1, m2) or torch.equal(m1, m3):
        raise AssertionError("fused_degrade Philox: not deterministic per (seed, offset)")
    r = 0.3
    amt = torch.full((b,), r, device=dev)
    _, mt = fused_degrade_update(xt, x0, amt, amt, seed=99, offset=0, select="thresholding",
                                 mean_mode="degraded_area")
    n = b * hw
    kept = mt.sum().item() / n
    sigma = (r * (1 - r) / n) ** 0.5
    if abs(kept - (1 - r)) > 3 * sigma:
        raise AssertionError(f"fused_degrade Philox thresholding: kept {kept} vs {1 - r} +- 3*{sigma}")
    log(f"[2] Philox: exact k in all {b} images; kept share {kept:.5f} vs {1 - r} "
        f"(3 sigma = {3 * sigma:.5f}); deterministic per (seed, offset)")

    # times at the flagship shape, on the main path (Philox bits) vs plain
    # (bits drawn by torch, then the row math)
    times = {}
    for select, amounts in (("thresholding", ratios), ("indexing", counts)):
        a = torch.from_numpy(amounts).to(dev)
        kw = dict(select=select, mean_mode="degraded_area", mean_value=0.0, rule="base_momentum")

        def kernel():
            fused_degrade_update(xt, x0, a[0], a[1], seed=5, offset=1, **kw)

        def plain():
            bb = torch.randint(0, 2**32, (2, b, hw), device=dev, dtype=torch.int64)
            fused_rows(bb[0], bb[1], xt.reshape(b, -1), x0.reshape(b, -1), a[0][:, None],
                       a[1][:, None], channels=c, **kw)

        (k_dev, k_eager), (p_dev, p_eager) = cuda_ms(kernel), cuda_ms(plain)
        times[select] = (k_dev, p_dev)
        log(f"[2] time {select} {b}x{SIZE}x{SIZE}x{c}: kernel {k_dev:.4f} ms device "
            f"({k_eager:.4f} eager), plain {p_dev:.4f} ms device ({p_eager:.4f} eager)")
    return worst, times


def phase_groupnorm():
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.models.unet import GroupNormAct
    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu, group_norm_silu_plain

    dev = torch.device("cuda")
    batch = 16  # the serving batch of phase 5
    model = build_unet().to(dev, torch.bfloat16).eval()
    calls = {}

    def hook(mod, inputs, _out):
        key = (tuple(inputs[0].shape[1:]), mod.num_groups, mod.silu)
        calls[key] = calls.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, GroupNormAct)]
    t0 = time.perf_counter()
    with torch.inference_mode():
        model(torch.randn(batch, 3, SIZE, SIZE, device=dev, dtype=torch.bfloat16),
              torch.full((batch,), 10.0, device=dev))
    torch.cuda.synchronize()
    log(f"[3] flagship forward with the Triton GroupNorm (first launch compiles): "
        f"{time.perf_counter() - t0:.2f} s; {sum(calls.values())} norms, {len(calls)} shapes")
    for h in hooks:
        h.remove()
    del model

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    k_total = p_total = 0.0
    with torch.inference_mode():
        for (chw, groups, silu), count in sorted(calls.items()):
            c, h, w = chw
            x = torch.randn((batch, c, h, w), generator=gen, device=dev) * 1.7 + 0.3
            scale = torch.randn((c,), generator=gen, device=dev) * 0.1 + 1.0
            bias = torch.randn((c,), generator=gen, device=dev) * 0.1
            line = []
            for dtype in (torch.float32, torch.bfloat16):
                xd, sd, bd = x.to(dtype), scale.to(dtype), bias.to(dtype)
                out = group_norm_silu(xd, sd, bd, groups, 1e-5, silu)
                ref = group_norm_silu_plain(xd, sd, bd, groups, 1e-5, silu)
                name = str(dtype).split(".")[1]
                atol, rtol = GN_TOL[name]
                diff = (out.float() - ref.float()).abs()
                if out.dtype != dtype or not bool((diff <= atol + rtol * ref.float().abs()).all()):
                    raise AssertionError(
                        f"group_norm_silu {name} {(batch, c, h, w)} G={groups} silu={silu}: "
                        f"max err {diff.max().item()} beyond atol {atol} rtol {rtol}")
                worst[name] = max(worst[name], diff.max().item())
                kms, keager = cuda_ms(lambda: group_norm_silu(xd, sd, bd, groups, 1e-5, silu))
                pms, peager = cuda_ms(
                    lambda: group_norm_silu_plain(xd, sd, bd, groups, 1e-5, silu))
                line.append(f"{name} kernel {kms:.4f} ({keager:.4f} eager) "
                            f"plain {pms:.4f} ({peager:.4f} eager) ms")
                if dtype == torch.bfloat16:
                    k_total += count * kms
                    p_total += count * pms
            log(f"[3] GN {batch}x{c}x{h}x{w} G={groups} silu={int(silu)} (x{count} per forward): "
                + "; ".join(line))
    log(f"[3] group_norm_silu: all shapes within tolerance; max err fp32 {worst['float32']:.3g}, "
        f"bf16 {worst['bfloat16']:.3g}; device time per bf16 forward at batch {batch}: "
        f"kernel {k_total:.4f} ms, plain {p_total:.4f} ms")
    return worst["float32"], k_total, p_total


def _flagship_weights(seed: int):
    import torch

    from masked_diffusion_tpu_torch.models.factory import build_unet

    torch.manual_seed(seed)
    model = build_unet()
    model.conv_out.reset_parameters()  # random, not zero: the output must depend on it
    return model


def phase_slice():
    import numpy as np
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import parse
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.ops.shift import draw_shapes
    from masked_diffusion_tpu_torch.sample.latent import latent_initial
    from masked_diffusion_tpu_torch.sample.loop import StepDraws, make_sample_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    batch, steps = 2, 10
    ref_model = _flagship_weights(1)
    for sched, select in (("linear", "thresholding"), ("log", "indexing")):
        cfg, _ = parse([
            "--method", "sample", "--data_size", str(SIZE), "--ddpm_schedule", sched,
            "--ddpm_num_steps", str(steps), "--select_degrade_pixel", select,
            "--degrade_channel", "1-channel", "--mean_option", "degraded_area",
            "--mean_area", "image-wise", "--shift_type", "1-d_constant",
            "--momentum_adaptive", "base_momentum", "--sampling_mask_dependency",
            "independent", "--mixed_precision", "no", "--sample_latent_shape", "uniform",
        ])
        schedule = build_schedule(sched, steps, SIZE, select)
        used = schedule.timesteps_for_epoch(1, 10, 1)
        rng = np.random.default_rng(2)
        u_shape, _ = draw_shapes(cfg.shift_type, (batch, 3, SIZE, SIZE))
        cpu_draws = [
            StepDraws(
                bits=torch.from_numpy(rng.integers(0, 2**32, size=(2, batch, SIZE * SIZE),
                                                   dtype=np.uint64).astype(np.int64)),
                uniform=torch.from_numpy(rng.uniform(-1, 1, size=u_shape).astype(np.float32)),
            )
            for _ in used
        ]
        cuda_draws = [StepDraws(bits=d.bits.cuda(), uniform=d.uniform.cuda()) for d in cpu_draws]
        latent = latent_initial(torch.Generator().manual_seed(3), batch, 3, SIZE, "uniform")
        outs = {}
        for dev, draws in (("cuda", cuda_draws), ("cpu", cpu_draws)):
            model = build_unet()
            model.load_state_dict(ref_model.state_dict())
            fn = make_sample_fn(model, schedule, cfg, used, device=dev)
            lat = latent.to(dev)
            t0 = time.perf_counter()
            if dev == "cuda":
                # the loop must not make the host wait on the card: any
                # synchronising call inside it raises in this mode
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(lat, draws=lambda i, d=draws: d[i])
            finally:
                torch.cuda.set_sync_debug_mode("default")
            outs[dev] = out.cpu()
            log(f"[4] {sched}+{select} on {dev}: {len(used)} steps in "
                f"{time.perf_counter() - t0:.2f} s"
                + (" with no host sync inside the loop" if dev == "cuda" else ""))
        a, r = outs["cuda"], outs["cpu"]
        if not (torch.isfinite(a).all() and a.shape == (batch, SIZE, SIZE, 3)):
            raise AssertionError(f"slice {sched}: non-finite or misshapen output {tuple(a.shape)}")
        err = (a - r).abs().max().item()
        if not torch.allclose(a, r, atol=SLICE_TOL, rtol=SLICE_TOL):
            raise AssertionError(f"slice {sched}+{select}: CUDA vs CPU max err {err}")
        log(f"[4] slice parity {sched}+{select}: CUDA kernels vs CPU plain, max |diff| "
            f"{err:.3g} (atol = rtol = {SLICE_TOL}); output std {r.std().item():.4f}")
    torch.backends.cudnn.allow_tf32 = True


def phase_serve(workdir: str):
    import torch

    from masked_diffusion_tpu_torch.cli.main_train_masked import main
    from masked_diffusion_tpu_torch.io.weights import diffusers_config_from_unet, save_checkpoint
    from masked_diffusion_tpu_torch.ops.fused_degrade import fused_degrade_update
    from masked_diffusion_tpu_torch.ops.groupnorm import group_norm_silu

    model = _flagship_weights(4)
    ckpt = save_checkpoint(os.path.join(workdir, "checkpoint-epoch-0"),
                           model.state_dict(), diffusers_config_from_unet(model.config))
    del model
    launches = {"fused_degrade_update": 0, "group_norm_silu": 0}
    runs = []
    for sched, select, steps in (("linear", "thresholding", 100), ("log", "indexing", 200)):
        argv = [
            "--method", "sample", "--test_model_path", ckpt, "--data_name", "synthetic",
            "--data_size", str(SIZE), "--data_subset", "True", "--data_subset_num", "256",
            "--batch_size", "16", "--sample_num", "32", "--mixed_precision", "bf16",
            "--ddpm_schedule", sched, "--ddpm_num_steps", str(steps),
            "--select_degrade_pixel", select, "--degrade_channel", "1-channel",
            "--mean_option", "degraded_area", "--mean_area", "image-wise",
            "--shift_type", "1-d_constant", "--momentum_adaptive", "base_momentum",
            "--sampling_mask_dependency", "independent", "--use_wandb", "False",
            "--dir_work", os.path.join(workdir, sched), "--device", "cuda",
        ]
        buf = io.StringIO()
        fused_degrade_update.launches = 0
        group_norm_silu.launches = 0
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        n_fused, n_gn = fused_degrade_update.launches, group_norm_silu.launches
        sys.stdout.write(buf.getvalue())
        stats = json.loads(
            next(ln for ln in buf.getvalue().splitlines() if ln.startswith("sample_stats "))
            .split(" ", 1)[1]
        )
        pngs = sorted(f for f in os.listdir(stats["out_dir"]) if f.endswith(".png"))
        if rc != 0 or not stats["finite"] or stats["images"] != 32:
            raise AssertionError(f"serve {sched}: rc {rc}, stats {stats}")
        if len(pngs) != 32 + stats["batches"]:
            raise AssertionError(f"serve {sched}: {len(pngs)} PNGs on disk")
        if stats["steps"] != steps:
            raise AssertionError(f"serve {sched}: {stats['steps']} steps, expected {steps}")
        if n_fused != stats["steps"] * stats["batches"] or n_gn <= 0:
            raise AssertionError(f"serve {sched}: launches fused {n_fused}, "
                                 f"groupnorm {n_gn}, steps x batches "
                                 f"{stats['steps'] * stats['batches']}")
        launches["fused_degrade_update"] += n_fused
        launches["group_norm_silu"] += n_gn
        runs.append(stats)
        log(f"[5] serve {sched}+{select}: {stats['images']} images, {stats['steps']} steps x "
            f"{stats['batches']} batches, {stats['images_per_sec']:.3f} images/s, "
            f"{stats['ms_per_step']:.3f} ms/step on {stats['device']}; launches: fused "
            f"{n_fused}, groupnorm {n_gn}; {len(pngs)} PNGs")
    return launches, runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = phase_env()
    fused_err, fused_times = phase_fused()
    gn_err, gn_ms, gn_plain_ms = phase_groupnorm()
    phase_slice()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
        launches, _ = phase_serve(workdir)
    for mod in ("jax", "flax"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    log(smi)
    print(json.dumps({"kernels": [
        {"name": "fused_degrade_update", "route": "cuda",
         "source": "masked_diffusion_tpu_torch/csrc/fused_degrade.cu",
         "replaces": "masked_diffusion_tpu/ops/pallas/fused_degrade.py:209",
         "launches": launches["fused_degrade_update"], "max_abs_err": fused_err,
         "ms": fused_times["indexing"][0], "plain_ms": fused_times["indexing"][1]},
        {"name": "group_norm_silu", "route": "triton",
         "source": "masked_diffusion_tpu_torch/ops/groupnorm.py",
         "replaces": "masked_diffusion_tpu/ops/pallas/groupnorm.py:158",
         "launches": launches["group_norm_silu"], "max_abs_err": gn_err,
         "ms": gn_ms, "plain_ms": gn_plain_ms},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
