"""Device times of variants of the GroupNorm kernels' build and launch plan.

    python -m masked_diffusion_tpu_torch.tools.groupnorm_variants

Run from the root of a checkout on a machine with the GPU. Each variant is
csrc/ with text replacements in csrc/groupnorm.cu (built into its own
library under build/variants/) and overrides of ops/groupnorm.py's plan
constants. At each shape every variant's forward (or backward) call is timed
by CUDA-graph replay (chip_smoke.cuda_ms), the variants in order and then in
reverse, the lesser of the two kept. Prints the card and one line per shape.
The checkout's sources are never changed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_BWD_BOUNDS = "__launch_bounds__(kMaxThreads, 2) gn_bwd_block_kernel("

# name: (replacements in csrc/groupnorm.cu, overrides of ops/groupnorm.py)
VARIANTS = {
    "as_built": ([], {}),
    # the cluster-path backward held to 42 registers (three 512-thread CTAs an SM)
    "bwd_regs_42": ([(_BWD_BOUNDS, _BWD_BOUNDS.replace(", 2)", ", 3)"))], {}),
    # staged bytes per CTA up to which a span keeps fewer CTAs (forward, backward)
    "stage_16k": ([], {"STAGE_TARGET": (16384, 16384)}),
    "stage_32k": ([], {"STAGE_TARGET": (32768, 32768)}),
    "stage_64k": ([], {"STAGE_TARGET": (65536, 65536)}),
    # the backward's slices read twice from device memory (L2) instead of
    # staged: always, or above 64 KiB a CTA
    "bwd_streamed": ([], {"STAGE_TARGET": (65536, 0), "STAGE_MAX": (232448, 0)}),
    "bwd_streamed_above_64k": ([], {"STAGE_MAX": (232448, 65536)}),
}
# (batch, channels, height, width, "fwd" or "bwd"): flagship training and
# serving shapes, bf16, G = 32, SiLU on
SHAPES = ((64, 128, 64, 64, "bwd"), (64, 256, 64, 64, "bwd"), (64, 128, 32, 32, "bwd"),
          (64, 256, 16, 16, "bwd"), (64, 512, 16, 16, "bwd"), (8, 128, 128, 128, "bwd"),
          (8, 256, 128, 128, "bwd"), (8, 128, 256, 256, "bwd"), (8, 256, 256, 256, "bwd"),
          (64, 128, 64, 64, "fwd"), (64, 256, 64, 64, "fwd"), (16, 128, 64, 64, "fwd"),
          (16, 256, 64, 64, "fwd"))


def _build(name: str, replacements) -> ctypes.CDLL:
    from masked_diffusion_tpu_torch.ops import build

    src = os.path.join(build.BUILD_DIR, "variants", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    path = os.path.join(src, "groupnorm.cu")
    with open(path) as f:
        text = f.read()
    for old, new in replacements:
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in csrc/groupnorm.cu")
        text = text.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(text)
    objs, procs = [], []
    for cu in sorted(f for f in os.listdir(src) if f.endswith(".cu")):
        objs.append(os.path.join(src, cu + ".o"))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", objs[-1], os.path.join(src, cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
    lib = os.path.join(src, "libvariant.so")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib, *objs], check=True)
    loaded = ctypes.CDLL(lib)
    build._declare(loaded)
    return loaded


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("groupnorm_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke
    from masked_diffusion_tpu_torch.ops import build
    from masked_diffusion_tpu_torch.ops import groupnorm as gn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    libs = {name: _build(name, reps) for name, (reps, _) in VARIANTS.items()}
    defaults = {k: getattr(gn, k) for _, over in VARIANTS.values() for k in over}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, c, h, w, direction in SHAPES:
        x, scale, bias = chip_smoke._gn_inputs(gen, b, c, h, w)
        x = x.to(torch.bfloat16)
        g = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
        best = {}
        for order in (list(VARIANTS), list(VARIANTS)[::-1]):
            for name in order:
                build._lib = libs[name]
                for k, v in defaults.items():
                    setattr(gn, k, VARIANTS[name][1].get(k, v))
                gn._cuda_plan.cache_clear()
                gn._max_clusters.clear()
                _, mean, rstd = gn.group_norm_silu_forward(x, scale, bias, 32, 1e-5, True)
                if direction == "bwd":
                    def fn():
                        gn.group_norm_silu_backward(x, scale, bias, g, mean, rstd, 32, True)
                else:
                    def fn():
                        gn.group_norm_silu_forward(x, scale, bias, 32, 1e-5, True)
                ms = chip_smoke.cuda_ms(fn)[0]
                best[name] = min(best.get(name, ms), ms)
        print(f"{direction} {(b, c, h, w)} bf16: "
              + ", ".join(f"{n} {t * 1e3:.2f} us" for n, t in best.items()), flush=True)
    for k, v in defaults.items():
        setattr(gn, k, v)
    build._lib = None
    gn._cuda_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
