"""Device times of variants of the exact-k kernels: where their time goes.

    python -m masked_diffusion_tpu_torch.tools.exact_k_variants [--out FILE]

Run from the root of a checkout on a machine with the GPU. Each variant is
csrc/ with text replacements in csrc/exact_k.cuh, csrc/fused_degrade.cu or
csrc/kmask.cu, its two exact-k sources built into a library of their own
under build/exact_k_variants/. A variant that drops work computes wrong
masks: it only says what that work costs. At each shape (Philox route) and
each cluster size the kernels take there (`plan` marks exact_k_plan's),
every variant is timed by CUDA-graph replay (chip_smoke.cuda_ms), the
variants in order and then in reverse, the lesser of the two kept; `empty`
is a launch of the same clusters that returns at once. Prints the card and
one JSON line per shape and cluster size, and writes them all to FILE
(default build/exact_k_variants.json). The checkout's sources are
never changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_FUSED_SELECT = "if (indexing) mdt::radix_select<2, P>(keys, valid, ks, hw, thr, sel, cs);"
_KMASK_SELECT = "mdt::radix_select<1, P>(keys, valid, ks, hw, thr, sel, cs);"
_FUSED_ENTRY = "  const int cs = a.cs, hw = a.hw, channels = a.channels;\n"
_KMASK_ENTRY = "  const int cs = a.cs, hw = a.hw;\n"

# name: [(file, old, new)]
VARIANTS = {
    "as_built": [],
    # every CTA returns at once: the launch of the clusters alone
    "empty": [("fused_degrade.cu", _FUSED_ENTRY, _FUSED_ENTRY + "  if (hw > 0) return;\n"),
              ("kmask.cu", _KMASK_ENTRY, _KMASK_ENTRY + "  if (hw > 0) return;\n")],
    # no select: thresholds stay 0
    "no_select": [("fused_degrade.cu", _FUSED_SELECT, "if (false) " + _FUSED_SELECT),
                  ("kmask.cu", _KMASK_SELECT, "if (false) " + _KMASK_SELECT)],
    # one round of the select instead of four
    "one_round": [("exact_k.cuh", "constexpr int kRounds = 32 / kDigitBits;",
                   "constexpr int kRounds = 1;")],
    # one Philox round a draw instead of ten (the keys then skew, which
    # changes the select's work too: read it on thresholding)
    "philox_1_round": [("exact_k.cuh", "for (int r = 0; r < 10; ++r) {",
                        "for (int r = 0; r < 1; ++r) {")],
    # the select's four rounds, no gather finish
    "no_gather": [("exact_k.cuh", "few &= s.tot[n][d] <= kGather;", "few = false;")],
    # the parts of one round (the select cut to round 0, as one_round): its
    # histogram without atomics, the cluster's sums from this CTA's shared
    # memory alone, no digit scan
    "round0_plain_adds": [("exact_k.cuh", "constexpr int kRounds = 32 / kDigitBits;",
                           "constexpr int kRounds = 1;"),
                          ("exact_k.cuh",
                           "atomicAdd(&s.hist[par][n][(keys[n][i] >> shift) & (kBins - 1)], 1);",
                           "s.hist[par][n][(keys[n][i] >> shift) & (kBins - 1)] += 1;")],
    "round0_local_sums": [("exact_k.cuh", "constexpr int kRounds = 32 / kDigitBits;",
                           "constexpr int kRounds = 1;"),
                          ("exact_k.cuh", "v[q] = *peer(mine + e, q, CS);", "v[q] = mine[e];")],
    "round0_no_scan": [("exact_k.cuh", "constexpr int kRounds = 32 / kDigitBits;",
                        "constexpr int kRounds = 1;"),
                       ("exact_k.cuh", "find_digit(s.tot[n], krem[n], d, below);",
                        "d = 0;\n      below = 0;")],
    # no masked means (the cluster sums of degraded_area)
    "no_means": [("fused_degrade.cu", "if (a.mean_mode == kDegradedArea) {", "if (false) {")],
}
# (kernel, batch, height, width, select)
SHAPES = (
    ("fused", 64, 64, 64, "indexing"), ("fused", 64, 64, 64, "thresholding"),
    ("kmask", 64, 64, 64, None), ("kmask", 32, 64, 64, None), ("kmask", 8, 256, 256, None),
    ("fused", 8, 256, 256, "indexing"), ("fused", 8, 256, 256, "thresholding"),
    ("fused", 32, 64, 64, "indexing"), ("fused", 16, 64, 64, "indexing"),
    ("fused", 16, 64, 64, "thresholding"), ("fused", 1, 64, 64, "indexing"),
    ("fused", 1, 256, 256, "indexing"),
)


def _start(name: str, replacements):
    """Copy csrc/ with the variant's replacements and start nvcc on its two
    exact-k sources; returns (library path, objects, processes)."""
    from masked_diffusion_tpu_torch.ops import build

    src = os.path.join(build.BUILD_DIR, "exact_k_variants", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    for fname, old, new in replacements:
        path = os.path.join(src, fname)
        with open(path) as f:
            text = f.read()
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in csrc/{fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new, 1))
    objs, procs = [], []
    for cu in ("fused_degrade.cu", "kmask.cu"):
        objs.append(os.path.join(src, cu + ".o"))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", objs[-1], os.path.join(src, cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return os.path.join(src, "libvariant.so"), objs, procs


def _finish(name: str, lib: str, objs, procs) -> ctypes.CDLL:
    from masked_diffusion_tpu_torch.ops import build

    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib, *objs], check=True)
    loaded = ctypes.CDLL(lib)
    build.declare_exact_k(loaded)
    return loaded


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "exact_k_variants.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("exact_k_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke
    from masked_diffusion_tpu_torch.ops import build
    from masked_diffusion_tpu_torch.ops import fused_degrade as fd
    from masked_diffusion_tpu_torch.ops import kmask

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = list(VARIANTS)
    started = {name: _start(name, reps) for name, reps in VARIANTS.items()}  # all at once
    libs = {name: _finish(name, *started[name]) for name in names}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for what, b, h, w, select in SHAPES:
        hw = h * w
        if what == "fused":
            x = torch.randn((b, 3, h, w), generator=gen, device=dev)
            a = (torch.randint(0, hw + 1, (b,), generator=gen, device=dev).float()
                 if select == "indexing" else torch.rand((b,), generator=gen, device=dev))

            def fn(plan):
                fd.fused_degrade_update(x, x, a, a, select=select, mean_mode="degraded_area",
                                        seed=3, offset=4, launch_plan=plan)
        else:
            counts = torch.randint(0, hw + 1, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)

            def fn(plan):
                kmask.exact_count_masks(b, h, w, counts, generator=torch.Generator(),
                                        launch_plan=plan)
        chosen = fd.exact_k_plan(b, hw, sms)
        for cs in fd.EXACT_K_CLUSTER_SIZES:
            plan = fd.exact_k_plan_at(hw, cs, chosen.vec)
            if not fd.exact_k_plan_ok(plan, b, hw):
                continue
            best = {}
            for order in (names, names[::-1]):
                for name in order:
                    build._lib = libs[name]
                    ms = chip_smoke.cuda_ms(lambda: fn(plan))[0]
                    best[name] = min(best.get(name, ms), ms)
            row = {"kernel": what, "batch": b, "h": h, "w": w, "select": select,
                   "plan": plan._asdict(), "chosen": plan == chosen, "ms": best}
            rows.append(row)
            print(json.dumps(row), flush=True)
    build._lib = None
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
