"""Device times of the exact-k kernels (csrc/fused_degrade.cu, csrc/kmask.cu)
against an earlier build of them, on the Philox route, at the main paths'
shapes.

    python -m masked_diffusion_tpu_torch.tools.exact_k_compare --other DIR [--out FILE]

Run from the root of a checkout on a machine with the GPU. DIR holds the
earlier exact_k.cuh, fused_degrade.cu and kmask.cu of the one-CTA-per-image
design (C entry points that take a key scratch pointer and no plan), for
example `git show <commit>:masked_diffusion_tpu_torch/csrc/kmask.cu`; they
are built with the package's nvcc flags into a library of their own under
build/. At each shape both are timed by CUDA-graph replay
(chip_smoke.cuda_ms) in turns, other, this, this, other; both must give
bitwise the same masks at the same (seed, offset), and this build's masks
must equal its plain version fed the plain Philox bits. Then this build's
time at each cluster size its plan takes there. Prints the card and one
JSON line per shape, and writes them all to FILE (default
build/exact_k_compare.json).
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
_SOURCES = ("exact_k.cuh", "fused_degrade.cu", "kmask.cu")
# (kernel, batch, height, width, select): serving batch 16, a 2-rank shard
# of the bench batch, the bench batch, unet6 at 256x256; the training
# batches of CelebA-HQ (32) and the flagship (64)
SHAPES = (
    ("fused", 16, 64, 64, "thresholding"), ("fused", 16, 64, 64, "indexing"),
    ("fused", 32, 64, 64, "thresholding"), ("fused", 32, 64, 64, "indexing"),
    ("fused", 64, 64, 64, "thresholding"), ("fused", 64, 64, 64, "indexing"),
    ("fused", 8, 256, 256, "indexing"),
    ("kmask", 32, 64, 64, None), ("kmask", 64, 64, 64, None), ("kmask", 8, 256, 256, None),
)


def _build_other(src_dir: str) -> ctypes.CDLL:
    from masked_diffusion_tpu_torch.ops import build

    dst = os.path.join(build.BUILD_DIR, "exact_k_other")
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    for name in _SOURCES:
        shutil.copy(os.path.join(src_dir, name), dst)
    objs, procs = [], []
    for cu in ("fused_degrade.cu", "kmask.cu"):
        objs.append(os.path.join(dst, cu + ".o"))
        procs.append(subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", objs[-1], os.path.join(dst, cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the other build\n{out}")
    path = os.path.join(dst, "libexact_k_other.so")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", path, *objs], check=True)
    lib = ctypes.CDLL(path)
    vp, i32, u64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_float
    lib.mdt_fused_degrade.argtypes = [vp, vp, vp, vp, vp, u64, u64, vp, vp, vp, i32, i32, i32,
                                      i32, i32, f32, i32, vp]
    lib.mdt_fused_degrade.restype = i32
    lib.mdt_kmask.argtypes = [vp, vp, u64, u64, vp, vp, i32, i32, vp]
    lib.mdt_kmask.restype = i32
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="directory of the earlier sources")
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "exact_k_compare.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("exact_k_compare: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke
    from masked_diffusion_tpu_torch.ops import fused_degrade as fd
    from masked_diffusion_tpu_torch.ops import kmask

    smi = chip_smoke.phase_env()
    other = _build_other(args.other)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for what, b, h, w, select in SHAPES:
        hw, c = h * w, 3
        seed, offset = 1234567, 89
        if what == "fused":
            xt = torch.randn((b, c, h, w), generator=gen, device=dev)
            x0 = torch.randn((b, c, h, w), generator=gen, device=dev)
            if select == "indexing":
                a = torch.randint(0, hw + 1, (2, b), generator=gen, device=dev).float()
            else:
                a = torch.rand((2, b), generator=gen, device=dev)
            out_o, mask_o = torch.empty_like(xt), torch.empty((b, 1, h, w), device=dev)
            keys = torch.empty((2, b, hw), dtype=torch.int32, device=dev)
            kw = dict(select=select, mean_mode="degraded_area", rule="base_momentum",
                      seed=seed, offset=offset)

            def mine(plan=None):
                return fd.fused_degrade_update(xt, x0, a[0], a[1], launch_plan=plan, **kw)

            def theirs():
                code = other.mdt_fused_degrade(
                    xt.data_ptr(), x0.data_ptr(), a[0].data_ptr(), a[1].data_ptr(), None, seed,
                    offset, out_o.data_ptr(), mask_o.data_ptr(), keys.data_ptr(), b, c, hw,
                    fd._SELECT[select], 1, 0.0, 0, torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"the other mdt_fused_degrade: CUDA error {code}")

            out_m, mask_m = mine()
            theirs()
            bits = fd.philox_fused_bits(seed, offset, b, hw, dev)
            ref_out, ref_mask = fd.fused_rows(
                bits[0], bits[1], xt.reshape(b, -1), x0.reshape(b, -1), a[0][:, None],
                a[1][:, None], channels=c, select=select, mean_mode="degraded_area",
                mean_value=0.0, rule="base_momentum")
            torch.cuda.synchronize()
            same = torch.equal(mask_m, mask_o)
            plain = torch.equal(mask_m.reshape(b, hw), ref_mask)
            err = (out_m.reshape(b, -1) - ref_out).abs().max().item()
            other_err = (out_m - out_o).abs().max().item()
            bound = chip_smoke.fused_bound(b, c, hw)
        else:
            counts = torch.randint(0, hw + 1, (b,), generator=gen, device=dev,
                                   dtype=torch.int32)
            out_o = torch.empty((b, 1, h, w), device=dev)
            keys = torch.empty((b, hw), dtype=torch.int32, device=dev)
            g_seed, g_off = kmask.philox_seed(torch.Generator().manual_seed(5))

            def mine(plan=None):
                return kmask.exact_count_masks(b, h, w, counts,
                                               generator=torch.Generator().manual_seed(5),
                                               launch_plan=plan)

            def theirs():
                code = other.mdt_kmask(counts.data_ptr(), None, g_seed, g_off, out_o.data_ptr(),
                                       keys.data_ptr(), b, hw,
                                       torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"the other mdt_kmask: CUDA error {code}")

            mask_m = mine()
            theirs()
            ref = kmask.exact_count_masks_plain(fd.philox_kmask_bits(g_seed, g_off, b, hw, dev),
                                                counts).reshape(mask_m.shape)
            torch.cuda.synchronize()
            same, plain = torch.equal(mask_m, out_o), torch.equal(mask_m, ref)
            err = other_err = (mask_m - ref).abs().max().item()
            bound = chip_smoke.kmask_bound(b, hw)
        if not (same and plain):
            raise AssertionError(f"{what} {b}x{h}x{w} {select}: masks equal to the other "
                                 f"build {same}, to the plain version on Philox bits {plain}")
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            fn = theirs if name == "other" else mine
            times[name].append(chip_smoke.cuda_ms(fn)[0])
        plan = fd.exact_k_plan(b, hw, sms)
        by_cs = {}
        for cs in fd.EXACT_K_CLUSTER_SIZES:
            p = fd.exact_k_plan_at(hw, cs, plan.vec)
            if fd.exact_k_plan_ok(p, b, hw):
                by_cs[cs] = chip_smoke.cuda_ms(lambda: mine(p))[0]
        this_ms = sum(times["this"]) / 2
        row = {"kernel": what, "batch": b, "h": h, "w": w, "select": select,
               "plan": plan._asdict(), "other_ms": times["other"], "this_ms": times["this"],
               "speedup": sum(times["other"]) / sum(times["this"]), "bound_ms": bound[0],
               "bound_by": bound[1], "bound_share": bound[0] / this_ms,
               "this_ms_by_cs": by_cs, "masks_bitwise_other": same,
               "masks_bitwise_plain_philox": plain, "max_abs_err_plain": err,
               "max_abs_diff_other": other_err}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(smi, flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
