"""Device times of variants of the tiny-head backward kernel: where its
time goes, in bf16 or (--dtype fp32) in its split-TF32 instance.

    python -m masked_diffusion_tpu_torch.tools.tinyhead_bwd_variants [--dtype bf16|fp32]
        [--out FILE] [--variants ...] [--s ...]

Run from the root of a checkout on a machine with the GPU. Each variant is
csrc/ with text replacements in csrc/tinyhead_attention_bwd.cu (or its
header tinyhead_mma.cuh), the backward's source built alone into a
library of its own under build/tinyhead_bwd_variants/ (all nvcc processes
started together). A variant that drops work computes wrong gradients: it
only says what that work costs. A variant may change the fp32 instance's
keys a warp and most warps a CTA; its plans then follow
tinyhead_bwd_plan's rule with those. At each main shape of chip_smoke.py's
TINYHEAD_SHAPES, on the plan tinyhead_bwd_plan takes (`taken`) and on the
other plans listed in EXTRA_PLANS (bf16), every variant is timed by
CUDA-graph replay (chip_smoke.cuda_ms, 20 calls a graph replayed 10 times,
5 at S=4096), the variants in order and then in reverse, the lesser of the
two kept. Prints the card, each variant's registers and spills (ptxas -v,
the d == 8 instances) and one JSON line a shape and plan, and writes them
all to FILE (default build/tinyhead_bwd_variants[_fp32].json). The
checkout's sources are never changed.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_SRC = "tinyhead_attention_bwd.cu"
_HDR = "tinyhead_mma.cuh"
_REGS = "constexpr int kRegs = 128;"
_MOVM_NOTE = "// ldmatrix-layout 8 x 8 bf16 fragment transposed within the warp"
# 2^x for x <= 0 on the FMA pipe: x = n + f with n an integer and |f| <= 1/2,
# 2^f by its Taylor polynomial of degree 6 (relative error < 2.5e-7), n added
# to the exponent; x <= -127 (-inf included) gives +0
_EXP2_FMA = """__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float r = x + 12582912.f;  // 1.5 * 2^23: n in r's low mantissa bits
  const float f = x - (r - 12582912.f);
  float p = 1.5403530e-4f;
  p = fmaf(p, f, 1.3333558e-3f);
  p = fmaf(p, f, 9.6181291e-3f);
  p = fmaf(p, f, 5.5504109e-2f);
  p = fmaf(p, f, 2.4022651e-1f);
  p = fmaf(p, f, 6.9314718e-1f);
  p = fmaf(p, f, 1.f);
  return __uint_as_float(__float_as_uint(p) + (__float_as_uint(r) << 23));
}

"""

_H_LOOP = "#pragma unroll\n    for (int h = 0; h < kC / 16; ++h) {"
_P_EX2 = "float p = ex2(fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x));"
_WIDE = "static constexpr int kWideChunk = 128;"

# name: [(old, new) or (old, new, occurrence) or (old, new, occurrence,
# file)], the occurrence counted from 0 in csrc/tinyhead_attention_bwd.cu
# (or `file` in csrc/); Bf16's code comes first in the file, Tf32's second
VARIANTS = {
    "as_built": [],
    # every CTA returns at once: the launches alone (and the slice sum)
    "empty": [("  const int chunks = (s + kC - 1) / kC;\n",
               "  const int chunks = (s + kC - 1) / kC;\n  if (s > 0) return;\n")],
    # no exponential: P = the exponent itself
    "no_ex2": [("float p = ex2(fmaf(", "float p = (fmaf(")],
    # no dQ product (its movmatrix go too)
    "no_dq_mma": [("mma_k16(dqa, da, kb);", "")],
    # P and dS as their fp32 values' high halves (no cvt; wrong values)
    "no_cvt": [("pa[2 * nt] = pack_bf16(sc[0], sc[1]);",
                "pa[2 * nt] = __byte_perm(__float_as_uint(sc[0]), __float_as_uint(sc[1]), 0x7632);"),
               ("pa[2 * nt + 1] = pack_bf16(sc[2], sc[3]);",
                "pa[2 * nt + 1] = __byte_perm(__float_as_uint(sc[2]), __float_as_uint(sc[3]), 0x7632);"),
               ("sa[2 * nt] = pack_bf16(dp[0], dp[1]);",
                "sa[2 * nt] = __byte_perm(__float_as_uint(dp[0]), __float_as_uint(dp[1]), 0x7632);"),
               ("sa[2 * nt + 1] = pack_bf16(dp[2], dp[3]);",
                "sa[2 * nt + 1] = __byte_perm(__float_as_uint(dp[2]), __float_as_uint(dp[3]), 0x7632);")],
    # dS not transposed for the dQ product (wrong values)
    "no_movm": [("const uint32_t da[4] = {movtrans(sa[0]), movtrans(sa[2]), movtrans(sa[1]),\n"
                 "                                movtrans(sa[3])};",
                 "const uint32_t da[4] = {sa[0], sa[2], sa[1], sa[3]};")],
    # one probability in 4 on the FMA pipe (exp2_fma)
    "fma_exp_1of4": [(_MOVM_NOTE, _EXP2_FMA + _MOVM_NOTE),
                     (_P_EX2, "const float x = fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x);\n"
                              "            float p = i == 3 ? exp2_fma(x) : ex2(x);")],
    # no dQ sums across the warps, nothing written to dq or the workspace
    "no_sum": [("if (j > 0) reduce_chunk(j - 1, pass == 0);", ""),
               ("    reduce_chunk(chunks - 1, pass == 0);", "")],
    # one more m16n8k16 product a 16-key x 16-query block (into dV: wrong
    # values), or eight more exp2 (into P: wrong values)
    "extra_hmma": [("        mma_k16(dva[mt], pa, dot);",
                    "        mma_k16(dva[mt], pa, dot);\n        mma_k16(dva[mt], sa, dot);")],
    "extra_ex2": [("            sc[i] = p;", "            sc[i] = p + ex2(p - 1.f);")],
    # the 16-query loop of a chunk unrolled 1, 2 or 4 times, not fully
    "h_unroll_1": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 1"))],
    "h_unroll_2": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 2"))],
    "h_unroll_4": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 4"))],
    "regs_96": [(_REGS, "constexpr int kRegs = 96;")],
    "regs_112": [(_REGS, "constexpr int kRegs = 112;")],
    # 64 queries a chunk at every width, or 128
    "chunk_64": [(_WIDE, "static constexpr int kWideChunk = 64;")],
    "chunk_128": [("return warps >= 8 ? kWideChunk : 64; }", "return kWideChunk; }")],
}
_F_REGS = "static constexpr int kRegs = 255;"
_F_MT = "static constexpr int kMT = 2;"
_F_WARPS = "static constexpr int kMaxWarps = 8;"
_F_H_LOOP = "#pragma unroll 1\n    for (int h = 0; h < kC / 16; ++h) {"
_F_DVC = "          mma_tf32x3(dvc[mt], pa, gd[nt]);\n          mma_tf32x3(dkc[mt], ds[nt], gq[nt]);"
_F_MOVM = ("              const uint32_t x0 = ds[nt][part][kb], x1 = ds[nt][part][kb + 2];\n"
           "              const uint32_t hi = movtrans(__byte_perm(x0, x1, 0x7632));\n"
           "              const uint32_t lo = movtrans(__byte_perm(x0, x1, 0x5410));\n"
           "              da[part][nt] = __byte_perm(lo, hi, 0x5410);      // key 2t\n"
           "              da[part][nt + 2] = __byte_perm(lo, hi, 0x7632);  // key 2t + 1")
# the fp32 instance's variants, as VARIANTS (Tf32's text its second
# occurrence where Bf16 has the same)
VARIANTS_FP32 = {
    "as_built": [],
    "empty": VARIANTS["empty"],
    "no_ex2": [(_P_EX2, "float p = (fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x));", 1)],
    # no transposes and no dQ products
    "no_dq": [("          mma_tf32x3(dqa, da, kv.kt[mt][kb]);", "")],
    # dS^T's values as dS's (no movmatrix transposes; wrong values)
    "no_transpose": [(_F_MOVM, "              da[part][nt] = ds[nt][part][kb];\n"
                               "              da[part][nt + 2] = ds[nt][part][kb + 2];")],
    # dS^T transposed by the tensor cores: an identity block times dS^T's
    # hi (then lo) values as B fragments, exact (one nonzero term a sum),
    # two m16n8k8 an 8 x 16 block, 8 a 16 x 16 block; dQ's rows then in
    # the order 0, 2, 4, 6, 1, 3, 5, 7 of each 8
    "mma_transpose": [
        ("          uint32_t da[2][4];\n#pragma unroll\n          for (int part = 0; part < 2; ++part) {\n"
         "#pragma unroll\n            for (int nt = 0; nt < 2; ++nt) {\n" + _F_MOVM + "\n"
         "            }\n          }",
         "          const uint32_t one = __float_as_uint(1.f);\n"
         "          const uint32_t on = g == t ? one : 0u, on4 = g == t + 4 ? one : 0u;\n"
         "          const uint32_t eye[2][4] = {{on, 0u, on4, 0u}, {0u, on, 0u, on4}};\n"
         "          uint32_t da[2][4];\n#pragma unroll\n          for (int part = 0; part < 2; ++part) {\n"
         "            float x[4] = {0.f, 0.f, 0.f, 0.f};\n"
         "            mma_tf32(x, eye[0], ds[0][part][kb], ds[0][part][kb + 2]);\n"
         "            mma_tf32(x, eye[1], ds[1][part][kb], ds[1][part][kb + 2]);\n"
         "#pragma unroll\n"
         "            for (int i = 0; i < 4; ++i) da[part][i] = __float_as_uint(x[c2a(i)]);\n"
         "          }"),
        ("      const int qrow = h * 16 + g;",
         "      const int qrow = h * 16 + ((g & 3) << 1) + (g >> 2);")],
    # one tf32 product a product (the lo terms dropped; wrong values)
    "one_product": [("  mma_tf32(d, a[1], b[0], b[1]);\n  mma_tf32(d, a[0], b[2], b[3]);\n", "", 0,
                     _HDR)],
    # lo rounded by a second cvt.rna (not left to the tensor cores' truncation)
    "lo_cvt": [("  lo = __float_as_uint(x - __uint_as_float(hi));",
                "  lo = tf32(x - __uint_as_float(hi));", 0, _HDR)],
    # dK and dV summed by the tensor cores over the whole pass (no chunk partials)
    "no_partials": [(_F_DVC, "          mma_tf32x3(dva[mt], pa, gd[nt]);\n"
                             "          mma_tf32x3(dka[mt], ds[nt], gq[nt]);")],
    "no_sum": VARIANTS["no_sum"],
    "h_unroll_2": [(_F_H_LOOP, _F_H_LOOP.replace("unroll 1", "unroll 2"))],
    "h_unroll_full": [(_F_H_LOOP, _F_H_LOOP.replace("unroll 1", "unroll"))],
    "regs_168": [(_F_REGS, "static constexpr int kRegs = 168;")],
    "regs_200": [(_F_REGS, "static constexpr int kRegs = 200;")],
    # 64 queries a chunk from 8 warps too
    "chunk_64": [("static constexpr int kWideChunk = 128;", "static constexpr int kWideChunk = 64;", 1)],
    # 16 keys a warp, up to 16 warps (128 registers); 64 keys a warp
    "keys16": [(_F_MT, "static constexpr int kMT = 1;"),
               (_F_WARPS, "static constexpr int kMaxWarps = 16;"),
               (_F_REGS, "static constexpr int kRegs = 128;"),
               ("static constexpr int kWideChunk = 128;", "static constexpr int kWideChunk = 64;",
                1)],
    "keys64": [(_F_MT, "static constexpr int kMT = 4;")],
    # 4 warps a CTA at most (three CTAs an SM)
    "warps4": [(_F_WARPS, "static constexpr int kMaxWarps = 4;")],
    # dQ in two accumulators (one a key half of the tile): two chains of
    # dependent products where there was one
    "dq_two_acc": [("      float dqa[4] = {0.f, 0.f, 0.f, 0.f};",
                    "      float dqa[4] = {0.f, 0.f, 0.f, 0.f}, dqb[4] = {0.f, 0.f, 0.f, 0.f};", 1),
                   ("          mma_tf32x3(dqa, da, kv.kt[mt][kb]);",
                    "          mma_tf32x3(kb ? dqb : dqa, da, kv.kt[mt][kb]);"),
                   ("      const int qrow = h * 16",
                    "      for (int i = 0; i < 4; ++i) dqa[i] += dqb[i];\n      const int qrow = h * 16")],
}
# the fp32 plan rule's (keys a warp, most warps a CTA) under a variant
FP32_PLAN = {"keys16": (16, 16), "keys64": (64, 8), "warps4": (32, 4)}
# (keys, slices, warps) timed beside the taken plan, by shape (bf16)
EXTRA_PLANS = {
    (32, 16, 1024, 8): ((512, 2, 8),),
    (32, 32, 256, 8): (),
    (8, 64, 256, 8): (),
    (4, 16, 4096, 8): ((512, 8, 8),),
}


@contextlib.contextmanager
def _fp32_rule(warp_keys: int, max_warps: int):
    """tinyhead_bwd_plan's fp32 keys a warp and most warps, for a while."""
    from masked_diffusion_tpu_torch.ops import tinyhead_attention as tth

    saved = tth.BWD_WARP_KEYS[4], tth.BWD_MAX_WARPS[4]
    tth.BWD_WARP_KEYS[4], tth.BWD_MAX_WARPS[4] = warp_keys, max_warps
    try:
        yield
    finally:
        tth.BWD_WARP_KEYS[4], tth.BWD_MAX_WARPS[4] = saved


def _start(name: str, replacements):
    """Copy csrc/ with the variant's replacements and start nvcc on the
    backward's source; returns (library path, object, process)."""
    from masked_diffusion_tpu_torch.ops import build

    src = os.path.join(build.BUILD_DIR, "tinyhead_bwd_variants", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    for old, new, *where in replacements:
        nth, file = (list(where) + [0, _SRC][len(where):])[:2]
        path = os.path.join(src, file)
        with open(path) as f:
            text = f.read()
        at = -1
        for _ in range(nth + 1):
            at = text.find(old, at + 1)
            if at < 0:
                raise ValueError(f"{name}: {old!r} not {nth + 1} times in csrc/{file}")
        with open(path, "w") as f:
            f.write(text[:at] + new + text[at + len(old):])
    path = os.path.join(src, _SRC)
    obj = path + ".o"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", obj, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return os.path.join(src, "libvariant.so"), obj, proc


def _finish(name: str, lib: str, obj: str, proc, traits: str):
    """(the loaded library, ptxas's register and spill lines of the d == 8
    instances of `traits` (Bf16 or Tf32))."""
    from masked_diffusion_tpu_torch.ops import build

    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{out}")
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-o", lib, obj], check=True)
    loaded = ctypes.CDLL(lib)
    build.declare_tinyhead_bwd(loaded)
    lines = out.splitlines()
    regs = []
    for i, line in enumerate(lines):
        if "tinyhead_bwd_kernelI" in line and traits in line and "Lb1E" in line:
            regs += [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
    return loaded, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=None, help="these only (default all)")
    ap.add_argument("--s", nargs="*", type=int, default=None, help="these S only (default all)")
    args = ap.parse_args(argv)
    fp32 = args.dtype == "fp32"
    table = VARIANTS_FP32 if fp32 else VARIANTS
    out_path = args.out or os.path.join(
        _ROOT, "build", f"tinyhead_bwd_variants{'_fp32' if fp32 else ''}.json")

    import torch

    if not torch.cuda.is_available():
        print("tinyhead_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, _ROOT)
    import chip_smoke
    from masked_diffusion_tpu_torch.ops import build
    from masked_diffusion_tpu_torch.ops import tinyhead_attention as tth

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    names = args.variants or list(table)
    started = {name: _start(name, table[name]) for name in names}  # all at once
    libs = {}
    for name in names:
        libs[name], regs = _finish(name, *started[name], "Tf32" if fp32 else "Bf16")
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    own = build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(19)
    elem = 4 if fp32 else 2
    rows = []

    def plan_of(keys, slices, warps, bh, s, warp_keys):
        parts = slices > 1 or keys > warp_keys * warps
        return tth.TinyheadBwdPlan(keys, slices, warps,
                                   slices * bh * s * tth.HEAD_DIM_MAX * 4 if parts else 0)

    for shape, extra in EXTRA_PLANS.items():
        b, h, s, d = shape
        if args.s and s not in args.s:
            continue
        bh, scale = b * h, 1.0 / math.sqrt(d)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(
            torch.float32 if fp32 else torch.bfloat16) for _ in range(4))
        build._lib = own
        with torch.inference_mode():
            out, lse = tth.tinyhead_forward(q, k, v, scale)
        taken = tth.tinyhead_bwd_plan(bh, s, sms, d, elem)
        # [(plan, {variant: its plan})]: bf16 times every variant on each
        # plan; fp32 each variant on the plan its own rule takes
        groups = []
        if fp32:
            mine = {}
            for name in names:
                wk, mw = FP32_PLAN.get(name, (tth.BWD_WARP_KEYS[4], tth.BWD_MAX_WARPS[4]))
                with _fp32_rule(wk, mw):
                    mine[name] = plan_of(*tth.tinyhead_bwd_plan(bh, s, sms, d, 4)[:3], bh, s, wk)
            groups.append((taken, mine))
        else:
            for p in [taken[:3]] + [p for p in extra if p != taken[:3]]:
                plan = plan_of(*p, bh, s, tth.BWD_WARP_KEYS[2])
                groups.append((plan, {name: plan for name in names}))
        for plan, per_variant in groups:
            best, failed = {}, {}
            for order in (names, names[::-1]):
                for name in order:
                    if name in failed:
                        continue
                    build._lib = libs[name]
                    vplan = per_variant[name]
                    try:
                        with torch.inference_mode():
                            ms = chip_smoke.cuda_ms(
                                lambda: tth.launch_backward(q, k, v, out, lse, g, scale, vplan),
                                max(1, args.reps // (4 if s >= 4096 else 1)))[0]
                    except Exception as e:  # a variant the card refuses (e.g. its shared memory)
                        failed[name] = f"{type(e).__name__}: {e}"[:200]
                        torch.cuda.synchronize()
                        continue
                    best[name] = min(best.get(name, ms), round(ms, 5))
            best.update({name: f"failed: {msg}" for name, msg in failed.items()})
            row = {"shape": shape, "dtype": args.dtype, "plan": plan._asdict(),
                   "taken": plan == taken, "ms": best}
            if fp32:
                row["plans"] = {n: p[:3] for n, p in per_variant.items() if p != taken}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    build._lib = own
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump({"card": smi, "dtype": args.dtype, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
