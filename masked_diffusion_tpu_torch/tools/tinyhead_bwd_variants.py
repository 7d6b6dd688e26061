"""Device times of variants of the bf16 tiny-head backward kernel: where its
time goes.

    python -m masked_diffusion_tpu_torch.tools.tinyhead_bwd_variants [--out FILE]

Run from the root of a checkout on a machine with the GPU. Each variant is
csrc/tinyhead_attention_bwd.cu with text replacements, built alone into a
library of its own under build/tinyhead_bwd_variants/ (all nvcc processes
started together). A variant that drops work computes wrong gradients: it
only says what that work costs. At each main shape of chip_smoke.py's
TINYHEAD_SHAPES, on the plan tinyhead_bwd_plan takes (`taken`) and on the
other plans listed in EXTRA_PLANS, every variant is timed by CUDA-graph
replay (chip_smoke.cuda_ms, 20 calls a graph replayed 10 times, 5 at
S=4096), the variants in order and then in reverse, the lesser of the two
kept. Prints the card and one JSON
line a shape and plan, and writes them all to FILE (default
build/tinyhead_bwd_variants.json). The checkout's sources are never
changed.
"""

from __future__ import annotations

import argparse
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

_H_LOOP = "#pragma unroll\n      for (int h = 0; h < kC / 16; ++h) {"

# name: [(old, new)] in csrc/tinyhead_attention_bwd.cu, each the first occurrence
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
                 "                                  movtrans(sa[3])};",
                 "const uint32_t da[4] = {sa[0], sa[2], sa[1], sa[3]};")],
    # one probability in 4 on the FMA pipe (exp2_fma)
    "fma_exp_1of4": [(_MOVM_NOTE, _EXP2_FMA + _MOVM_NOTE),
                     ("float p = ex2(fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x));",
                      "const float x = fmaf(sc[i], c, (i & 1) ? -ls[nt].y : -ls[nt].x);\n"
                      "              float p = i == 3 ? exp2_fma(x) : ex2(x);")],
    # no dQ sums across the warps, nothing written to dq or the workspace
    "no_sum": [("if (j > 0) reduce_chunk(j - 1, pass == 0);", ""),
               ("    reduce_chunk(chunks - 1, pass == 0);", "")],
    # one more m16n8k16 product a 16-key x 16-query block (into dV: wrong
    # values), or eight more exp2 (into P: wrong values)
    "extra_hmma": [("          mma_k16(dva[mt], pa, dot);",
                    "          mma_k16(dva[mt], pa, dot);\n          mma_k16(dva[mt], sa, dot);")],
    "extra_ex2": [("              sc[i] = p;", "              sc[i] = p + ex2(p - 1.f);")],
    # the 16-query loop of a chunk unrolled 1, 2 or 4 times, not fully
    "h_unroll_1": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 1"))],
    "h_unroll_2": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 2"))],
    "h_unroll_4": [(_H_LOOP, _H_LOOP.replace("#pragma unroll", "#pragma unroll 4"))],
    "regs_96": [(_REGS, "constexpr int kRegs = 96;")],
    "regs_112": [(_REGS, "constexpr int kRegs = 112;")],
    # 64 queries a chunk at every width, or 128
    "chunk_64": [("return warps >= 8 ? 128 : 64;", "return 64;")],
    "chunk_128": [("return warps >= 8 ? 128 : 64;", "return 128;")],
}
# (keys, slices, warps) timed beside the taken plan, by shape
EXTRA_PLANS = {
    (32, 16, 1024, 8): ((512, 2, 8),),
    (32, 32, 256, 8): (),
    (8, 64, 256, 8): (),
    (4, 16, 4096, 8): ((512, 8, 8),),
}


def _start(name: str, replacements):
    """Copy csrc/ with the variant's replacements and start nvcc on the
    backward's source; returns (library path, object, process)."""
    from masked_diffusion_tpu_torch.ops import build

    src = os.path.join(build.BUILD_DIR, "tinyhead_bwd_variants", name)
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, src)
    path = os.path.join(src, _SRC)
    with open(path) as f:
        text = f.read()
    for old, new in replacements:
        if old not in text:
            raise ValueError(f"{name}: {old!r} not in csrc/{_SRC}")
        text = text.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(text)
    obj = path + ".o"
    proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c", "-o", obj, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return os.path.join(src, "libvariant.so"), obj, proc


def _finish(name: str, lib: str, obj: str, proc):
    """(the loaded library, ptxas's register and spill lines)."""
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
        if "tinyhead_bwd_mma_kernelILi" in line and "ELb1E" in line:  # the d == 8 instances
            regs += [x.strip() for x in lines[i + 1:i + 4] if "registers" in x or "spill" in x]
    return loaded, regs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(_ROOT, "build", "tinyhead_bwd_variants.json"))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", nargs="*", default=None, help="these only (default all)")
    ap.add_argument("--s", nargs="*", type=int, default=None, help="these S only (default all)")
    args = ap.parse_args(argv)

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
    names = args.variants or list(VARIANTS)
    started = {name: _start(name, VARIANTS[name]) for name in names}  # all at once
    libs = {}
    for name in names:
        libs[name], regs = _finish(name, *started[name])
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    own = build.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(19)
    rows = []
    for shape, extra in EXTRA_PLANS.items():
        b, h, s, d = shape
        if args.s and s not in args.s:
            continue
        bh, scale = b * h, 1.0 / math.sqrt(d)
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for _ in range(4))
        build._lib = own
        with torch.inference_mode():
            out, lse = tth.tinyhead_forward(q, k, v, scale)
        taken = tth.tinyhead_bwd_plan(bh, s, sms, d)
        plans = [taken[:3]] + [p for p in extra if p != taken[:3]]
        for keys, slices, warps in plans:
            parts = slices > 1 or keys > tth.BWD_WARP_KEYS * warps
            plan = tth.TinyheadBwdPlan(keys, slices, warps,
                                       slices * bh * s * tth.HEAD_DIM_MAX * 4 if parts else 0)
            best = {}
            for order in (names, names[::-1]):
                for name in order:
                    build._lib = libs[name]
                    with torch.inference_mode():
                        ms = chip_smoke.cuda_ms(
                            lambda: tth.launch_backward(q, k, v, out, lse, g, scale, plan),
                            max(1, args.reps // (4 if s >= 4096 else 1)))[0]
                    best[name] = min(best.get(name, ms), round(ms, 5))
            row = {"shape": shape, "plan": plan._asdict(), "taken": plan == taken, "ms": best}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del q, k, v, g, out, lse
        torch.cuda.empty_cache()
    build._lib = own
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
