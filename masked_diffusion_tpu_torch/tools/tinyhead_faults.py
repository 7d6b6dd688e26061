"""Planted faults in the tiny-head attention kernels, and what phase 11 of
chip_smoke.py reads for each.

    python -m masked_diffusion_tpu_torch.tools.tinyhead_faults [--jobs N] [NAME ...]

Run from the root of a checkout on a machine with the GPU. For each fault
(all of FAULTS by default) it copies the package and chip_smoke.py into a
temporary directory, changes the one line the fault names, and runs phase
1 and phase 11 there: the copy builds its own kernels and phase 11 must
fail. Prints, per fault, the exit code and phase 11's last lines (the check
that caught it, with its reading against its limit). --jobs N runs N faults
at once on the card (each phase 11 holds up to ~20 GB of it at S=4096; 2
fit). The checkout itself is never changed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import shutil
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_CU = "masked_diffusion_tpu_torch/csrc/"
_LAST_TILE = "for (int tile = 0; tile < tiles; ++tile) {"
_BUT_LAST = "for (int tile = 0; tile < tiles - 1 + (tiles == 1); ++tile) {"
_BWD = _CU + "tinyhead_attention_bwd.cu"
_RN = ("if (col < d) p[0] = __float2bfloat16_rn(c0);\n"
       "  if (col + 1 < d) p[1] = __float2bfloat16_rn(c1);")
_MMA = _CU + "tinyhead_mma.cuh"
_LO_HI = "  mma_tf32(d, a[1], b[0], b[1]);\n"
_HI_LO = "  mma_tf32(d, a[0], b[2], b[3]);\n"
_SLICES = "for (int sl = 1; sl < slices; ++sl) {"

# name: (file, text, replacement); the first occurrence is replaced
FAULTS = {
    "fwd_drops_last_key_tile": (_CU + "tinyhead_attention.cu", _LAST_TILE, _BUT_LAST),
    "fwd_misses_rescale": (
        _CU + "tinyhead_attention.cu",
        "          acc[mt][2 * r] *= corr;\n          acc[mt][2 * r + 1] *= corr;\n", ""),
    "truncating_p_and_ds": (_MMA, "cvt.rn.bf16x2.f32", "cvt.rz.bf16x2.f32"),
    "truncating_output": (_MMA, _RN, _RN.replace("_rn(", "_rz(")),
    # the backward (csrc/tinyhead_attention_bwd.cu): the last slice's dQ sums
    # left out of the bf16 slice sum; each slice's last query chunk skipped
    # and D taken from the neighbouring row's O (both dtypes); bf16 dS
    # rounded toward zero
    "bwd_dq_drops_a_slice": (_BWD, _SLICES,
                             "for (int sl = 1; sl < slices - (sizeof(T) == 2); ++sl) {"),
    "bwd_skips_last_query_chunk": (_BWD, "for (int j = 0; j < chunks; ++j) {",
                                   "for (int j = 0; j < chunks - 1 + (chunks == 1); ++j) {"),
    "bwd_d_from_wrong_row": (_BWD, "Tr::dot(st.dout[r], st.o[r])",
                             "Tr::dot(st.dout[r], st.o[r ^ 1])"),
    "bwd_ds_toward_zero": (
        _BWD, "sa[2 * nt] = pack_bf16(dp[0], dp[1]);\n"
              "          sa[2 * nt + 1] = pack_bf16(dp[2], dp[3]);",
        'asm("cvt.rz.bf16x2.f32 %0, %1, %2;" : "=r"(sa[2 * nt]) : "f"(dp[1]), "f"(dp[0]));\n'
        '          asm("cvt.rz.bf16x2.f32 %0, %1, %2;" : "=r"(sa[2 * nt + 1]) : "f"(dp[3]), '
        '"f"(dp[2]));'),
    # the fp32 (split-TF32) kernels: the lo terms dropped (one tf32 product
    # a product); the hi x lo product skipped; the last slice left out of
    # the fp32 dQ sum; the forward's P rounded toward zero to tf32 in place
    # of its split (its lo lost)
    "fp32_lo_terms_dropped": (_MMA, _LO_HI + _HI_LO, ""),
    "fp32_skips_hi_lo": (_MMA, _HI_LO, ""),
    "fp32_dq_drops_a_slice": (_BWD, _SLICES,
                              "for (int sl = 1; sl < slices - (sizeof(T) == 4); ++sl) {"),
    "fp32_p_split_toward_zero": (
        _CU + "tinyhead_attention.cu", "split_tf32(sc[nt][c2a(i)], pa[0][i], pa[1][i]);",
        "{ pa[0][i] = __float_as_uint(sc[nt][c2a(i)]) & 0xffffe000u; pa[1][i] = 0u; }"),
}


def run(name: str):
    """(exit code of phase 11 on a copy with the fault, its report)."""
    path, text, replacement = FAULTS[name]
    with tempfile.TemporaryDirectory(prefix=f"tinyhead_{name}_") as work:
        shutil.copytree(_PKG, os.path.join(work, "masked_diffusion_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), work)
        target = os.path.join(work, path)
        with open(target) as f:
            src = f.read()
        if text not in src:
            raise ValueError(f"{name}: {text!r} not in {path}")
        with open(target, "w") as f:
            f.write(src.replace(text, replacement, 1))
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke as c; c.phase_env(); c.phase_tinyhead()"],
            cwd=work, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if ln.startswith("[11]") or "Error" in ln]
    return proc.returncode, "\n".join([f"=== {name}: exit {proc.returncode}"]
                                      + [f"    {ln}" for ln in lines[-3:]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=1, help="faults run at once")
    ap.add_argument("names", nargs="*", help="these faults only (default all)")
    args = ap.parse_args(argv)
    names = args.names or list(FAULTS)
    caught = []
    with concurrent.futures.ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for code, report in pool.map(run, names):
            print(report, flush=True)
            caught.append(code != 0)
    print(f"{sum(caught)} of {len(names)} faults caught by phase 11")
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
