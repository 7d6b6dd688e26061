"""Instructions of one Philox4x32-10 draw as the exact-k kernels compile it.

    python -m masked_diffusion_tpu_torch.tools.philox_sass

Run from the root of a checkout on a machine with nvcc and cuobjdump (no
GPU needed). Two probe kernels include csrc/exact_k.cuh and are built for
sm_90a with the package's flags: one writes philox4x32_10_first at a
counter made from the thread index, its twin writes the same counter words
xor-ed together, with no draw. The draw's cost is the difference of their
SASS instruction counts, by opcode, as `cuobjdump -sass` lists them;
chip_smoke.py's PHILOX_INT_OPS is that count. Prints one JSON line.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

PROBE = r"""
#include <cstdint>
#include "exact_k.cuh"

extern "C" __global__ void probe_draw(uint32_t* out, uint32_t c1, uint32_t c2, uint32_t c3,
                                      uint32_t k0, uint32_t k1) {
  const uint32_t p = blockIdx.x * blockDim.x + threadIdx.x;
  out[p] = mdt::philox4x32_10_first(p, c1, c2, c3, k0, k1);
}

extern "C" __global__ void probe_none(uint32_t* out, uint32_t c1, uint32_t c2, uint32_t c3,
                                      uint32_t k0, uint32_t k1) {
  const uint32_t p = blockIdx.x * blockDim.x + threadIdx.x;
  out[p] = p ^ c1 ^ c2 ^ c3 ^ k0 ^ k1;
}
"""
# opcodes that are not work: padding, control flow and the end of the kernel
_NOT_WORK = {"NOP", "EXIT", "BRA", "RET"}


def sass_counts(sass: str) -> dict:
    """{kernel name: Counter of opcodes} from `cuobjdump -sass` output."""
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            op = m.group(1).split(".")[0]
            if op not in _NOT_WORK:
                counts[name][op] += 1
    return counts


def main() -> int:
    from masked_diffusion_tpu_torch.ops import build

    nvcc = build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(cuobjdump):
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        flags = [f for f in build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([nvcc, *flags, "-I", build.CSRC_DIR, "-cubin", "-o", cubin, src],
                       check=True, capture_output=True, text=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True, capture_output=True,
                              text=True).stdout
    counts = sass_counts(sass)
    draw, none = counts["probe_draw"], counts["probe_none"]
    diff = draw.copy()
    diff.subtract(none)
    per_draw = {op: n for op, n in sorted(diff.items()) if n}
    print(json.dumps({"instructions_per_draw": sum(per_draw.values()), "by_opcode": per_draw,
                      "probe_draw": sum(draw.values()), "probe_none": sum(none.values()),
                      "flags": flags}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
