"""Planted faults in the GroupNorm kernels, and what phase 7 of chip_smoke.py
reads for each.

    python -m masked_diffusion_tpu_torch.tools.groupnorm_faults [NAME ...]

Run from the root of a checkout on a machine with the GPU. For each fault
(all of FAULTS by default) it copies the package and chip_smoke.py into a
temporary directory, changes the one line the fault names, and runs phase 1
and phase 7 (GroupNorm with grad at every flagship norm shape, batch 64)
there: the copy builds its own kernels and phase 7 must fail. Prints, per
fault, the exit code and phase 7's last lines (the check that caught it,
with its reading against its limit). The checkout itself is never changed.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_CU = "masked_diffusion_tpu_torch/csrc/groupnorm.cu"

# name: (file, text, replacement); the first occurrence is replaced
FAULTS = {
    # the forward's cluster sum leaves out the last CTA's partial
    "cluster_sum_drops_a_cta": (
        _CU, "for (int r = 0; r < a.ctas; ++r) {\n        const float* p = "
        "cluster.map_shared_rank(part",
        "for (int r = 0; r < a.ctas - 1; ++r) {\n        const float* p = "
        "cluster.map_shared_rank(part"),
    # dgamma and dbeta leave out the last image's parts
    "dparams_skip_last_image": (_CU, "v[k] = i0 + k < a.batch ?",
                                "v[k] = i0 + k < a.batch - 1 ?"),
    # the per-group arrival counter is never reset, so later calls find no last span
    "counter_not_reset": (_CU, "  if (tid == 0) counters[grp] = 0;\n", ""),
}

_PHASE = ("import chip_smoke as c; c.phase_env(); calls = c.norm_shapes(16); "
          "c.phase_groupnorm_train(calls, c.B_KERNEL, timed=False)")


def run(name: str) -> int:
    path, text, replacement = FAULTS[name]
    with tempfile.TemporaryDirectory(prefix=f"groupnorm_{name}_") as work:
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
        proc = subprocess.run([sys.executable, "-c", _PHASE], cwd=work, capture_output=True,
                              text=True, timeout=900)
    lines = [ln for ln in (proc.stdout + proc.stderr).splitlines()
             if ln.startswith("[7]") or "Error" in ln]
    print(f"=== {name}: exit {proc.returncode}")
    for ln in lines[-3:]:
        print(f"    {ln}")
    sys.stdout.flush()
    return proc.returncode


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or list(FAULTS)
    caught = [run(name) != 0 for name in names]
    print(f"{sum(caught)} of {len(names)} faults caught by phase 7")
    return 0 if all(caught) else 1


if __name__ == "__main__":
    sys.exit(main())
