"""The PyTorch port imports neither jax nor flax, and importing its kernel
modules needs neither triton nor nvcc (only a kernel launch needs them).

Runs in a subprocess: conftest.py imports jax into this process."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys

class NoTriton(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "triton" or name.startswith("triton."):
            raise ImportError("triton is not importable here")
        return None

sys.meta_path.insert(0, NoTriton())
import masked_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from masked_diffusion_tpu_torch.ops import build
assert build._lib is None, "a kernel library was loaded at import"
bad = sorted(m for m in ("jax", "flax", "triton") if m in sys.modules)
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_port_imports_without_jax_triton_or_nvcc():
    env = dict(os.environ)
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on PATH
    env["CUDA_HOME"] = os.path.join(ROOT, "no-such-cuda")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = int(proc.stdout.split("IMPORTED")[1])
    assert n >= 15  # every module of the slice, ops/ to cli/


def test_chip_smoke_refuses_without_cuda():
    """Without CUDA the smoke check exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
