"""The PyTorch port imports nothing of the JAX package (masked_diffusion_tpu
and its submodules), nor jax or flax, and importing its kernel modules needs
neither triton nor nvcc (only a kernel launch needs them).

Two checks: a subprocess (conftest.py imports jax into this process) that
imports every module of the port and runs the CLI's main for --method
mean_shift (with --sampling momentum and --profile_dir, resumed from its
checkpoint, with the default sampling flags, and with
--interpolation_shift), --method sample and --method test on the CPU at toy
size (the default model and the zoo's unet1), the checkpoint import tool,
and an LSUN get_dataset under MDT_NATIVE_PREPROCESS=1, then inspects
sys.modules, and has each of two ranks under
torch.distributed.run (gloo) train and serve data-parallel and inspect its
own; and an AST scan of every .py of the port and of chip_smoke.py for an
import of masked_diffusion_tpu."""

import ast
import glob
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

import contextlib, io, json, os, tempfile
from masked_diffusion_tpu_torch.cli.main_train_masked import main
with tempfile.TemporaryDirectory() as work:
    args = ["--data_name", "synthetic", "--data_size", "16", "--data_subset", "True",
            "--data_subset_num", "8", "--batch_size", "4", "--num_epochs", "1",
            "--sample_num", "2", "--ddpm_schedule", "log", "--ddpm_num_steps", "6",
            "--mean_option", "degraded_area", "--sampling", "momentum", "--use_wandb", "False",
            "--block_out_channels", "32,64", "--layers_per_block", "1", "--device", "cpu",
            "--dir_work", work]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--method", "mean_shift", "--profile_dir", os.path.join(work, "prof")] + args)
    assert os.listdir(os.path.join(work, "prof")) == ["trace_rank0.json"]
    line = [l for l in buf.getvalue().splitlines() if l.startswith("train_stats ")][-1]
    ckpt = json.loads(line.split(" ", 1)[1])["checkpoints"][-1]
    with contextlib.redirect_stdout(buf):
        main(["--method", "sample", "--test_model_path", ckpt] + args)
    assert "sample_stats " in buf.getvalue()
    # the import tool, and an LSUN archive under MDT_NATIVE_PREPROCESS
    from masked_diffusion_tpu_torch.io import import_torch
    with contextlib.redirect_stdout(buf):
        import_torch.main([ckpt, os.path.join(work, "imported")])
    from PIL import Image
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.tools.lmdb_write import write_lmdb
    pngs = {}
    for i in range(2):
        png = io.BytesIO()
        Image.new("RGB", (12, 10), (40 * i, 90, 200)).save(png, format="PNG")
        pngs[b"k%d" % i] = png.getvalue()
    write_lmdb(os.path.join(work, "lsun", "church_outdoor_train_lmdb"), pngs)
    os.environ.update(MDT_NATIVE_PREPROCESS="1", MDT_NATIVE_CACHE=os.path.join(work, "native"))
    assert get_dataset(work, "lsun", 8, split="church").data.shape == (2, 8, 8, 3)
    del os.environ["MDT_NATIVE_PREPROCESS"]
    # a resumed run: one epoch more from that checkpoint
    with contextlib.redirect_stdout(buf):
        main(["--method", "mean_shift"] + args + [
            "--num_epochs", "2", "--resume_from_checkpoint", "latest",
            "--output_dir", os.path.dirname(ckpt), "--keep_last_checkpoints", "1"])
    assert "Resuming from checkpoint" in buf.getvalue()
    # the default sampling flags: the cadence captures a trajectory
    i = args.index("--sampling")
    with contextlib.redirect_stdout(buf):
        main(["--method", "mean_shift"] + args[:i] + args[i + 2:])
    # interpolation sampling on the training cadence, then the tester
    # (--method test) on that run's checkpoint
    interp = args + ["--ddpm_schedule", "linear", "--select_degrade_pixel", "thresholding",
                     "--interpolation_shift", "0.5"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--method", "mean_shift"] + interp)
    line = [l for l in buf.getvalue().splitlines() if l.startswith("train_stats ")][-1]
    ckpt = json.loads(line.split(" ", 1)[1])["checkpoints"][-1]
    with contextlib.redirect_stdout(buf):
        main(["--method", "test", "--test_model_path", ckpt] + args + ["--data_subset_num", "1"])
    assert "test_stats " in buf.getvalue()
    # a zoo model, through the tiny-head route's plain version
    zoo = args + ["--model", "unet1", "--data_size", "32", "--tinyhead_attention", "true"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--method", "mean_shift"] + zoo)
    line = [l for l in buf.getvalue().splitlines() if l.startswith("train_stats ")][-1]
    ckpt = json.loads(line.split(" ", 1)[1])["checkpoints"][-1]
    with contextlib.redirect_stdout(buf):
        main(["--method", "sample", "--test_model_path", ckpt] + zoo)
    assert "sample_stats " in buf.getvalue()

bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "triton", "masked_diffusion_tpu"))
assert not bad, bad

# each rank of a 2-rank run (torch.distributed.run, gloo) trains and serves
# data-parallel, then inspects its own sys.modules
RANK = '''
import contextlib, glob, io, json, sys
sys.path.insert(0, sys.argv[1])
from masked_diffusion_tpu_torch.cli.main_train_masked import main
args = json.loads(sys.argv[3])
with contextlib.redirect_stdout(io.StringIO()):
    main(["--method", "mean_shift", "--mesh_data", "2"] + args)
    (ckpt,) = glob.glob(sys.argv[2] + "/**/checkpoint-epoch-*", recursive=True)
    main(["--method", "sample", "--mesh_data", "2", "--test_model_path", ckpt] + args)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "flax", "triton", "masked_diffusion_tpu"))
assert not bad, bad
print("RANK CLEAN", flush=True)
'''
import os, signal, subprocess
with tempfile.TemporaryDirectory() as work:
    script = os.path.join(work, "rank.py")
    with open(script, "w") as f:
        f.write(RANK)
    two = args[:-1] + [work, "--batch_size", "4", "--sample_num", "3"]
    # the launcher and its ranks in a session of their own, killed as a whole on timeout
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         script, os.getcwd(), work, json.dumps(two)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=200)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    assert out.count("RANK CLEAN") == 2, out
print("IMPORTED", len(names))
"""


def test_port_imports_without_jax_triton_or_nvcc():
    env = dict(os.environ)
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on PATH
    env["CUDA_HOME"] = os.path.join(ROOT, "no-such-cuda")
    env["OMP_NUM_THREADS"] = "2"  # the suite's other workers share the cores
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


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_source_of_the_port_imports_the_jax_package():
    files = glob.glob(os.path.join(ROOT, "masked_diffusion_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), name) for f in files for name in _imported_roots(f)
           if name.split(".")[0] in ("masked_diffusion_tpu", "jax", "flax")]
    assert not bad, bad
