"""Run one script of the port's launch farm end to end on the CPU, as
tests/test_launch_exec.py runs the JAX farm's: scripts_torch/train/mnist/
masked_base/script_main.sh as a real subprocess (bash, then the preset's
launcher, then the port's CLI), on a synthesized MNIST IDX set, shrunk
through the script's MDT_* knobs and MDT_EXTRA_ARGS, with MDT_DEVICE=cpu.

  * through scripts_torch/config/gpu_single.sh: one process; the run tree
    holds option.ini, a checkpoint, log/metrics.jsonl and PNGs;
  * through scripts_torch/config/gpu_h100_4.sh with MDT_NPROC=2: the
    torch.distributed.run launcher and 2 gloo ranks (the global batch of 8
    split 4 + 4), one run tree written by rank 0, with the same artifacts.

The preset's `python` is the interpreter running the tests (a directory
holding a wrapper that execs it goes first on PATH).
"""

import glob
import json
import os
import subprocess
import sys

from tests.test_launch_exec import _write_mnist_idx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts_torch", "train", "mnist", "masked_base", "script_main.sh")
CONFIG = os.path.join(REPO, "scripts_torch", "config")


def _run_script(tmp_path, preset, **extra_env):
    """The script through `preset` at toy scale: (stdout, the run tree)."""
    data_dir, work_dir, bin_dir = tmp_path / "dataset", tmp_path / "work", tmp_path / "bin"
    _write_mnist_idx(str(data_dir))
    os.makedirs(work_dir)
    os.makedirs(bin_dir)
    python = bin_dir / "python"
    python.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    python.chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MDT_") and k != "PYTHONPATH"}
    env.update(
        PATH=f"{bin_dir}{os.pathsep}{env.get('PATH', '')}",
        OMP_NUM_THREADS="1",
        MDT_DEVICE="cpu",
        MDT_DIR_DATASET=str(data_dir),
        MDT_DIR_WORK=str(work_dir),
        MDT_DATA_SUBSET_NUM="32",
        MDT_BATCH_SIZE="8",
        MDT_NUM_EPOCHS="2",
        MDT_DDPM_NUM_STEPS="6",
        MDT_SAMPLE_NUM="2",
        MDT_SAVE_IMAGES_EPOCHS="2",
        MDT_EXTRA_ARGS=(
            "--block_out_channels 8,16 --layers_per_block 1 "
            "--lr_warmup_steps 0 --sample_latent_shape zero --mixed_precision no"
        ),
        **extra_env,
    )
    r = subprocess.run(
        ["bash", "-c", f'source "{os.path.join(CONFIG, preset)}" && bash "{SCRIPT}"'],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, f"script failed:\n{r.stdout[-3000:]}\n{r.stderr[-4000:]}"
    runs = glob.glob(str(work_dir / "result" / "mnist_masked" / "mnist" / "base" / "*" / "base_log"))
    assert len(runs) == 1, f"run tree missing: {runs}"
    run = runs[0]
    assert os.path.exists(os.path.join(run, "option", "option.ini"))
    ckpts = glob.glob(os.path.join(run, "checkpoint", "checkpoint-epoch-*"))
    assert ckpts, "no checkpoint written by the save cadence"
    assert glob.glob(os.path.join(run, "log", "**", "metrics.jsonl"), recursive=True)
    assert glob.glob(os.path.join(run, "train", "image", "**", "*.png"), recursive=True)
    return r.stdout, run


def _stats(out):
    (line,) = [ln for ln in out.splitlines() if ln.startswith("train_stats ")]
    return json.loads(line.split(" ", 1)[1])


def test_mnist_masked_base_script_runs_through_the_single_card_preset(tmp_path):
    out, run = _run_script(tmp_path, "gpu_single.sh")
    stats = _stats(out)
    assert stats["ranks"] == 1 and stats["device"] == "cpu" and stats["global_step"] == 8
    assert stats["mesh"] == {"data": 1, "model": 1, "spatial": False}


def test_mnist_masked_base_script_runs_through_the_four_card_preset_on_two_ranks(tmp_path):
    out, run = _run_script(tmp_path, "gpu_h100_4.sh", MDT_NPROC="2")
    stats = _stats(out)
    assert stats["ranks"] == 2 and stats["global_step"] == 8
    assert stats["mesh"] == {"data": 2, "model": 1, "spatial": False}
    dist_line = json.loads([ln for ln in out.splitlines() if ln.startswith("dist: ")][0][6:])
    assert dist_line["backend"] == "gloo" and dist_line["world_size"] == 2
