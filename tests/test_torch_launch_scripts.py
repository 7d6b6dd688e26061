"""The PyTorch port's launch farm (scripts_torch/): every workload script
parses with the port's CLI parser (build_parser and --device) and rebuilds
its schedule, as tests/test_launch_scripts.py checks the JAX farm; each
one passes the flags of its scripts/train/** counterpart, value for value
(the MDT_* overrides and their defaults included), except the listed ones
that the port adds: --device and, for the --method test scripts, the
topology flags; its command is the preset's launcher in front of the
port's CLI, and it ends with MDT_EXTRA_ARGS. Every topology preset,
sourced in bash, gives a plan that parallel/mesh.make_mesh accepts at the
world size its launcher starts (a faked process group), on which every
training script's global batch splits and, under the spatial preset, every
image height does."""

import glob
import os
import re
import subprocess
import types

import pytest

from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.parallel import mesh
from masked_diffusion_tpu_torch.parallel.sp import validate_spatial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TRAIN = os.path.join(REPO, "scripts_torch", "train")
JAX_TRAIN = os.path.join(REPO, "scripts", "train")
RELS = sorted(os.path.relpath(p, PORT_TRAIN)
              for p in glob.glob(os.path.join(PORT_TRAIN, "**", "*.sh"), recursive=True))
PRESETS = sorted(os.path.basename(p)
                 for p in glob.glob(os.path.join(REPO, "scripts_torch", "config", "*.sh")))

TOPOLOGY = {
    "mesh_data": "${MDT_MESH_DATA:--1}",
    "mesh_model": "${MDT_MESH_MODEL:-1}",
    "tp_min_features": "${MDT_TP_MIN_FEATURES:-256}",
    "mesh_spatial": "${MDT_MESH_SPATIAL:-False}",
    "multihost": "${MDT_MULTIHOST:-False}",
}
# the flags a port script may add to its JAX counterpart's, with the value
# it must give them
PORT_ONLY = {"device": "${MDT_DEVICE:-cuda}", **TOPOLOGY}
LAUNCH = "${MDT_LAUNCHER:-python} -m masked_diffusion_tpu_torch.cli.main_train_masked \\"
JAX_LAUNCH = "python -m masked_diffusion_tpu.cli.main_train_masked \\"

_FLAG_RE = re.compile(r"--([a-z_0-9]+)\s+\"?([^\"\\\s]*)\"?\s*\\?$")


def _read(path):
    """(flags as written, {name: raw value}; the other command lines)."""
    flags, other = {}, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            m = _FLAG_RE.match(line)
            if m:
                assert m.group(1) not in flags, f"{path}: --{m.group(1)} twice"
                flags[m.group(1)] = m.group(2)
            else:
                other.append(line)
    return flags, other


def _default(raw):
    """The value a ${VAR:-default} takes with VAR unset."""
    env = re.fullmatch(r"\$\{[A-Z_]+:-(.*)\}", raw)
    return env.group(1) if env else raw


def test_the_port_farm_has_every_script_of_the_jax_farm():
    jax_rels = sorted(os.path.relpath(p, JAX_TRAIN)
                      for p in glob.glob(os.path.join(JAX_TRAIN, "**", "*.sh"), recursive=True))
    assert RELS == jax_rels and len(RELS) == 20
    assert PRESETS == ["gpu_h100_4.sh", "gpu_h100_4_sp2.sh", "gpu_h100_4_tp2.sh",
                       "gpu_multinode.sh", "gpu_single.sh"]


@pytest.mark.parametrize("rel", RELS)
def test_port_script_flags_parse(rel):
    flags, _ = _read(os.path.join(PORT_TRAIN, rel))
    argv = []
    for k, v in flags.items():
        argv.extend([f"--{k}", _default(v)])
    args = port_cli._parse_args(argv)  # the CLI's parser: SystemExit on a bad flag
    assert args.device == "cuda"
    assert args.method in ("base", "mean_shift", "test")
    if args.method in ("base", "mean_shift"):
        build_schedule(args.ddpm_schedule, min(args.ddpm_num_steps, args.data_size**2),
                       args.data_size, args.select_degrade_pixel)


@pytest.mark.parametrize("rel", RELS)
def test_port_script_matches_its_jax_counterpart(rel):
    """Flag by flag, the raw text of each value (so the MDT_* variable and
    its default too); the port adds only PORT_ONLY's flags at their
    values; the other lines (set -e, cd, the guards) are the same, the
    launcher line aside, and MDT_EXTRA_ARGS comes last."""
    port, port_other = _read(os.path.join(PORT_TRAIN, rel))
    ref, ref_other = _read(os.path.join(JAX_TRAIN, rel))
    for k, v in ref.items():
        assert port.get(k) == v, f"--{k}: port {port.get(k)!r}, JAX {v!r}"
    added = {k: v for k, v in port.items() if k not in ref}
    assert added.keys() <= PORT_ONLY.keys(), added
    assert all(PORT_ONLY[k] == v for k, v in added.items()), added
    assert "device" in added
    if port["method"] == '"test"':  # the tester runs on the port's grids too
        assert added.keys() == PORT_ONLY.keys()
    assert port_other[-1] == "${MDT_EXTRA_ARGS}"
    ref_other = [ln for ln in ref_other if ln != "${MDT_EXTRA_ARGS}"]
    assert port_other[:-1] == [LAUNCH if ln == JAX_LAUNCH else ln for ln in ref_other]
    assert JAX_LAUNCH in ref_other


def _sourced(preset, **env):
    """The MDT_* variables a preset exports, sourced in bash."""
    out = subprocess.run(
        ["bash", "-c", f'source "{os.path.join(REPO, "scripts_torch", "config", preset)}" '
                       '&& env -0'],
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"), **env},
        capture_output=True, text=True, check=True).stdout
    pairs = (item.split("=", 1) for item in out.split("\0") if "=" in item)
    return {k: v for k, v in pairs if k.startswith("MDT_")}


def _world(launcher):
    """The ranks a launcher starts: nproc_per_node x nnodes under
    torch.distributed.run, else one process."""
    words = launcher.split()
    if words[:3] != ["python", "-m", "torch.distributed.run"]:
        assert words == ["python"], launcher
        return 1

    def opt(name, default):
        return int(words[words.index(name) + 1]) if name in words else default

    return opt("--nproc_per_node", 1) * opt("--nnodes", 1)


def _fake_group(monkeypatch, world):
    """mesh's view of a process group of `world` ranks, this one rank 0."""
    fake = types.SimpleNamespace(
        is_initialized=lambda: True, get_world_size=lambda group=None: world,
        get_rank=lambda group=None: 0, new_group=lambda ranks: tuple(ranks),
        group=types.SimpleNamespace(WORLD=object()))
    monkeypatch.setattr(mesh, "dist", fake)
    monkeypatch.setattr(mesh, "_GROUPS", {})


@pytest.mark.parametrize("preset,world,env", [
    ("gpu_single.sh", 1, {}),
    ("gpu_h100_4.sh", 4, {}),
    ("gpu_h100_4.sh", 2, {"MDT_NPROC": "2"}),
    ("gpu_h100_4_tp2.sh", 4, {}),
    ("gpu_h100_4_sp2.sh", 4, {}),
    ("gpu_multinode.sh", 8, {"MDT_NNODES": "2", "MDT_RDZV_ENDPOINT": "node0:29400"}),
])
def test_preset_plans_are_accepted(monkeypatch, preset, world, env):
    var = _sourced(preset, **env)
    assert _world(var["MDT_LAUNCHER"]) == world
    _fake_group(monkeypatch, world)
    spatial = var["MDT_MESH_SPATIAL"] == "True"
    plan = mesh.make_mesh(int(var["MDT_MESH_DATA"]), int(var["MDT_MESH_MODEL"]), "cpu",
                          spatial=spatial)
    assert plan.world_size == world and plan.data_size * plan.model_size == world
    assert var["MDT_MULTIHOST"] == str(preset == "gpu_multinode.sh")
    if plan.model_size > 1:
        assert len(plan.data_group) == plan.data_size
        assert len(plan.model_group) == plan.model_size
    # every training script's global batch splits over the data ranks, and
    # under the spatial preset every image height over the model ranks
    for rel in RELS:
        flags, _ = _read(os.path.join(PORT_TRAIN, rel))
        if "batch_size" in flags and _default(flags["method"]) != "test":
            mesh.local_rows(int(_default(flags["batch_size"])), plan)
        if spatial:
            validate_spatial(plan, int(_default(flags["data_size"])))


def test_multinode_preset_needs_its_rendezvous():
    r = subprocess.run(
        ["bash", "-c", f'source "{os.path.join(REPO, "scripts_torch", "config", "gpu_multinode.sh")}"'],
        env={"PATH": os.environ.get("PATH", "/usr/bin:/bin")}, capture_output=True, text=True)
    assert r.returncode != 0 and "MDT_NNODES" in r.stderr
