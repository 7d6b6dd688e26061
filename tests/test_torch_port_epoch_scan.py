"""--epoch_scan true on the CPU: the port's make_train_epoch against JAX's
make_train_epoch on injected draws, and the trainer's scan against its
step-by-step loop.

(1) JAX's epoch (masked_diffusion_tpu/train/step.py:make_train_epoch) is a
lax.scan of the step body that splits a data key once a batch. The fakes
of tests/test_torch_port_train.py read the step index from key[1]; here the
epoch's split (num=2) advances it in the carried key and hands the step its
current index, while the step's own three-way split passes the key through,
so scan step i sees fixture step i's draws. The port's epoch gets the same
draws stacked, and the same index rows into the same images. Tolerances are
that file's: metrics rtol 2e-3 / atol 1e-5; parameter and EMA updates 2e-3
in relative L2, at most 0.1% of the entries outside rtol 2e-3 / atol 1e-5,
none by more than the LR.

(2) The trainer with the scan on equals it with the scan off bit for bit
on the CPU (the same body, from a table indexed by a step counter in place
of the host's numbers): epoch means, LRs, parameters, EMA and the
optimizer's tensors, from the start and after a resume inside the first
epoch (resume_step=1, as tests/test_trainer_e2e.py:255 pins for JAX).

(3) The selection's precedence, JAX's: the flag, then MDT_EPOCH_SCAN, then
off.

(4) The device-data rule (train/trainer.py:use_device_data) against JAX's
Trainer._use_device_data on the same inputs: more than one rank first, then
MDT_DEVICE_DATA, then MDT_DEVICE_DATA_CAP_MB at its edge and its default.
With the cap at 0 the trainer keeps no device copy of the dataset and
copies each step's rows in from the host: the same run bit for bit, and
with the scan on the epoch runs step by step (JAX's use_scan), bitwise
again. On 2 gloo ranks the CLI with --epoch_scan true trains through the
loop and equals the run without it bitwise.
"""

import json
import os
import signal
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu.train import step as jstep
from masked_diffusion_tpu.train import trainer as jtrainer
from masked_diffusion_tpu.utils import host as jhost
from masked_diffusion_tpu_torch import config as tconfig
from masked_diffusion_tpu_torch.data.datasets import get_dataset
from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.parallel import mesh
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import (
    TrainDraws,
    create_train_state,
    make_train_epoch,
)
from masked_diffusion_tpu_torch.train import trainer as trainer_mod
from masked_diffusion_tpu_torch.train.trainer import Trainer, use_device_data, use_epoch_scan
from tests.test_torch_port_train import (
    ATOL,
    CASES,
    RTOL,
    B,
    C,
    _fixtures,
    _jax_fakes,
    _port_draws,
    _train_args,
)
from tests.test_torch_port_unet import (  # noqa: F401
    SIZE,
    jax_unet_random,
    port_unet,
    two_torch_threads,
)

N = 5  # scan steps of (1): the fixtures' STEPS; accumulation 2 makes two updates


@pytest.mark.parametrize("case", sorted(CASES))
def test_make_train_epoch_matches_jax(monkeypatch, case):
    jmodel, jcfg, variables = jax_unet_random(seed=3)
    cfg = Config(data_size=SIZE, ddpm_num_steps=20, mean_option="degraded_area", lr=1e-3,
                 mixed_precision="no", out_channel=C, **CASES[case])
    accum = cfg.gradient_accumulation_steps
    jsched = jax_build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                cfg.select_degrade_pixel)
    used = jsched.timesteps_for_epoch(0, 10, 1)
    fx = _fixtures(len(used), seed=len(case))
    total = 20
    data = fx["images"][:N].reshape(N * B, SIZE, SIZE, C)
    sel = np.arange(N * B).reshape(N, B)

    # --- JAX: one scan over the N index rows
    jlr = joptim.build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum,
                                   total, cfg.lr_cycle)
    tx = joptim.build_optimizer(cfg.optim, jlr, 1.0, accum)
    params = jax.tree.map(jnp.asarray, variables)
    state = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree.map(jnp.copy, params) if cfg.use_ema else None,
        opt_state=tx.init(params))
    _, randint, degrade, shift = _jax_fakes(fx)

    def split(key, num=2):
        if num == 2:  # the epoch's (carry, step key): the carry moves to the next step
            return jnp.stack([key.at[1].add(1), key])
        return jnp.stack([key] * num)

    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jdeg, "degrade_training", degrade)
        m.setattr(jshift, "schedule_shift", shift)
        epoch = jstep.make_train_epoch(jmodel, jsched, cfg, tx, used, jlr, donate=False)
        state, _, jstack = epoch(state, jnp.asarray(data), jnp.asarray(sel, jnp.int32),
                                 jax.random.PRNGKey(0))
        jstack = {k: np.asarray(v) for k, v in jstack.items()}

    # --- port: the same rows, the same draws stacked
    model = port_unet(jcfg, variables).train()
    lr = build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum, total,
                           cfg.lr_cycle)
    opt = build_optimizer(cfg.optim, model.parameters(), lr, 1.0, accum)
    pstate = create_train_state(model, opt, use_ema=cfg.use_ema)
    channels = C if cfg.degrade_channel == "3-channel" else 1
    per_step = [_port_draws(fx, i, channels) for i in range(N)]
    draws = TrainDraws(**{k: torch.stack([getattr(d, k) for d in per_step])
                          for k in vars(per_step[0])})
    epoch_fn = make_train_epoch(model, build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps,
                                                      SIZE, cfg.select_degrade_pixel),
                                cfg, opt, used, lr, device="cpu")
    keys, mat = epoch_fn(pstate, torch.from_numpy(data), torch.from_numpy(sel), draws=draws)

    assert sorted(keys) == sorted(jstack) and mat.shape == (N, len(keys))
    for j, key in enumerate(keys):
        np.testing.assert_allclose(mat[:, j].numpy(), jstack[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert pstate.step == N and opt.count == N // accum and opt.mini_step == N % accum
    pairs = [("params", model, state.params)]
    if cfg.use_ema:
        pairs.append(("ema", pstate.ema_model, state.ema_params))
    init = weights.state_dict_from_flax(variables, jcfg)
    for name, tmod, jtree in pairs:
        ref = weights.state_dict_from_flax(jax.tree.map(np.asarray, jtree), jcfg)
        got = {k: v.detach() for k, v in tmod.state_dict().items()}
        diff2 = upd2 = 0.0
        loose = count = 0
        for k, r in ref.items():
            d = (got[k] - r).abs()
            assert d.max().item() <= cfg.lr, f"{name} {k}: max |diff| {d.max().item()}"
            loose += int((d > ATOL + RTOL * r.abs()).sum())
            count += r.numel()
            diff2 += float((d ** 2).sum())
            upd2 += float(((r - init[k]) ** 2).sum())
        assert upd2 > 0  # the optimizer moved the parameters
        assert (diff2 / upd2) ** 0.5 <= RTOL, f"{name}: update norm differs by {(diff2 / upd2) ** 0.5}"
        assert loose <= 1e-3 * count, f"{name}: {loose} of {count} entries off"


def _trainer_cfg(select: str, scan: bool, accum: int) -> tconfig.Config:
    return tconfig.Config(
        method="mean_shift", data_size=SIZE, batch_size=8, num_epochs=2, use_ema=True,
        block_out_channels=(32, 64), layers_per_block=1,
        ddpm_schedule="log" if select == "indexing" else "linear", ddpm_num_steps=20,
        select_degrade_pixel=select, gradient_accumulation_steps=accum, lr=1e-3,
        lr_warmup_steps=1, save_images_epochs=100, epoch_scan=scan)


def _train(select: str, scan: bool, accum: int, resume_step: int, on_device: bool = True):
    """2 epochs of 3 steps through Trainer.train (no cadence): the epoch
    means, LRs, global step and every tensor of the state. on_device: the
    dataset is on the device, as the environment's rule must have decided
    (the scan runs only there)."""
    data = get_dataset("", "synthetic", SIZE, data_subset=True, num_data=24)
    trainer = Trainer(_trainer_cfg(select, scan, accum), data, device="cpu")
    trainer.train(0, 2, resume_step=resume_step)
    assert (trainer._data_dev is not None) == on_device
    assert (trainer._epoch_fn is not None) == (scan and on_device)
    tensors, scalars = trainer.state.optimizer.state_dict()
    state = {f"p.{k}": v for k, v in trainer.model.state_dict().items()}
    state.update({f"e.{k}": v for k, v in trainer.state.ema_model.state_dict().items()})
    state.update({f"o.{k}": v for k, v in tensors.items()})
    return (trainer.loss_mean_epoch, trainer.lr_list, trainer.global_step,
            {k: v.clone() for k, v in state.items()}, scalars["count"], scalars["mini_step"])


def _assert_same_run(got, ref):
    assert got[:3] == ref[:3] and got[4:] == ref[4:]
    assert got[3].keys() == ref[3].keys()
    for k, v in ref[3].items():
        assert torch.equal(got[3][k], v), k


@pytest.mark.parametrize("resume_step", [0, 1])
@pytest.mark.parametrize("select,accum", [("indexing", 2), ("thresholding", 1)])
def test_trainer_scan_equals_the_loop_bitwise(select, accum, resume_step):
    loop = _train(select, False, accum, resume_step)
    scan = _train(select, True, accum, resume_step)
    _assert_same_run(scan, loop)
    assert loop[2] == 6 - resume_step and all(np.isfinite(loop[0]))


@pytest.mark.parametrize("flag,env,want", [
    (True, "0", True), (False, "1", False), (None, "1", True), (None, "true", True),
    (None, "0", False), (None, "false", False), (None, None, False), (None, "", False),
])
def test_epoch_scan_precedence(monkeypatch, flag, env, want):
    """The flag, then MDT_EPOCH_SCAN, then off: JAX's auto rule is a TPU
    backend, which the port never has."""
    if env is None:
        monkeypatch.delenv("MDT_EPOCH_SCAN", raising=False)
    else:
        monkeypatch.setenv("MDT_EPOCH_SCAN", env)
    assert use_epoch_scan(tconfig.Config(epoch_scan=flag)) is want


_MB = 10**6
_PLAN2 = mesh.MeshPlan(device=torch.device("cpu"), data_size=2)


@pytest.mark.parametrize("ranks,nbytes,env,want", [
    (2, 1, {"MDT_DEVICE_DATA": "1"}, False),  # more than one rank comes first
    (2, 1, {}, False),
    (1, 600 * _MB, {"MDT_DEVICE_DATA": "1"}, True),
    (1, 1, {"MDT_DEVICE_DATA": "0"}, False),
    (1, 1, {"MDT_DEVICE_DATA": "yes", "MDT_DEVICE_DATA_CAP_MB": "1"}, False),  # only "1" forces
    (1, 2 * _MB, {"MDT_DEVICE_DATA_CAP_MB": "2"}, True),  # the cap at nbytes
    (1, 2 * _MB, {"MDT_DEVICE_DATA_CAP_MB": "1.999999"}, False),  # at nbytes - 1 byte
    (1, 0, {"MDT_DEVICE_DATA_CAP_MB": "0"}, True),
    (1, 512 * _MB, {}, True),  # the default cap, 512 MB
    (1, 512 * _MB + 1, {}, False),
])
def test_device_data_rule_is_jaxs(monkeypatch, ranks, nbytes, env, want):
    """The port's rule and JAX's Trainer._use_device_data on the same
    dataset size, rank count and environment."""
    for var in ("MDT_DEVICE_DATA", "MDT_DEVICE_DATA_CAP_MB"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    dataset = types.SimpleNamespace(data=types.SimpleNamespace(nbytes=nbytes))
    monkeypatch.setattr(jhost, "process_count", lambda: ranks)
    jax_says = jtrainer.Trainer._use_device_data(types.SimpleNamespace(dataset=dataset))
    port_says = use_device_data(dataset, _PLAN2 if ranks > 1 else None)
    assert jax_says is want and port_says is want


@pytest.mark.parametrize("scan", [False, True])
def test_host_batches_equal_device_data_bitwise(monkeypatch, scan):
    """MDT_DEVICE_DATA_CAP_MB=0: no device copy of the dataset; each step's
    rows are gathered on the host and copied in. Over 2 epochs entered at
    the first epoch's second batch, losses, LRs and every tensor of the
    state equal the device-data run's bitwise. With the scan asked for, the
    epoch runs step by step (make_train_epoch raises if called) and equals
    it again."""
    for var in ("MDT_DEVICE_DATA", "MDT_DEVICE_DATA_CAP_MB", "MDT_EPOCH_SCAN"):
        monkeypatch.delenv(var, raising=False)
    ref = _train("indexing", False, 2, 1)
    monkeypatch.setenv("MDT_DEVICE_DATA_CAP_MB", "0")

    def no_graphs(*a, **k):
        raise AssertionError("make_train_epoch called with the dataset on the host")

    monkeypatch.setattr(trainer_mod, "make_train_epoch", no_graphs)
    got = _train("indexing", scan, 2, 1, on_device=False)
    _assert_same_run(got, ref)
    assert ref[2] == 5 and all(np.isfinite(ref[0]))


# each rank runs the CLI's main twice, without and with --epoch_scan true,
# in one process group (parallel/mesh.init_distributed reuses it): one
# torch.distributed.run instead of two
_TWO_RUNS = """
import json, sys
from masked_diffusion_tpu_torch.cli.main_train_masked import main
for args in json.loads(sys.argv[1]):
    print("----- run", flush=True)
    assert main(args) == 0
"""


def _torchrun_cli(tmp_path, runs):
    """The CLI on 2 gloo ranks on the CPU under torch.distributed.run, each
    argv of `runs` in turn, in a session of its own, killed as a whole if it
    outlives its limit; the output of each run."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "two_runs.py"
    script.write_text(_TWO_RUNS)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MDT_EPOCH_SCAN", "MDT_DEVICE_DATA")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=root)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         str(script), json.dumps(runs)],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out + err
    # rank 0's lines of each run follow its marker (rank 1 prints one too)
    return [part for part in out.split("----- run\n")[1:] if "train_stats" in part]


def test_two_ranks_with_epoch_scan_train_as_the_loop_bitwise(tmp_path):
    """--epoch_scan true on 2 gloo ranks (the port refused it before): the
    data stays on the host (more than one rank), so the epoch runs step by
    step, as JAX's does, and rank 0 says so once; losses, parameters, EMA
    and AdamW state equal the run without the flag bitwise."""
    argvs = [_train_args(tmp_path / str(scan), "cpu", "--mesh_data", "2",
                         "--block_out_channels", "16,32", "--ddpm_num_steps", "8",
                         *(["--epoch_scan", "true"] if scan else []))
             for scan in (False, True)]
    outs = _torchrun_cli(tmp_path, [[str(a) for a in argv] for argv in argvs])
    assert len(outs) == 2
    runs = {}
    for scan, out in zip((False, True), outs):
        said = [ln for ln in out.splitlines() if ln.startswith("epoch_scan: ")]
        assert said == (["epoch_scan: the epoch runs step by step: 2 ranks"] if scan else [])
        (line,) = [ln for ln in out.splitlines() if ln.startswith("train_stats ")]
        stats = json.loads(line.split(" ", 1)[1])
        assert stats["ranks"] == 2 and stats["global_step"] == 4
        (ckpt,) = stats["checkpoints"]
        runs[scan] = stats["loss_mean_epoch"], ckpt_io.load_checkpoint(ckpt)
    (loop_loss, loop_ckpt), (scan_loss, scan_ckpt) = runs[False], runs[True]
    assert scan_loss == loop_loss and all(np.isfinite(loop_loss))
    for name, got, ref in (("unet", scan_ckpt[0], loop_ckpt[0]), ("ema", scan_ckpt[1], loop_ckpt[1]),
                           ("adamw", scan_ckpt[2][0], loop_ckpt[2][0])):
        assert got.keys() == ref.keys() and got, name
        for k, v in ref.items():
            assert torch.equal(got[k], v), f"{name} {k}"
    assert scan_ckpt[2][1]["count"] == loop_ckpt[2][1]["count"] == 4
