"""The data-parallel path on two gloo processes on the CPU.

Two ranks (subprocesses with torchrun's environment, joining through the
port's parallel/mesh.init_distributed) run, at toy width (block_out_channels
16,32, one layer per block, 16x16):

  * the train step on a global batch of 8, 3 steps with injected draws (the
    global batch's, sliced to each rank's rows by the step), in both cases
    of tests/test_torch_port_train.py (mean_shift + indexing + AdamW; base +
    thresholding + Adam with gradient accumulation 2, DDP's no_sync path).
    Losses and parameters must equal the single-process port's on the same
    global batch and the JAX train step's on a make_mesh(data=2) mesh of the
    virtual CPU devices (tests/conftest.py), within the tolerances of
    test_train_step_matches_jax; both ranks' parameters bitwise equal;
  * the sampler with injected per-rank draws: the gathered samples equal the
    single-process ones;
  * the trainer with a run directory: only rank 0 writes (rank 1's writes
    under the work directory are trapped), both ranks agree on the run
    directory, the data order is shared and the step generators differ;
  * the host collectives (fetch of unequal shards, the mean).

Then the CLI under torch.distributed.run (2 processes, --device cpu) trains
(with --profile_dir: one trace a rank) and serves; its one run tree and one checkpoint load in the single-process
port and through the JAX package's io/import_torch. And --mesh_data 2 with
no process group is refused before any file is written, and so is
--multihost True without torchrun.
"""

import glob
import json
import os
import signal
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config as JConfig
from masked_diffusion_tpu.io import import_torch
from masked_diffusion_tpu.models.unet import UNet2D as JaxUNet2D
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.parallel import mesh as jmesh
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu.train import step as jstep
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.io import weights
from tests.test_torch_port_train import CASES, _jax_fakes
from masked_diffusion_tpu_torch.models.factory import build_unet
from tests.test_torch_port_unet import SIZE, two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, RANKS = 8, 3, 2
# 3 steps; with accumulation 2 the first update's LR is 0 (one warmup
# update), so that case takes 5 micro steps: two updates
STEPS = {case: 5 if CASES[case].get("gradient_accumulation_steps", 1) > 1 else 3
         for case in CASES}
MAIN_CASE = "mean_shift-indexing-adamw-cosine-ema-lossweight"
HW = SIZE * SIZE
RTOL, ATOL = 2e-3, 1e-5  # test_train_step_matches_jax's
SAMPLE_T = 8

# Runs of the port on a plan (None: one process). The worker processes run
# this source; the test process execs it for the single-process runs.
_PORT_RUNS = r"""
import json, os
import numpy as np
import torch
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.parallel.mesh import local_rows
from masked_diffusion_tpu_torch.sample.loop import StepDraws, make_sample_fn
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import TrainDraws, create_train_state, make_train_step
from masked_diffusion_tpu_torch.utils import host


def toy_model(spec, init_sd):
    model = UNet2D(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in spec["unet"].items()}))
    model.load_state_dict(init_sd, strict=True)
    return model


def train_case(spec, fx, init_sd, case, plan):
    cfg = Config(**spec["cases"][case])
    accum, total = cfg.gradient_accumulation_steps, spec["total"]
    used = np.asarray(spec["used"][case])
    model = toy_model(spec, init_sd).train()
    lr = build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum, total,
                           cfg.lr_cycle)
    opt = build_optimizer(cfg.optim, model.parameters(), lr, 1.0, accum)
    state = create_train_state(model, opt, use_ema=cfg.use_ema, plan=plan)
    step = make_train_step(model, build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps,
                                                 cfg.data_size, cfg.select_degrade_pixel),
                           cfg, opt, used, lr, device="cpu", plan=plan)
    n = spec["batch"]
    rows = local_rows(n, plan) if plan is not None else slice(None)
    ch = 3 if cfg.degrade_channel == "3-channel" else 1
    steps = []
    for i in range(spec["steps"][case]):
        draws = TrainDraws(
            timeindex=torch.from_numpy(fx["timeindex"][i].astype(np.int64)),
            bits=torch.from_numpy(fx["bits"][i].astype(np.int64)),
            mask_uniform=torch.from_numpy(fx["mask_u"][i, ..., :ch].transpose(0, 3, 1, 2).copy()),
            uniform=torch.from_numpy(fx["uniform"][i]),
            normal=torch.from_numpy(fx["normal"][i].transpose(0, 3, 1, 2).copy()),
        )
        steps.append(step(state, torch.from_numpy(fx["images"][i][rows]), draws=draws))
    # each rank's metrics are its rows'; the trainer logs their mean over the
    # ranks, taken as here in one stacked fetch
    keys = list(steps[0])
    mat = host.mean_over_ranks(torch.stack([torch.stack([m[k] for k in keys]) for m in steps]))
    metrics = [{k: float(v) for k, v in zip(keys, row)} for row in mat.tolist()]
    return {"metrics": metrics, "ddp": state.ddp is not None,
            "params": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "ema": {k: v.detach().clone() for k, v in state.ema_model.state_dict().items()}}


def sample_run(spec, fx, init_sd, plan):
    cfg = Config(**spec["sample_cfg"])
    sched = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
                           cfg.select_degrade_pixel)
    used = sched.timesteps_for_epoch(1, 10, 1)
    n = spec["batch"]
    rows = local_rows(n, plan) if plan is not None else slice(None)
    fn = make_sample_fn(toy_model(spec, init_sd), sched, cfg, used, device="cpu", plan=plan)
    bits = torch.from_numpy(fx["sample_bits"].astype(np.int64))
    u = torch.from_numpy(fx["sample_uniform"])
    out = fn(torch.from_numpy(fx["latent"][rows]),
             draws=lambda i: StepDraws(bits=bits[i][:, rows], uniform=u[i][rows]))
    return host.fetch(out), len(used)
"""

_WORKER = _PORT_RUNS + r"""
import builtins, sys
torch.set_num_threads(1)
from masked_diffusion_tpu_torch.data.datasets import get_dataset
from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
from masked_diffusion_tpu_torch.train.trainer import Trainer
from masked_diffusion_tpu_torch.utils.dirs import Dir

work = sys.argv[1]
device = init_distributed("cpu")
plan = make_mesh(2, 1, device)
rank = plan.rank
with open(os.path.join(work, "spec.json")) as f:
    spec = json.load(f)
fx = dict(np.load(os.path.join(work, "fixtures.npz")))
init_sd = torch.load(os.path.join(work, "init.pt"))
out = {"train": {case: train_case(spec, fx, init_sd, case, plan) for case in spec["cases"]}}
out["sample"], out["sample_steps"] = sample_run(spec, fx, init_sd, plan)

# host collectives: unequal shards, the mean
out["fetch"] = host.fetch(torch.arange(3 - rank, dtype=torch.float32) + 10 * rank)
out["mean"] = host.mean_over_ranks(torch.tensor([float(rank), 2.0 * rank]))

# the trainer with a run directory; rank 1 must not write under run/
run = os.path.join(work, "run")
trapped = []
real_open, real_makedirs = builtins.open, os.makedirs


def guarded_open(path, mode="r", *a, **k):
    if any(c in mode for c in "wax+") and str(path).startswith(run):
        trapped.append(str(path))
    return real_open(path, mode, *a, **k)


def guarded_makedirs(path, *a, **k):
    if str(path).startswith(run):
        trapped.append(str(path))
    return real_makedirs(path, *a, **k)


if rank != 0:
    builtins.open, os.makedirs = guarded_open, guarded_makedirs
cfg = Config(**spec["trainer_cfg"])
cfg.date, cfg.time = host.synced_timestamp()
dirs = Dir(task="train", content="ddp", dir_work=run, data_name="synthetic",
           date=cfg.date, time=cfg.time, method=cfg.method, make_dirs=host.is_main_process())
data = get_dataset("", "synthetic", cfg.data_size, data_subset=True,
                   num_data=cfg.data_subset_num, seed=cfg.seed)
trainer = Trainer(cfg, data, device="cpu", plan=plan)
seen = []
make_step = trainer._get_step_fn


def recording(used):
    fn = make_step(used)

    def step(state, batch, gen=None, draws=None):
        seen.append((batch.clone(), gen.initial_seed()))
        return fn(state, batch, gen, draws)
    return step


trainer._get_step_fn = recording
result = trainer.train(dirs=dirs)
builtins.open, os.makedirs = real_open, real_makedirs
out["trainer"] = {"checkpoint_dir": dirs.list_dir["checkpoint"], "trapped": trapped,
                  "checkpoints": result["checkpoints"], "loss": result["loss_mean_epoch"],
                  "batches": [b for b, _ in seen], "seeds": [s for _, s in seen]}
torch.save(out, os.path.join(work, f"rank{rank}.pt"))
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **extra)
    return env


def _fixtures(seed=0):
    rng = np.random.default_rng(seed)
    n = max(STEPS.values())
    bits = rng.integers(0, 2**32, size=(n, B, HW), dtype=np.uint64).astype(np.uint32)
    bits[:, 1] &= np.uint32(0xF0000000)  # tied top bits in one image
    lane_bits = max(1, (HW - 1).bit_length())
    keys = (bits & np.uint32((0xFFFFFFFF << lane_bits) & 0xFFFFFFFF)) | np.arange(
        HW, dtype=np.uint32)
    return dict(
        images=rng.uniform(-1, 1, size=(n, B, SIZE, SIZE, C)).astype(np.float32),
        timeindex=rng.integers(0, 4, size=(n, B)).astype(np.int32),
        bits=bits, keys=keys,
        mask_u=rng.uniform(0, 1, size=(n, B, SIZE, SIZE, C)).astype(np.float32),
        uniform=rng.uniform(-1, 1, size=(n, B)).astype(np.float32),
        normal=rng.normal(size=(n, B, SIZE, SIZE, C)).astype(np.float32),
        latent=rng.uniform(-1, 1, size=(B, SIZE, SIZE, C)).astype(np.float32),
        sample_bits=rng.integers(0, 2**32, size=(SAMPLE_T, 2, B, HW), dtype=np.uint64),
        sample_uniform=rng.uniform(-1, 1, size=(SAMPLE_T, B)).astype(np.float32),
    )


def _case_cfg(case):
    return dict(data_size=SIZE, ddpm_num_steps=20, mean_option="degraded_area", lr=1e-3,
                mixed_precision="no", out_channel=C, **CASES[case])


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Run the 2-rank worker once, and the JAX mesh step meanwhile; returns
    the spec, fixtures, initial state dict, JAX model and variables, the
    ranks' results and logs, the JAX run, and the single-process runs'
    namespace."""
    work = str(tmp_path_factory.mktemp("ddp"))
    # the port's toy UNet with a random conv_out (a fresh one outputs 0),
    # crossed into the JAX UNet through the JAX package's importer
    torch.manual_seed(5)
    model = build_unet(C, SIZE, SIZE, block_out_channels=(16, 32), layers_per_block=1)
    torch.nn.init.normal_(model.conv_out.weight, std=0.05)
    torch.nn.init.normal_(model.conv_out.bias, std=0.05)
    init_sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    torch.save(init_sd, os.path.join(work, "init.pt"))
    weights.save_checkpoint(os.path.join(work, "init"), init_sd,
                            weights.diffusers_config_from_unet(model.config))
    sd, config = import_torch.load_diffusers_folder(os.path.join(work, "init", "unet"))
    jcfg = import_torch.unet_config_from_diffusers(config)
    jmodel = JaxUNet2D(config=jcfg)
    variables = import_torch.map_state_dict(sd, jcfg)
    assert all(torch.equal(v, init_sd[k])
               for k, v in weights.state_dict_from_flax(variables, jcfg).items())
    fx = _fixtures()
    np.savez(os.path.join(work, "fixtures.npz"), **fx)
    used = {}
    for case in CASES:
        cfg = _case_cfg(case)
        sched = jax_build_schedule(cfg["ddpm_schedule"], cfg["ddpm_num_steps"], SIZE,
                                   cfg["select_degrade_pixel"])
        used[case] = [int(t) for t in sched.timesteps_for_epoch(0, 10, 1)]
        assert len(used[case]) >= 4  # the fixtures' timeindex range
    spec = {
        "unet": dict(sample_size=SIZE, in_channels=C, out_channels=C,
                     block_out_channels=list(jcfg.block_out_channels),
                     layers_per_block=jcfg.layers_per_block, attn_down=list(jcfg.attn_down),
                     attn_up=list(jcfg.attn_up), attention_head_dim=jcfg.attention_head_dim,
                     norm_groups=jcfg.norm_groups),
        "cases": {case: _case_cfg(case) for case in CASES}, "used": used, "total": 20,
        "batch": B, "steps": STEPS,
        "sample_cfg": dict(data_size=SIZE, select_degrade_pixel="indexing",
                           ddpm_schedule="log", ddpm_num_steps=SAMPLE_T,
                           mean_option="degraded_area", shift_type="1-d_constant"),
        "trainer_cfg": dict(method="mean_shift", data_size=SIZE, batch_size=B, num_epochs=1,
                            data_subset_num=16, save_images_epochs=1, sample_num=3,
                            sampling="momentum", ddpm_schedule="log", ddpm_num_steps=8,
                            mean_option="degraded_area", shift_type="1-d_constant",
                            block_out_channels=(16, 32), layers_per_block=1, use_wandb=False,
                            sample_latent_shape="uniform", seed=4),
    }
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, work], cwd=ROOT,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    logs = []
    try:
        # the JAX reference runs while the ranks do
        jax_run = _jax_mesh_run(jmodel, variables, used[MAIN_CASE], fx)
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(RANKS)]
    ns = {}
    exec(compile(_PORT_RUNS, "port_runs", "exec"), ns)
    return dict(spec=spec, fx=fx, init=init_sd, jax=(jmodel, jcfg, variables), ranks=ranks,
                logs=logs, ns=ns, jax_run=jax_run)


def _assert_params_close(name, got, ref, init, lr):
    """test_train_step_matches_jax's parameter check."""
    diff2 = upd2 = 0.0
    loose = total = 0
    for k, r in ref.items():
        d = (got[k] - r).abs()
        assert d.max().item() <= lr, f"{name} {k}: max |diff| {d.max().item()}"
        loose += int((d > ATOL + RTOL * r.abs()).sum())
        total += r.numel()
        diff2 += float((d ** 2).sum())
        upd2 += float(((r - init[k]) ** 2).sum())
    assert upd2 > 0  # the optimizer moved the parameters
    assert (diff2 / upd2) ** 0.5 <= RTOL, f"{name}: update norm differs by {(diff2 / upd2) ** 0.5}"
    assert loose <= 1e-3 * total, f"{name}: {loose} of {total} entries off"


def _assert_metrics_close(got, ref):
    assert sorted(got[0]) == sorted(ref[0])
    for key in ref[0]:
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in ref],
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_the_ranks_joined_one_gloo_group(ddp):
    line = [ln for ln in ddp["logs"][0].splitlines() if ln.startswith("dist: ")]
    assert len(line) == 1 and not any(ln.startswith("dist: ") for ln in ddp["logs"][1].splitlines())
    assert json.loads(line[0][6:]) == {"backend": "gloo", "world_size": 2,
                                       "devices": ["cpu", "cpu"], "cards": "CPU"}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ranks_hold_bitwise_equal_parameters(ddp, case):
    r0, r1 = (r["train"][case] for r in ddp["ranks"])
    assert r0["ddp"] and r1["ddp"]
    assert r0["metrics"] == r1["metrics"]  # the all-reduced mean
    for which in ("params", "ema"):
        for k, v in r0[which].items():
            assert torch.equal(v, r1[which][k]), f"{which} {k}"
    assert not any(k.startswith("module.") for k in r0["params"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_train_as_one_process_on_the_global_batch(ddp, case):
    one = ddp["ns"]["train_case"](ddp["spec"], ddp["fx"], ddp["init"], case, None)
    two = ddp["ranks"][0]["train"][case]
    assert not one["ddp"]
    _assert_metrics_close(two["metrics"], one["metrics"])
    for which in ("params", "ema"):
        _assert_params_close(which, two[which], one[which], ddp["init"], 1e-3)


def _jax_mesh_run(jmodel, variables, used, fx):
    """The JAX train step of MAIN_CASE on a make_mesh(data=2) mesh, its draws
    replaced by the fixtures (test_torch_port_train's fakes). Returns
    (metrics per step, final TrainState)."""
    cfg = JConfig(**_case_cfg(MAIN_CASE))
    accum = cfg.gradient_accumulation_steps
    jsched = jax_build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                cfg.select_degrade_pixel)
    jlr = joptim.build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum, 20,
                                   cfg.lr_cycle)
    tx = joptim.build_optimizer(cfg.optim, jlr, 1.0, accum)
    plan = jmesh.make_mesh(data=2, model=1)
    params = jax.tree.map(jnp.asarray, variables)
    state = jax.device_put(jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree.map(jnp.copy, params) if cfg.use_ema else None,
        opt_state=tx.init(params)), plan.replicated)
    split, randint, degrade, shift = _jax_fakes(fx)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jstep.degrade_ops, "degrade_training", degrade)
        m.setattr(jstep.shift_ops, "schedule_shift", shift)
        jfn = jax.jit(jstep._make_step_impl(jmodel, jsched, cfg, tx, np.asarray(used), jlr,
                                            mesh=plan.mesh))
        metrics = []
        for i in range(STEPS[MAIN_CASE]):
            batch = jax.device_put(jnp.asarray(fx["images"][i]), plan.batch_sharding)
            state, mt = jfn(state, batch, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in mt.items()})
    return metrics, state


def test_two_ranks_train_as_the_jax_step_on_a_data_2_mesh(ddp):
    j_metrics, state = ddp["jax_run"]
    jcfg = ddp["jax"][1]
    two = ddp["ranks"][0]["train"][MAIN_CASE]
    _assert_metrics_close(two["metrics"], j_metrics)
    for which, tree in (("params", state.params), ("ema", state.ema_params)):
        ref = weights.state_dict_from_flax(jax.tree.map(np.asarray, tree), jcfg)
        _assert_params_close(which, two[which], ref, ddp["init"], 1e-3)


def test_gathered_samples_equal_one_process(ddp):
    """The ranks gather bitwise the same samples; against one process on the
    global batch they agree to 1e-4: the CPU's convolutions block a batch of
    4 otherwise than one of 8, so their sums differ in the last bits
    (measured 1.2e-5 after 8 reverse steps)."""
    one, steps = ddp["ns"]["sample_run"](ddp["spec"], ddp["fx"], ddp["init"], None)
    r0, r1 = ddp["ranks"]
    np.testing.assert_array_equal(r0["sample"], r1["sample"])
    assert r0["sample_steps"] == steps > 1
    assert r0["sample"].shape == (B, SIZE, SIZE, C)
    np.testing.assert_allclose(r0["sample"], one, rtol=0, atol=1e-4)


def test_host_collectives(ddp):
    for rank in ddp["ranks"]:
        np.testing.assert_array_equal(rank["fetch"], [0.0, 1.0, 2.0, 10.0, 11.0])
        assert torch.equal(rank["mean"], torch.tensor([0.5, 1.0]))


def test_only_rank_0_writes_and_the_ranks_agree_on_the_run(ddp):
    t0, t1 = (r["trainer"] for r in ddp["ranks"])
    assert t1["trapped"] == []
    assert t0["checkpoint_dir"] == t1["checkpoint_dir"]
    assert t0["checkpoints"] == t1["checkpoints"] and len(t0["checkpoints"]) == 1
    assert t0["loss"] == t1["loss"]
    (ckpt,) = t0["checkpoints"]
    assert os.path.exists(os.path.join(ckpt, "unet", weights.WEIGHTS_NAME))
    runs = glob.glob(os.path.join(os.path.dirname(ckpt), "..", "..", "*"))
    assert len(runs) == 1  # one <date>_<time> tree
    grids = glob.glob(os.path.join(ckpt, "..", "..", "train", "image", "ema_sample_img", "*"))
    assert len(grids) == 2


def test_ranks_share_the_data_order_and_draw_their_own_streams(ddp):
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.ops.shard import fold_seed, step_seed

    cfg = ddp["spec"]["trainer_cfg"]
    data = get_dataset("", "synthetic", SIZE, data_subset=True, num_data=16, seed=cfg["seed"])
    rows = list(data.epoch_index_batches(np.random.default_rng([cfg["seed"], 0]), B))
    t0, t1 = (r["trainer"] for r in ddp["ranks"])
    assert len(t0["batches"]) == len(rows) == 2
    for i, idx in enumerate(rows):
        both = torch.cat([t0["batches"][i], t1["batches"][i]]).numpy()
        np.testing.assert_array_equal(both, data.data[idx])
    seeds = [step_seed(cfg["seed"], 0, i) for i in range(2)]  # (seed, epoch, step)
    assert t0["seeds"] == seeds and t1["seeds"] == [fold_seed(s, 1) for s in seeds]
    assert t0["seeds"] != t1["seeds"]


# ------------------------------------------------------------------ the CLI


def _cli_args(work, method):
    return ["--method", method, "--mesh_data", "2", "--device", "cpu",
            "--data_name", "synthetic", "--data_size", str(SIZE), "--data_subset", "True",
            "--data_subset_num", "16", "--batch_size", "8", "--num_epochs", "1",
            "--save_images_epochs", "1", "--ddpm_schedule", "log", "--ddpm_num_steps", "8",
            "--mean_option", "degraded_area", "--shift_type", "1-d_constant",
            "--sampling", "momentum", "--sample_num", "3", "--block_out_channels", "16,32",
            "--layers_per_block", "1", "--use_wandb", "False", "--dir_work", work]


def _torchrun(args):
    """The CLI on 2 ranks; the launcher and its ranks run in a session of
    their own, killed as a whole if they outlive the limit."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "masked_diffusion_tpu_torch.cli.main_train_masked", *args],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out + err
    return out


def test_cli_trains_and_serves_on_two_ranks(tmp_path):
    prof = tmp_path / "prof"
    out = _torchrun(_cli_args(str(tmp_path / "train"), "mean_shift")
                    + ["--profile_dir", str(prof)])
    (line,) = [ln for ln in out.splitlines() if ln.startswith("train_stats ")]
    stats = json.loads(line.split(" ", 1)[1])
    assert stats["ranks"] == 2 and stats["global_step"] == 2 and stats["epochs"] == 1
    # --profile_dir: each rank traces its own steps of the one epoch, with
    # DDP's gloo all-reduce in it
    from masked_diffusion_tpu_torch.utils.profiling import read_trace

    assert sorted(os.listdir(prof)) == ["trace_rank0.json", "trace_rank1.json"]
    for rank in (0, 1):
        tr = read_trace(str(prof / f"trace_rank{rank}.json"))
        steps = {e["name"] for e in tr["events"] if str(e.get("name", "")).startswith(
            "train_step ")}
        assert steps == {"train_step epoch 0 step 0", "train_step epoch 0 step 1"}
        reduce = tr["summary"]["collectives_host_ms"]["gloo:all_reduce"]
        assert reduce["calls"] >= 2 and 0 < reduce["in_flight_ms"] <= reduce["ms"] + 1e-9
    assert json.loads([ln for ln in out.splitlines() if ln.startswith("dist: ")][0][6:])[
        "backend"] == "gloo"
    assert len(glob.glob(str(tmp_path / "train" / "result" / "*" / "*" / "*" / "*"))) == 1
    ckpts = glob.glob(str(tmp_path / "train" / "**" / "checkpoint-epoch-*"), recursive=True)
    assert ckpts == stats["checkpoints"] and len(ckpts) == 1

    # the single-process port loads it, and so does the JAX package's importer
    from masked_diffusion_tpu_torch.models.factory import build_unet

    unet_sd, ema_sd, _ = weights.load_checkpoint(ckpts[0])
    model = build_unet(3, SIZE, SIZE, block_out_channels=(16, 32), layers_per_block=1)
    model.load_state_dict(ema_sd, strict=True)
    model.load_state_dict(unet_sd, strict=True)
    sd, config = import_torch.load_diffusers_folder(os.path.join(ckpts[0], "unet"))
    jparams = import_torch.map_state_dict(sd, import_torch.unet_config_from_diffusers(config))
    assert "conv_in" in jparams["params"] and config["block_out_channels"] == [16, 32]

    # served with --encoder_reuse 2: each rank caches its own rows' encoder
    out = _torchrun(_cli_args(str(tmp_path / "serve"), "sample")
                    + ["--test_model_path", ckpts[0], "--batch_size", "4", "--encoder_reuse", "2"])
    (line,) = [ln for ln in out.splitlines() if ln.startswith("sample_stats ")]
    served = json.loads(line.split(" ", 1)[1])
    assert served["ranks"] == 2 and served["images"] == 3 and served["finite"] and served["ema"]
    pngs = glob.glob(os.path.join(served["out_dir"], "sample_*.png"))
    assert len(pngs) == 3 + 1  # the 3 images and one grid (batch 4 holds them)


def _trajectory_means(run_root):
    (path,) = glob.glob(os.path.join(run_root, "**", "log", "metrics.jsonl"), recursive=True)
    with open(path) as f:
        (line,) = [json.loads(ln) for ln in f if "ema_sample_t_mean" in ln]
    return {k: v for k, v in line.items() if k.startswith("ema_sample")}


def test_cli_sampling_base_trajectory_means_on_two_ranks_equal_one_process(tmp_path):
    """--sampling base on 2 ranks: the cadence's trajectory means are the
    full global batch's, as in one process. The runs draw differently (each
    rank folds its seeds), so the test picks a setting in which the means do
    not depend on the draws: LR 0 keeps the zero-initialised output layer at
    zero, no shift, and the image-wise degraded_area fill keeps every
    image's sum, so every step's mean is the latents' (drawn alike on both
    runs from the shared generator). A rank-local or summed mean differs;
    the ranks' 2 rows each are fewer than the 4 items captured, so the
    trajectory images are gathered across them."""
    def args(work, ranks):
        a = _cli_args(work, "mean_shift")
        a[a.index("--mesh_data") + 1] = str(ranks)
        for flag, value in (("--sampling", "base"), ("--shift_type", "non_shift"),
                            ("--sample_num", "4")):
            a[a.index(flag) + 1] = value
        return a + ["--lr", "0"]

    _torchrun(args(str(tmp_path / "two"), 2))
    assert port_cli.main(args(str(tmp_path / "one"), 1)) == 0
    two, one = _trajectory_means(str(tmp_path / "two")), _trajectory_means(str(tmp_path / "one"))
    assert sorted(two) == sorted(one) and len(one) == 5
    for key in one:
        assert np.isfinite(one[key]) and abs(two[key] - one[key]) <= 1e-5, (key, two, one)
    traj = glob.glob(str(tmp_path / "two" / "**" / "sample_all_t" / "*.png"), recursive=True)
    assert len(traj) == 44


@pytest.mark.parametrize("extra,error,message", [
    ([], ValueError, "--mesh_data 2 but WORLD_SIZE is 1"),
    (["--mesh_data", "-1", "--multihost", "True"], RuntimeError,
     "--multihost True but WORLD_SIZE is 1: .* torch.distributed.run --nnodes"),
])
def test_mesh_data_without_a_process_group_is_refused_before_any_file(tmp_path, extra, error,
                                                                     message):
    work = tmp_path / "refused"
    with pytest.raises(error, match=message):
        port_cli.main(_cli_args(str(work), "mean_shift") + extra)
    assert not work.exists()
