"""Tensor and spatial parallelism on four gloo processes on the CPU.

Single-process checks: the port's TP rule (parallel/tp.py:leaf_sharded on
the port's layouts) shards exactly the tensors that the JAX package's
tp_shardings shards on its own, matched by io/weights.flax_layout's names,
with the same sharded_fraction, for the flagship (on the meta device) and
the toy model at min_features 8; validate_spatial raises JAX's two messages;
the SP level rule of the flagship at M = 2 and 4; one-process state cut into
shards and joined again is bitwise itself; --mesh_model 2 in one process is
refused naming WORLD_SIZE.

Then four ranks (subprocesses with torchrun's environment, joining through
parallel/mesh.init_distributed) as data 2 x model 2, a toy UNet (widths
8/16, one layer per block, 16x16, min_features 8: every layer but conv_out
channel-shards):

  * two TP and two SP train steps on injected draws (mean_shift, indexing,
    AdamW at a constant LR 1e-3, EMA), the global batch of 8;
  * the TP and SP samplers for 5 reverse steps at a global batch of 2 (one
    row a data rank), on the fused branch, and on the plain branch with
    trajectory capture and --encoder_reuse 2;
  * a Trainer epoch with a run directory under TP and under SP (the cadence
    and a checkpoint), and the restore of a one-process checkpoint under
    each;
  * the CLI: trained under --mesh_model 2, served under --mesh_spatial true
    and run through --method test under --mesh_model 2, its checkpoint then
    restoring in one process.

Then the same four ranks regrouped as data 1 x model 4, with a 4-level
model (8/16/16/16) whose 2x2 level runs replicated under SP: TP and SP train
steps.

Each result is held against the one-process port on the same global batch
and draws (loss rel 1e-4; params, EMA and samples atol 2e-5, the JAX
package's own TP/SP bounds, tests/test_distributed.py), the first step's
gradients within 1e-5 relative L2, and, for the 2 x 2 runs, against the
JAX package's TP and SP steps and samplers on a make_mesh(data=2, model=2)
mesh of the virtual CPU devices (shard_tree or activation_sharding; the
draws faked as tests/test_torch_port_train.py and
tests/test_torch_port_sampler.py fake them), at tests/test_torch_port_ddp.py's
train tolerances and the sampler tests' 2e-3.

Why widths 8/16: at 16/32 the SP parameters after two AdamW steps differ
from one process by up to 3.2e-5 in a few coordinates of the middle block's
convolutions while the gradients agree to 3.7e-6 relative per tensor:
Adam's first steps move a coordinate by about lr * g/|g|, so a gradient
that cancels to near zero turns summation-order noise into a larger move
(tests/test_torch_port_train.py's docstring measures the same). The
gradient check here holds the backward itself.
"""

import glob
import json
import os
import pickle
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config as JConfig
from masked_diffusion_tpu.io import import_torch
from masked_diffusion_tpu.models.factory import build_unet as jax_build_unet
from masked_diffusion_tpu.models.unet import UNet2D as JaxUNet2D
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.parallel import mesh as jmesh
from masked_diffusion_tpu.parallel import sp as jsp
from masked_diffusion_tpu.parallel import tp as jtp
from masked_diffusion_tpu.sample import make_sample_fn as jax_make_sample_fn
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu.train import step as jstep
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models.factory import build_unet
from masked_diffusion_tpu_torch.parallel import mesh as tmesh
from masked_diffusion_tpu_torch.parallel import sp as tsp
from masked_diffusion_tpu_torch.parallel import tp as ttp
from tests import test_torch_port_sampler as samp
from tests.test_torch_port_ddp import _assert_metrics_close, _assert_params_close, _fixtures
from tests.test_torch_port_train import _jax_fakes
from tests.test_torch_port_unet import SIZE, two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, RANKS, STEPS = 8, 3, 4, 2
N_SAMPLE = samp.N  # the sampler fixtures' global batch: one row a data rank
T = samp.T
LOSS_RTOL, ATOL, GRAD_RTOL = 1e-4, 2e-5, 1e-5
# the JAX reference processes compile without LLVM's optimisations: their
# programs run once, at toy size, so compile time is all that counts
XLA_FAST = "--xla_backend_optimization_level=0"
WIDE, DEEP = (8, 16), (8, 16, 16, 16)
TRAIN = dict(method="mean_shift", data_size=SIZE, ddpm_schedule="log", ddpm_num_steps=20,
             select_degrade_pixel="indexing", degrade_channel="1-channel",
             mean_option="degraded_area", mean_area="image-wise", shift_type="1-d_constant",
             optim="adamw", lr=1e-3, lr_scheduler="constant", lr_warmup_steps=0, use_ema=True,
             mixed_precision="no", out_channel=C, tp_min_features=8)
SAMPLE = {
    "fused": dict(method="sample", data_size=SIZE, ddpm_schedule="log", ddpm_num_steps=T,
                  select_degrade_pixel="indexing", degrade_channel="1-channel",
                  mean_option="degraded_area", mean_area="image-wise",
                  shift_type="1-d_constant", momentum_adaptive="base_momentum",
                  sampling_mask_dependency="independent", mixed_precision="no",
                  out_channel=C, tp_min_features=8),
    # capture runs the plain branch; the encoder cache replays every other step
    "plain": dict(method="sample", data_size=SIZE, ddpm_schedule="linear", ddpm_num_steps=T,
                  select_degrade_pixel="thresholding", degrade_channel="1-channel",
                  mean_option="degraded_area", mean_area="image-wise",
                  shift_type="1-d_constant", momentum_adaptive="momentum",
                  adaptive_momentum_rate=0.3, sampling_mask_dependency="independent",
                  mixed_precision="no", out_channel=C, tp_min_features=8, encoder_reuse=2),
}
TRAINER = dict(method="mean_shift", data_size=SIZE, batch_size=B, num_epochs=1,
               data_subset_num=16, save_images_epochs=1, sample_num=3, sampling="momentum",
               ddpm_schedule="log", ddpm_num_steps=4, mean_option="degraded_area",
               shift_type="1-d_constant", block_out_channels=WIDE, layers_per_block=1,
               use_wandb=False, sample_latent_shape="uniform", seed=4, tp_min_features=8)

# Runs of the port on a plan (None: one process). The worker processes run
# this source; the test process execs it for the one-process runs.
_PORT_RUNS = r"""
import numpy as np
import torch
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.parallel import tp
from masked_diffusion_tpu_torch.parallel.mesh import local_rows, place_model
from masked_diffusion_tpu_torch.sample.loop import StepDraws, make_sample_fn
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import TrainDraws, create_train_state, make_train_step
from masked_diffusion_tpu_torch.utils import host


def toy_model(unet, init_sd):
    model = UNet2D(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in unet.items()}))
    model.load_state_dict(init_sd, strict=True)
    return model


def _spatial(plan):
    return plan is not None and plan.spatial


def _full(state, model, plan):
    return tp.gather_state(state, model, plan) if plan is not None else state


def train_run(spec, fx, which, plan):
    cfg = Config(**spec["train_cfg"], mesh_spatial=_spatial(plan))
    model = toy_model(spec["unet"][which], spec["init"][which])
    if plan is not None:
        place_model(model, plan, cfg.tp_min_features)
    names, params = zip(*model.named_parameters())
    lr = build_lr_schedule(cfg.lr_scheduler, cfg.lr, 0, 20, cfg.lr_cycle)
    opt = build_optimizer(cfg.optim, params, lr, 1.0, 1, names=names)
    if getattr(model, "tp_sharded", ()):
        opt.set_tensor_parallel(model.tp_sharded, plan.model_group)
    state = create_train_state(model, opt, use_ema=True, plan=plan)
    schedule = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
                              cfg.select_degrade_pixel)
    step = make_train_step(model, schedule, cfg, opt, np.asarray(spec["used"]), lr,
                           device="cpu", plan=plan)
    rows = local_rows(spec["batch"], plan) if plan is not None else slice(None)
    losses = []
    for i in range(spec["steps"]):
        draws = TrainDraws(timeindex=torch.from_numpy(fx["timeindex"][i].astype(np.int64)),
                           bits=torch.from_numpy(fx["bits"][i].astype(np.int64)),
                           uniform=torch.from_numpy(fx["uniform"][i]))
        losses.append(step(state, torch.from_numpy(fx["images"][i][rows]), draws=draws)
                      ["train_loss"])
    # the last step's clipped gradient (.grad keeps it)
    grads = {n: p.grad.detach().clone() for n, p in zip(names, params)}
    losses = torch.stack(losses)
    if plan is not None:  # each data rank's loss is its rows'; the global batch's the mean
        losses = host.mean_over_ranks(losses, plan.data_group)
    return {"losses": losses.tolist(), "ddp": state.ddp is not None,
            "sharded": list(getattr(model, "tp_sharded", ())),
            "local_bytes": sum(p.numel() * p.element_size() for p in params),
            "params": _full({k: v.detach().clone() for k, v in model.state_dict().items()},
                            model, plan),
            "ema": _full({k: v.detach().clone()
                          for k, v in state.ema_model.state_dict().items()}, model, plan),
            "grads": _full(grads, model, plan)}


def sample_run(spec, fx, which, branch, plan):
    cfg = Config(**spec["sample_cfg"][branch], mesh_spatial=_spatial(plan))
    schedule = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, cfg.data_size,
                              cfg.select_degrade_pixel)
    used = schedule.timesteps_for_epoch(1, 10, 1)
    capture = branch == "plain"
    fn = make_sample_fn(toy_model(spec["unet"][which], spec["sample_init"][which]), schedule, cfg,
                        used, device="cpu", plan=plan, capture_trajectory=capture,
                        capture_items=2 if capture else 0)
    rows = local_rows(spec["n_sample"], plan) if plan is not None else slice(None)
    n = len(used)

    def draws(i):
        if branch == "fused":
            return StepDraws(bits=torch.from_numpy(fx["f_bits"].astype(np.int64))[:, rows],
                             uniform=torch.from_numpy(fx["f_uniform"])[rows])
        r = n - 1 - i  # draws(i) serves used[i], walked from the end
        return StepDraws(
            bits=torch.from_numpy(fx["p_bits"][r].astype(np.int64))[:, rows],
            mask_uniform=torch.from_numpy(fx["p_u"][r, ..., :1].transpose(0, 1, 4, 2, 3)
                                          .copy())[:, rows],
            uniform=torch.from_numpy(fx["p_uniform"][r])[rows])

    out = fn(torch.from_numpy(fx["s_latent"][rows]), draws=draws)
    traj = None
    if capture:
        out, traj = out
    group = plan.data_group if plan is not None else None
    result = {"sample": host.fetch(out, group) if plan is not None else out.numpy(),
              "steps": n}
    if traj is not None:
        result["means"] = {k: v.numpy() for k, v in traj.pop("means").items()}
        result["traj"] = {k: v.numpy() for k, v in traj.items()}
    return result
"""

_WORKER = _PORT_RUNS + r"""
def wait_for_one_process_checkpoint(work, seconds=120):
    import time
    path = os.path.join(work, "one_process_checkpoint.txt")
    for _ in range(int(seconds * 10)):
        if os.path.exists(path):
            with open(path) as f:
                return f.read()
        time.sleep(0.1)
    raise TimeoutError(path)


import glob, os, sys
torch.set_num_threads(1)
from masked_diffusion_tpu_torch.cli.main_train_masked import main as cli_main
from masked_diffusion_tpu_torch.data.datasets import get_dataset
from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
from masked_diffusion_tpu_torch.train.trainer import Trainer
from masked_diffusion_tpu_torch.utils.dirs import Dir

work = sys.argv[1]
device = init_distributed("cpu")
spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
fx = dict(np.load(os.path.join(work, "fixtures.npz")))
out = {}
for mode in ("tp", "sp"):
    plan = make_mesh(2, 2, device, spatial=mode == "sp")
    out[mode] = {"train": train_run(spec, fx, "wide", plan),
                 "sample": {b: sample_run(spec, fx, "wide", b, plan) for b in ("fused", "plain")},
                 "ranks": (plan.rank, plan.data_rank, plan.model_rank)}
    # a Trainer epoch with a run directory (the cadence samples, a checkpoint),
    # then the one-process checkpoint restored on this grid
    cfg = Config(**spec["trainer_cfg"], mesh_model=2, mesh_spatial=mode == "sp")
    cfg.date, cfg.time = host.synced_timestamp()
    dirs = Dir(task="train", content=mode, dir_work=os.path.join(work, "trainer"),
               data_name="synthetic", date=cfg.date, time=cfg.time, method=cfg.method,
               make_dirs=host.is_main_process())
    data = get_dataset("", "synthetic", cfg.data_size, data_subset=True,
                       num_data=cfg.data_subset_num, seed=cfg.seed)
    trainer = Trainer(cfg, data, device="cpu", plan=plan)
    result = trainer.train(dirs=dirs)
    final = {"p": tp.gather_state(trainer.model.state_dict(), trainer.model, plan),
             "e": tp.gather_state(trainer.state.ema_model.state_dict(), trainer.model, plan),
             "o": trainer._optimizer_state()[0]}
    fresh = Trainer(cfg, data, device="cpu", plan=plan)
    one_ckpt = wait_for_one_process_checkpoint(work)
    step = fresh.restore(one_ckpt)
    restored = {"p": tp.gather_state(fresh.model.state_dict(), fresh.model, plan),
                "e": tp.gather_state(fresh.state.ema_model.state_dict(), fresh.model, plan),
                "o": fresh._optimizer_state()[0], "step": step}
    out[mode]["trainer"] = {"checkpoints": result["checkpoints"], "loss": result["loss_mean_epoch"],
                            "final": final, "restored": restored}

# the CLI: trained with --mesh_model 2, served with --mesh_spatial true, tested with TP
common = ["--device", "cpu", "--mesh_data", "2", "--mesh_model", "2", "--tp_min_features", "8",
          "--data_name", "synthetic", "--data_size", "16", "--data_subset", "True",
          "--data_subset_num", "16", "--batch_size", "8", "--ddpm_schedule", "log",
          "--ddpm_num_steps", "4", "--mean_option", "degraded_area", "--shift_type",
          "1-d_constant", "--sampling", "momentum", "--sample_num", "3",
          "--block_out_channels", "8,16", "--layers_per_block", "1", "--use_wandb", "False"]
cli_work = os.path.join(work, "cli")
assert cli_main(["--method", "mean_shift", "--num_epochs", "1", "--save_images_epochs", "1",
                 "--dir_work", os.path.join(cli_work, "train"), *common]) == 0
(ckpt,) = glob.glob(os.path.join(cli_work, "train", "**", "checkpoint-epoch-0"), recursive=True)
assert cli_main(["--method", "sample", "--test_model_path", ckpt, "--mesh_spatial", "true",
                 "--dir_work", os.path.join(cli_work, "serve"), *common]) == 0
assert cli_main(["--method", "test", "--test_model_path", ckpt, "--dir_work",
                 os.path.join(cli_work, "test"), *common, "--data_subset_num", "1"]) == 0
out["cli_checkpoint"] = ckpt
out["one_process_checkpoint"] = one_ckpt

# the same ranks regrouped as data 1 x model 4, a 4-level model
for mode in ("tp", "sp"):
    plan = make_mesh(1, 4, device, spatial=mode == "sp")
    out["deep_" + mode] = train_run(spec, fx, "deep", plan)
torch.save(out, os.path.join(work, f"rank{int(os.environ['RANK'])}.pt"))
torch.distributed.destroy_process_group()
"""


# One process, alongside the ranks: a Trainer epoch with a run directory
# whose checkpoint the ranks restore on the grid.
_ONE_PROCESS = r"""
import os, sys
import torch
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.data.datasets import get_dataset
from masked_diffusion_tpu_torch.train.trainer import Trainer
from masked_diffusion_tpu_torch.utils.dirs import Dir

torch.set_num_threads(1)
work = sys.argv[1]
spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
cfg = Config(**spec["trainer_cfg"])
dirs = Dir(task="train", content="one", dir_work=os.path.join(work, "one"), data_name="synthetic",
           date="d", time="t", method=cfg.method)
data = get_dataset("", "synthetic", cfg.data_size, data_subset=True,
                   num_data=cfg.data_subset_num, seed=cfg.seed)
(ckpt,) = Trainer(cfg, data, device="cpu").train(dirs=dirs)["checkpoints"]
with open(os.path.join(work, "one_process_checkpoint.tmp"), "w") as f:
    f.write(ckpt)
os.rename(os.path.join(work, "one_process_checkpoint.tmp"),
          os.path.join(work, "one_process_checkpoint.txt"))
"""

_JAX_MAIN = """
import sys
from tests import conftest  # noqa: F401  (the 8-device CPU platform)
from tests import test_torch_port_parallel as t
t.jax_main(sys.argv[1], sys.argv[2])
"""


# ------------------------------------------------------------ one process


def _jax_unet(widths):
    return jax_build_unet(dim_channel=C, dim_height=SIZE, dim_width=SIZE, num_attention=1,
                          block_out_channels=widths, layers_per_block=1)


def _port_and_jax_names(port_model, jmodel, jax_plan, m, min_features):
    """(names the port shards, names JAX's tp_shardings shards, the two
    sharded fractions) of one topology."""
    port = {name for name, p in port_model.state_dict().items()
            if ttp.leaf_sharded(p.shape, m, min_features)}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, jmodel.config.sample_size,
                                       jmodel.config.sample_size, C)), jnp.zeros((1,)))
    specs = jtp.tp_shardings(jax_plan, shapes["params"], min_features)
    tree = {name: leaf for name, leaf, _ in weights.flax_layout(specs, jmodel.config)}
    jax_names = {name for name, s in tree.items() if s.spec != jax.sharding.PartitionSpec()}
    fractions = (ttp.sharded_fraction(port_model.state_dict().values(), m, min_features),
                 jtp.sharded_fraction(jax_plan, shapes["params"], min_features))
    return port, jax_names, fractions


@pytest.mark.parametrize("topology,m,min_features", [
    ("flagship", 2, 256), ("flagship", 4, 256), ("toy", 2, 8)])
def test_the_port_shards_what_jax_tp_shards(topology, m, min_features):
    if topology == "flagship":
        with torch.device("meta"):
            port_model = build_unet(C, 64, 64)
        jmodel = jax_build_unet(dim_channel=C, dim_height=64, dim_width=64)
    else:
        port_model = build_unet(C, SIZE, SIZE, block_out_channels=WIDE, layers_per_block=1)
        jmodel = _jax_unet(WIDE)
    jax_plan = jmesh.make_mesh(data=8 // m, model=m)
    port, jax_names, (fp, fj) = _port_and_jax_names(port_model, jmodel, jax_plan, m,
                                                   min_features)
    assert port == jax_names and len(port) > 0
    assert len(port) < len(port_model.state_dict())  # conv_out (3 wide) stays whole
    assert fp == pytest.approx(fj, rel=1e-12) and 0.0 < fp < 1.0


def test_validate_spatial_raises_jax_messages():
    cpu = torch.device("cpu")
    cases = [((8, 1), 16), ((2, 4), 10)]
    for (d, m), height in cases:
        with pytest.raises(ValueError) as jerr:
            jsp.validate_spatial(jmesh.make_mesh(data=d, model=m), height)
        with pytest.raises(ValueError) as terr:
            tsp.validate_spatial(tmesh.MeshPlan(cpu, data_size=d, model_size=m), height)
        assert str(terr.value) == str(jerr.value)
    assert "mesh_model" in str(terr.value) or "divisible" in str(terr.value)
    tsp.validate_spatial(tmesh.MeshPlan(cpu, data_size=2, model_size=4), 16)  # ok


def test_split_levels_of_the_flagship():
    assert tsp.level_heights(64, 6) == [64, 32, 16, 8, 4, 2]
    assert tsp.split_levels(64, 6, 2) == (True,) * 6
    # M = 4: the 2x2 level cannot be split; it and its skips run replicated
    assert tsp.split_levels(64, 6, 4) == (True,) * 5 + (False,)
    assert tsp.split_levels(SIZE, len(DEEP), 4) == (True, True, True, False)
    assert tsp.split_levels(256, 6, 8) == (True,) * 6
    # once a level cannot be split, no deeper one is
    assert tsp.split_levels(40, 4, 4) == (True, True, False, False)
    assert tsp.split_levels(48, 3, 3) == (True, True, True)


def test_shards_of_a_state_join_bitwise():
    model = build_unet(C, SIZE, SIZE, block_out_channels=WIDE, layers_per_block=1)
    sd = model.state_dict()
    sharded = [k for k, v in sd.items() if ttp.leaf_sharded(v.shape, 2, 8)]
    state = dict(sd)
    for k, v in list(sd.items())[:6]:  # optimizer tensors: moments and a step count
        state[f"{k}.exp_avg"] = torch.randn_like(v)
        state[f"{k}.step"] = torch.tensor(3.0)
    for m in (2, 4):
        sharded_m = [k for k in sharded if sd[k].shape[0] % m == 0]
        parts = [ttp.shard_state(state, sharded_m, m, j) for j in range(m)]
        assert parts[1][sharded_m[0]].shape[0] == sd[sharded_m[0]].shape[0] // m
        joined = ttp.join_state(parts, sharded_m)
        assert joined.keys() == state.keys()
        assert all(torch.equal(joined[k], v) for k, v in state.items())


def test_make_mesh_model_axis_without_a_process_group():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match=r"--mesh_model 2 needs a multiple of 2 ranks but "
                                         r"WORLD_SIZE is 1"):
        tmesh.make_mesh(-1, 2, cpu)
    with pytest.raises(ValueError, match=r"--mesh_data 2 x --mesh_model 2 needs 4 ranks"):
        tmesh.make_mesh(2, 2, cpu)
    plan = tmesh.make_mesh(-1, 1, cpu)
    assert (plan.model_size, plan.data_rank, plan.model_rank, plan.spatial) == (1, 0, 0, False)
    # rank r sits at data rank r // M and model rank r % M
    grid = [tmesh.MeshPlan(cpu, 2, r, model_size=2) for r in range(4)]
    assert [(p.data_rank, p.model_rank) for p in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]


# ------------------------------------------------------------ four ranks


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT, **extra)
    return env


def _port_init(widths, seed, random_out=True):
    """A port toy UNet, fresh, or with a random conv_out (a fresh one
    outputs 0)."""
    torch.manual_seed(seed)
    model = build_unet(C, SIZE, SIZE, block_out_channels=widths, layers_per_block=1)
    if random_out:
        torch.nn.init.normal_(model.conv_out.weight, std=0.05)
        torch.nn.init.normal_(model.conv_out.bias, std=0.05)
    return model


def _jax_of(model, folder):
    """The JAX model, config and variables of a port model, through the
    JAX package's importer."""
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    weights.save_checkpoint(folder, sd, weights.diffusers_config_from_unet(model.config))
    jsd, config = import_torch.load_diffusers_folder(os.path.join(folder, "unet"))
    jcfg = import_torch.unet_config_from_diffusers(config)
    return JaxUNet2D(config=jcfg), jcfg, import_torch.map_state_dict(jsd, jcfg)


def _unet_spec(model):
    c = model.config
    return dict(sample_size=c.sample_size, in_channels=C, out_channels=C,
                block_out_channels=list(c.block_out_channels),
                layers_per_block=c.layers_per_block, attn_down=list(c.attn_down),
                attn_up=list(c.attn_up), attention_head_dim=c.attention_head_dim,
                norm_groups=c.norm_groups)


def _sample_fixtures():
    return dict(f_bits=np.stack([samp.BITS_T, samp.BITS_N]), f_uniform=samp.UNIFORM,
                p_bits=samp.P_BITS, p_u=samp.P_U, p_uniform=samp.P_UNIFORM,
                s_latent=np.random.default_rng(3).uniform(
                    -1, 1, size=(N_SAMPLE, SIZE, SIZE, C)).astype(np.float32))


def _jax_runs(mode, jmodel, variables, sample_variables, used, fx):
    """The JAX package's TP or SP (`mode`) train step and samplers on a
    make_mesh(data=2, model=2) mesh, every draw faked from the fixtures.
    Each program is traced under its fakes, then all compile at once (XLA
    compiles outside the interpreter lock), then run."""
    plan = jmesh.make_mesh(data=2, model=2)
    act = jsp.activation_sharding(plan) if mode == "sp" else None
    cfg = JConfig(**TRAIN)
    jsched = jax_build_schedule("log", 20, SIZE, "indexing")
    jlr = joptim.build_lr_schedule("constant", cfg.lr, 0, 20, cfg.lr_cycle)
    tx = joptim.build_optimizer("adamw", jlr, 1.0, 1)
    params = jax.tree.map(jnp.asarray, variables)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             ema_params=jax.tree.map(jnp.copy, params),
                             opt_state=tx.init(params))
    # the state keeps its layout from step to step: one program for both
    shardings = jtp.tp_shardings(plan, state, 8) if mode == "tp" else plan.replicated
    st = jax.device_put(state, shardings)
    batches = [jax.device_put(jnp.asarray(fx["images"][i]), act or plan.batch_sharding)
               for i in range(STEPS)]
    programs = {}  # name -> (lowered, arguments of each call)
    split, randint, degrade, shift = _jax_fakes(fx)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jstep.degrade_ops, "degrade_training", degrade)
        m.setattr(jstep.shift_ops, "schedule_shift", shift)
        fn = jax.jit(jstep._make_step_impl(jmodel, jsched, cfg, tx, np.asarray(used), jlr,
                                           activation_sharding=act),
                     out_shardings=(shardings, plan.replicated))
        programs["train"] = (fn.lower(st, batches[0], jax.random.PRNGKey(0)),
                             [(b, jax.random.PRNGKey(i)) for i, b in enumerate(batches)])
    sample_params = jax.tree.map(jnp.asarray, sample_variables)
    p = (jtp.shard_tree(plan, sample_params, 8) if mode == "tp"
         else jax.device_put(sample_params, plan.replicated))
    lat = jax.device_put(jnp.asarray(_sample_fixtures()["s_latent"]), act or plan.batch_sharding)
    for branch in ("fused", "plain"):
        cfg = JConfig(**SAMPLE[branch])
        jsched = jax_build_schedule(cfg.ddpm_schedule, T, SIZE, cfg.select_degrade_pixel)
        with pytest.MonkeyPatch.context() as m:
            if branch == "fused":
                m.setenv("MDT_PALLAS_FUSED", "1")
                m.setattr(jfd, "fused_degrade_update", samp.fake_fused_degrade_update)
                m.setattr(jshift, "schedule_shift", samp.fixture_shift)
            else:
                m.delenv("MDT_PALLAS_FUSED", raising=False)
                m.setattr(jax.random, "split", samp.fake_split)
                m.setattr(jdeg, "generate_masks", samp.fixture_generate_masks)
                m.setattr(jdeg, "nested_threshold_masks", samp.fixture_nested_masks)
                m.setattr(jshift, "schedule_shift", samp.fixture_step_shift)
            fn = jax_make_sample_fn(jmodel, jsched, cfg, jsched.timesteps_for_epoch(1, 10, 1),
                                    capture_trajectory=branch == "plain",
                                    capture_items=2 if branch == "plain" else 0,
                                    activation_sharding=act)
            args = (p, lat, jax.random.PRNGKey(0))
            programs[branch] = (fn.lower(*args), [args])
    with ThreadPoolExecutor(len(programs)) as pool:
        compiled = dict(zip(programs, pool.map(lambda lw: lw[0].compile(), programs.values())))
    metrics = []
    for batch, key in programs["train"][1]:
        st, mt = compiled["train"](st, batch, key)
        metrics.append({k: float(v) for k, v in mt.items()})
    runs = {mode: {"metrics": metrics, "state": jax.tree.map(np.asarray, st)}}
    for branch in ("fused", "plain"):
        runs[f"{mode}_{branch}"] = jax.tree.map(np.asarray, compiled[branch](*programs[branch][1][0]))
    return runs


def _port_model(unet, init_sd):
    from masked_diffusion_tpu_torch.models.unet import UNet2D, UNetConfig

    model = UNet2D(UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in unet.items()}))
    model.load_state_dict(init_sd, strict=True)
    return model


def jax_main(work, mode):
    """One JAX reference process of the fixture: `mode`'s runs to
    <work>/jax_<mode>.pkl (and the JAX config of the toy model)."""
    spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)
    fx = dict(np.load(os.path.join(work, "fixtures.npz")))
    jmodel, jcfg, variables = _jax_of(_port_model(spec["unet"]["wide"], spec["init"]["wide"]),
                                      os.path.join(work, f"jax_{mode}_init"))
    _, _, sample_variables = _jax_of(
        _port_model(spec["unet"]["wide"], spec["sample_init"]["wide"]),
        os.path.join(work, f"jax_{mode}_sample"))
    runs = _jax_runs(mode, jmodel, variables, sample_variables, spec["used"], fx)
    with open(os.path.join(work, f"jax_{mode}.pkl"), "wb") as f:
        pickle.dump((runs, jcfg), f)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """Start the 4-rank worker, run JAX meanwhile, then the one-process
    runs. Returns the spec, fixtures, ranks' results and logs, JAX's runs
    and the one-process runs. Training starts from fresh models (conv_out
    zero, as tests/test_distributed.py's do: the first step moves conv_out,
    the second every layer), sampling from models with a random conv_out."""
    work = str(tmp_path_factory.mktemp("grid"))
    init = {which: _port_init(widths, seed, random_out=False)
            for which, widths, seed in (("wide", WIDE, 5), ("deep", DEEP, 6))}
    sample_init = {which: _port_init(widths, seed)
                   for which, widths, seed in (("wide", WIDE, 5), ("deep", DEEP, 6))}
    fx = {**_fixtures(), **_sample_fixtures()}
    np.savez(os.path.join(work, "fixtures.npz"), **fx)
    used = [int(t) for t in jax_build_schedule("log", 20, SIZE, "indexing")
            .timesteps_for_epoch(0, 10, 1)]
    assert len(used) >= 4  # the fixtures' timeindex range

    def sd(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    spec = {
        "unet": {k: _unet_spec(m) for k, m in init.items()},
        "init": {k: sd(m) for k, m in init.items()},
        "sample_init": {k: sd(m) for k, m in sample_init.items()},
        "train_cfg": TRAIN, "sample_cfg": SAMPLE, "trainer_cfg": TRAINER, "used": used,
        "batch": B, "steps": STEPS, "n_sample": N_SAMPLE,
    }
    torch.save(spec, os.path.join(work, "spec.pt"))
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, work], cwd=ROOT,
        env=_env(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(RANKS),
                 LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    # the one-process checkpoint and the JAX references (a process a mode),
    # while the ranks run
    procs += [subprocess.Popen(
        [sys.executable, "-c", code, work, *args], cwd=ROOT, env=_env(XLA_FLAGS=XLA_FAST),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for code, args in ((_ONE_PROCESS, ()), (_JAX_MAIN, ("tp",)), (_JAX_MAIN, ("sp",)))]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    jax_runs = {}
    for mode in ("tp", "sp"):
        with open(os.path.join(work, f"jax_{mode}.pkl"), "rb") as f:
            runs, jcfg = pickle.load(f)
        jax_runs.update(runs)
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
             for r in range(RANKS)]
    ns = {}
    exec(compile(_PORT_RUNS, "port_runs", "exec"), ns)
    one = {"wide": {"train": ns["train_run"](spec, fx, "wide", None),
                    "sample": {b: ns["sample_run"](spec, fx, "wide", b, None)
                               for b in ("fused", "plain")}},
           "deep": {"train": ns["train_run"](spec, fx, "deep", None)}}
    return dict(spec=spec, fx=fx, ranks=ranks, logs=logs[:RANKS], jax=jax_runs, jcfg=jcfg,
                one=one,
                work=work)


def _rel_l2(got, ref):
    num = sum(float((got[k] - v).double().square().sum()) for k, v in ref.items())
    return (num / sum(float(v.double().square().sum()) for v in ref.values())) ** 0.5


def _assert_train_as_one_process(got, one):
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL, atol=0)
    for which in ("params", "ema"):
        assert got[which].keys() == one[which].keys()
        for k, ref in one[which].items():
            np.testing.assert_allclose(got[which][k].numpy(), ref.numpy(), rtol=0, atol=ATOL,
                                       err_msg=f"{which} {k}")
    assert _rel_l2(got["grads"], one["grads"]) <= GRAD_RTOL  # the last (second) step's


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_grid_trains_as_one_process(grid, mode):
    """Data 2 x model 2: every rank ends with the one-process parameters, EMA
    and losses; TP's state is sharded on the ranks, SP's whole."""
    one = grid["one"]["wide"]["train"]
    runs = [r[mode]["train"] for r in grid["ranks"]]
    for run in runs:
        _assert_train_as_one_process(run, one)
    for run in runs[1:]:  # the gathered state is the same on every rank
        assert all(torch.equal(v, runs[0]["params"][k]) for k, v in run["params"].items())
    whole = sum(v.numel() * v.element_size() for v in one["params"].values())
    if mode == "tp":
        assert all(r["ddp"] for r in runs)  # over the data group
        assert set(runs[0]["sharded"]) == {k for k, v in one["params"].items()
                                           if ttp.leaf_sharded(v.shape, 2, 8)}
        assert whole / 2 < runs[0]["local_bytes"] < 0.55 * whole
    else:
        assert all(r["ddp"] and not r["sharded"] for r in runs)
        assert runs[0]["local_bytes"] == whole


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_grid_trains_as_the_jax_step_on_a_2x2_mesh(grid, mode):
    j = grid["jax"][mode]
    got = grid["ranks"][0][mode]["train"]
    _assert_metrics_close([{"train_loss": v} for v in got["losses"]],
                          [{"train_loss": m["train_loss"]} for m in j["metrics"]])
    init = grid["spec"]["init"]["wide"]
    for which, tree in (("params", j["state"].params), ("ema", j["state"].ema_params)):
        ref = weights.state_dict_from_flax(tree, grid["jcfg"])
        _assert_params_close(which, got[which], ref, init, 1e-3)


@pytest.mark.parametrize("mode", ["tp", "sp"])
@pytest.mark.parametrize("branch", ["fused", "plain"])
def test_grid_samples_as_one_process_and_as_jax(grid, mode, branch):
    """Both loop branches (the plain one with capture and the encoder cache
    every other step): the ranks gather one sample, the one-process port's
    within 2e-5, JAX's on the 2x2 mesh within the sampler tests' 2e-3."""
    one = grid["one"]["wide"]["sample"][branch]
    got = [r[mode]["sample"][branch] for r in grid["ranks"]]
    for g in got:
        np.testing.assert_array_equal(g["sample"], got[0]["sample"])
        assert g["steps"] == one["steps"] > 1
    np.testing.assert_allclose(got[0]["sample"], one["sample"], rtol=0, atol=ATOL)
    latent = grid["fx"]["s_latent"]
    assert np.abs(one["sample"] - latent).max() > 1e-2  # the loop moved the sample
    j = grid["jax"][f"{mode}_{branch}"]
    if branch == "plain":
        j_sample, j_traj = j
        for name, buf in got[0]["traj"].items():
            np.testing.assert_allclose(buf, one["traj"][name], rtol=0, atol=ATOL, err_msg=name)
            jbuf = samp.trajectory_images(j_traj[name], SIZE, SIZE, C)
            np.testing.assert_allclose(buf, jbuf, atol=2e-3, rtol=2e-3, err_msg=name)
        for name, m in got[0]["means"].items():
            np.testing.assert_allclose(m, one["means"][name], rtol=0, atol=ATOL)
        j = j_sample
    np.testing.assert_allclose(got[0]["sample"], j, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_regrouped_as_data_1_model_4(grid, mode):
    """The same ranks as one model group of 4, a model whose 2x2 level runs
    replicated under SP (its `sp:` line says so)."""
    one = grid["one"]["deep"]["train"]
    for r in grid["ranks"]:
        _assert_train_as_one_process(r["deep_" + mode], one)
    assert not grid["ranks"][0]["deep_tp"]["ddp"]  # one data rank: no DDP
    assert grid["ranks"][0]["deep_sp"]["ddp"]  # SP: DDP over the 4 ranks
    lines = [json.loads(ln[4:]) for ln in grid["logs"][0].splitlines() if ln.startswith("sp: ")]
    deep = [ln for ln in lines if ln["model_size"] == 4]
    assert [lv["split"] for lv in deep[0]["levels"]] == [True, True, True, False]
    assert not any(ln.startswith("sp: ") for log in grid["logs"][1:] for ln in log.splitlines())


def test_the_grid_layout_and_one_dist_line(grid):
    assert [r["tp"]["ranks"] for r in grid["ranks"]] == [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                                        (3, 1, 1)]
    (line,) = [ln for ln in grid["logs"][0].splitlines() if ln.startswith("dist: ")]
    assert json.loads(line[6:])["world_size"] == RANKS


def _checkpoint_tensors(path):
    from masked_diffusion_tpu_torch.io import checkpoint as ckpt_io

    model_sd, ema_sd, (opt, _), _ = ckpt_io.load_checkpoint(path)
    return {"p": model_sd, "e": ema_sd, "o": opt}


def _assert_bitwise(got, ref, what):
    assert got.keys() == ref.keys(), what
    for k, v in ref.items():
        assert torch.equal(got[k], v), f"{what} {k}"


@pytest.mark.parametrize("mode", ["tp", "sp"])
def test_grid_checkpoints_restore_in_one_process_and_back(grid, mode):
    """The Trainer's checkpoint under TP or SP is today's one-process layout:
    it holds the ranks' final state bitwise, restores into a one-process
    Trainer, and the JAX importer reads it. A one-process checkpoint
    restored on the grid gathers back bitwise."""
    from masked_diffusion_tpu_torch.config import Config
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.train.trainer import Trainer

    ranks = [r[mode]["trainer"] for r in grid["ranks"]]
    (ckpt,) = ranks[0]["checkpoints"]
    assert all(r["checkpoints"] == [ckpt] for r in ranks)
    assert sorted(os.listdir(ckpt)) == ["history.npz", "meta.json", "optimizer", "unet",
                                        "unet_ema"]
    saved = _checkpoint_tensors(ckpt)
    for r in ranks:
        for part in ("p", "e", "o"):
            _assert_bitwise(r["final"][part], saved[part], f"{mode} final {part}")
    one = Trainer(Config(**TRAINER), get_dataset("", "synthetic", SIZE, data_subset=True,
                                                 num_data=16, seed=4), device="cpu")
    assert one.restore(ckpt) == 2
    _assert_bitwise(one.model.state_dict(), saved["p"], "one-process restore")
    _assert_bitwise(one.state.optimizer.state_dict()[0], saved["o"], "one-process optimizer")
    sd, config = import_torch.load_diffusers_folder(os.path.join(ckpt, "unet"))
    assert "conv_in" in import_torch.map_state_dict(
        sd, import_torch.unet_config_from_diffusers(config))["params"]
    # the reverse: a one-process checkpoint on the grid
    ref = _checkpoint_tensors(grid["ranks"][0]["one_process_checkpoint"])
    for r in ranks:
        assert r["restored"]["step"] == 2
        for part in ("p", "e", "o"):
            _assert_bitwise(r["restored"][part], ref[part], f"{mode} restored {part}")


def test_cli_trains_serves_and_tests_on_the_grid(grid):
    """--mesh_model 2 trains (one run tree, the stats line from rank 0
    only), --mesh_spatial true serves its checkpoint, --method test runs on
    it; the checkpoint loads in one process."""
    log0 = grid["logs"][0]

    def stats(tag):
        (line,) = [ln for ln in log0.splitlines() if ln.startswith(tag + " ")]
        return json.loads(line.split(" ", 1)[1])

    train, served, tested = stats("train_stats"), stats("sample_stats"), stats("test_stats")
    assert train["ranks"] == RANKS and train["global_step"] == 2
    assert train["mesh"] == {"data": 2, "model": 2, "spatial": False}
    assert served["mesh"] == {"data": 2, "model": 2, "spatial": True}
    assert served["images"] == 3 and served["finite"] and served["ema"]
    assert tested["mesh"]["model"] == 2 and tested["rounds"] >= 1
    for log in grid["logs"][1:]:
        assert not any(ln.startswith(("train_stats", "sample_stats", "test_stats"))
                       for ln in log.splitlines())
    runs = glob.glob(os.path.join(grid["work"], "cli", "train", "result", "*", "*", "*", "*"))
    assert len(runs) == 1
    unet_sd, ema_sd, _ = weights.load_checkpoint(grid["ranks"][0]["cli_checkpoint"])
    model = build_unet(C, SIZE, SIZE, block_out_channels=WIDE, layers_per_block=1)
    model.load_state_dict(unet_sd, strict=True)
    model.load_state_dict(ema_sd, strict=True)
