"""Checkpoints and resume in the port (io/checkpoint.py, Trainer.restore,
preemption) on the CPU, at a tiny UNet (block_out_channels 8,16, one layer a
block, 8x8 images):

  * a checkpoint's round trip (params, EMA, the optimizer's moments, step
    counts, `count`, `mini_step` and the gradient sums of an open
    accumulation window) is bitwise, sync and async, and history.npz holds
    the JAX package's keys;
  * the directory logic (resume scan, completeness, retention) is held
    against masked_diffusion_tpu.io.checkpoint on the same trees: the cases
    of tests/test_checkpoint.py's TestResumeScan, TestAsyncSave,
    TestPruneSafety and TestRetention;
  * a run resumed at an epoch boundary, and one preempted by SIGTERM inside
    an epoch (raised from inside a step, at a fixed step; once inside an
    accumulation window), end bitwise equal to the uninterrupted run:
    params, EMA and loss_mean_epoch;
  * a train step after a restore matches the JAX step on injected draws
    (tests/test_torch_port_train.py's machinery and tolerances);
  * restore refuses a checkpoint without the EMA or the optimizer;
  * the CLI resumes (--resume_from_checkpoint latest) to --num_epochs in
    total, with retention and async saves, raises on a missing path, and
    --method sample serves the newest checkpoint;
  * two gloo ranks: SIGTERM reaches rank 1 only, both ranks stop at the
    same epoch boundary inside an accumulation window, and the resumed run
    equals the uninterrupted one bitwise;
  * the JAX package's io/import_torch reads a checkpoint the port's trainer
    wrote.
"""

import glob
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config as JConfig
from masked_diffusion_tpu.io import checkpoint as jckpt
from masked_diffusion_tpu.io import import_torch
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu.train import step as jstep
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset, get_dataset
from masked_diffusion_tpu_torch.io import checkpoint as pckpt
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.train.trainer import Trainer
from masked_diffusion_tpu_torch.utils.dirs import Dir
from tests.test_torch_port_train import (
    ATOL,
    CASES,
    RTOL,
    _fixtures,
    _jax_fakes,
    _port_draws,
)
from tests.test_torch_port_unet import SIZE as PARITY_SIZE
from tests.test_torch_port_unet import jax_unet, port_unet, two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 8


def _cfg(**kw):
    base = dict(
        method="mean_shift", data_name="synthetic", data_size=SIZE, data_subset=True,
        data_subset_num=16, batch_size=4, num_epochs=3, ddpm_schedule="log",
        ddpm_num_steps=6, select_degrade_pixel="indexing", degrade_channel="1-channel",
        mean_option="degraded_area", mean_area="image-wise", shift_type="1-d_constant",
        use_ema=True, lr=1e-3, lr_scheduler="constant", lr_warmup_steps=0, sample_num=2,
        sample_latent_shape="zero", save_images_epochs=100, sampling="momentum",
        use_wandb=False, block_out_channels=(8, 16), layers_per_block=1,
    )
    base.update(kw)
    return Config(**base)


def _trainer(cfg):
    data = get_dataset("", "synthetic", SIZE, data_subset=True, num_data=cfg.data_subset_num,
                       seed=cfg.seed)
    return Trainer(cfg, data, device="cpu")


def _dirs(tmp_path, sub, cfg):
    return Dir(task="train", content=sub, dir_work=str(tmp_path / sub), data_name="synthetic",
               data_size=SIZE, method=cfg.method)


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k} differs"


def _assert_same_run(got: Trainer, ref: Trainer):
    _assert_same(_sd(got.model), _sd(ref.model), "params")
    _assert_same(_sd(got.state.ema_model), _sd(ref.state.ema_model), "EMA")
    assert got.loss_mean_epoch == ref.loss_mean_epoch  # bitwise: exact float equality
    assert got.lr_list == ref.lr_list
    assert got.global_step == ref.global_step and got.state.step == ref.state.step


def _preempt_at(trainer: Trainer, at_step: int):
    """Raise SIGTERM inside the step that makes global step `at_step`."""
    make = trainer._get_step_fn

    def get(used):
        fn = make(used)

        def step(*a, **k):
            out = fn(*a, **k)
            if trainer.global_step + 1 == at_step:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    trainer._get_step_fn = get


@pytest.fixture
def no_sigterm_kill():
    """A no-op outer SIGTERM handler: a signal no trainer handles must not
    end the test process."""
    outer = signal.signal(signal.SIGTERM, lambda *_: None)
    yield
    signal.signal(signal.SIGTERM, outer)


# ------------------------------------------------------------------ round trip


@pytest.mark.parametrize("async_save", [False, True], ids=["sync", "async"])
def test_round_trip_is_bitwise(tmp_path, async_save):
    cfg = _cfg(data_subset_num=12, gradient_accumulation_steps=2, num_epochs=2)
    t = _trainer(cfg)
    t.train(0, 1)  # 3 micro steps: one update, a window left open
    opt = t.state.optimizer
    assert opt.count == 1 and opt.mini_step == 1
    want_params, want_ema = _sd(t.model), _sd(t.state.ema_model)
    want_tensors = {k: v.clone() for k, v in opt.state_dict()[0].items()}
    assert {k.rsplit(".", 1)[1] for k in want_tensors} == {"exp_avg", "exp_avg_sq", "step",
                                                           "grad"}
    dirs = types.SimpleNamespace(list_dir={"checkpoint": str(tmp_path)})
    path = t._save_checkpoint(dirs, 0, None, t._history(), async_save=async_save)
    # the host copy is taken before the save returns: a later in-place
    # update cannot reach what is written
    with torch.no_grad():
        for p in t.model.parameters():
            p.add_(1.0)
            p.grad.add_(1.0)
        for v in opt.state_dict()[0].values():
            v.add_(1.0)
    pckpt.wait_for_async_saves()
    assert pckpt.is_complete_checkpoint(path)
    assert sorted(os.listdir(path)) == ["history.npz", "meta.json", "optimizer", "unet",
                                        "unet_ema"]

    fresh = _trainer(cfg)
    assert fresh.restore(path) == t.global_step == 3
    _assert_same(_sd(fresh.model), want_params, "params")
    _assert_same(_sd(fresh.state.ema_model), want_ema, "EMA")
    got = fresh.state.optimizer
    _assert_same({k: v.clone() for k, v in got.state_dict()[0].items()}, want_tensors,
                 "optimizer")
    assert (got.count, got.mini_step, fresh.state.step) == (1, 1, 3)
    with np.load(os.path.join(path, "history.npz")) as h:
        assert sorted(h.files) == ["loss_mean_epoch", "lr_list"]
        assert h["loss_mean_epoch"].tolist() == t.loss_mean_epoch
        assert h["lr_list"].tolist() == t.lr_list
    assert fresh.loss_mean_epoch == t.loss_mean_epoch and fresh.lr_list == t.lr_list
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["items"] == ["unet", "unet_ema", "optimizer"] and meta["global_step"] == 3


# ------------------------------------------------------------------ directory logic
# Each case runs on a tree of its own for each package, through that
# package's functions (`api`), and returns what it observed; the two
# packages must observe the same, but where noted.


def _jax_api():
    def tree(seed):
        k = jax.random.PRNGKey(seed)
        return {"layer": {"kernel": jax.random.normal(k, (4, 4)), "bias": jnp.ones((4,))}}

    def save(root, epoch, step, ema=False, keep_last=0, async_save=False):
        return jckpt.save_checkpoint(str(root), epoch, step, tree(epoch),
                                     tree(epoch + 1) if ema else None, keep_last=keep_last,
                                     async_save=async_save)

    def epoch_of(path):
        return jckpt.load_checkpoint(path, tree(0))[3]["epoch"]

    return types.SimpleNamespace(save=save, find=jckpt.find_resume_checkpoint,
                                 prune=jckpt._prune_checkpoints,
                                 complete=jckpt.is_complete_checkpoint,
                                 wait=jckpt.wait_for_async_saves, epoch_of=epoch_of)


def _port_api():
    def tree(seed):
        g = torch.Generator().manual_seed(seed)
        return {"layer.kernel": torch.randn(4, 4, generator=g), "layer.bias": torch.ones(4)}

    def save(root, epoch, step, ema=False, keep_last=0, async_save=False):
        return pckpt.save_checkpoint(str(root), epoch, step, tree(epoch),
                                     tree(epoch + 1) if ema else None, keep_last=keep_last,
                                     async_save=async_save)

    def epoch_of(path):
        return pckpt.load_checkpoint(path)[3]["epoch"]

    return types.SimpleNamespace(save=save, find=pckpt.find_resume_checkpoint,
                                 prune=pckpt._prune_checkpoints,
                                 complete=pckpt.is_complete_checkpoint,
                                 wait=pckpt.wait_for_async_saves, epoch_of=epoch_of)


def _left(root):
    return sorted(d for d in os.listdir(root) if d.startswith("checkpoint"))


def _base(path):
    return None if path is None else os.path.basename(path)


def case_latest_scan(root, api):
    for epoch in (3, 11, 7):
        api.save(root, epoch, epoch * 10)
    return _base(api.find(str(root), "latest"))


def case_explicit_path(root, api):
    p = api.save(root, 2, 20)
    return api.find(str(root), p) == p


def case_no_checkpoints(root, api):
    return api.find(str(root), "latest"), api.find(str(root / "nope"), "latest")


def case_latest_skips_incomplete(root, api):
    api.save(root, 3, 30)
    os.makedirs(root / "checkpoint-epoch-9")  # crashed before anything was written
    os.makedirs(root / "checkpoint-epoch-12" / "unet.orbax-checkpoint-tmp-123")  # in flight
    return _base(api.find(str(root), "latest"))


def case_async_round_trip(root, api):
    path = api.save(root, 4, 400, ema=True, async_save=True)
    api.wait()
    return api.find(str(root), "latest") == path, api.epoch_of(path)


def case_async_back_to_back(root, api):
    for epoch in (1, 2, 3):
        api.save(root, epoch, epoch, keep_last=2, async_save=True)
    api.wait()
    after_async = _left(root)
    latest = _base(api.find(str(root), "latest"))
    api.save(root, 4, 4, keep_last=2)
    return after_async, latest, _left(root)


def case_inflight_newest_does_not_displace_complete(root, api):
    api.save(root, 10, 100)
    api.save(root, 20, 200)
    os.makedirs(root / "checkpoint-epoch-30" / "unet.orbax-checkpoint-tmp-1")
    api.prune(str(root), keep_last=1, protect=str(root / "checkpoint-epoch-30"))
    return _left(root), _base(api.find(str(root), "latest"))


def case_inflight_protected_despite_stale_higher_epochs(root, api):
    api.save(root, 3, 30)
    os.makedirs(root / "checkpoint-epoch-99" / "unet.orbax-checkpoint-tmp-9")
    os.makedirs(root / "checkpoint-epoch-5" / "unet.orbax-checkpoint-tmp-1")
    api.prune(str(root), keep_last=2, protect=str(root / "checkpoint-epoch-5"))
    return _left(root)


def case_crashed_garbage_is_deleted_not_retained(root, api):
    api.save(root, 10, 100)
    os.makedirs(root / "checkpoint-epoch-15")
    api.save(root, 20, 200)
    api.prune(str(root), keep_last=2)
    return _left(root)


def case_partial_commit_is_incomplete(root, api):
    path = api.save(root, 5, 50, ema=True)
    seen = [api.complete(path)]
    shutil.rmtree(os.path.join(path, "unet_ema"))
    seen.append(api.complete(path))
    os.remove(os.path.join(path, "meta.json"))
    seen.append(api.complete(path))  # unet complete, nothing unfinished
    os.makedirs(os.path.join(path, "optimizer.orbax-checkpoint-tmp-9"))
    seen.append(api.complete(path))
    return seen


def case_keep_last_prunes_oldest(root, api):
    for epoch in (1, 3, 5):
        api.save(root, epoch, epoch * 10)
    n = len(_left(root))
    api.save(root, 7, 70, keep_last=2)
    return n, _left(root), api.epoch_of(str(root / "checkpoint-epoch-7"))


def case_keep_last_zero_keeps_all(root, api):
    for epoch in (1, 2, 3):
        api.save(root, epoch, epoch, keep_last=0)
    return _left(root)


DIRECTORY_CASES = {
    "latest_scan": (case_latest_scan, "checkpoint-epoch-11"),
    "explicit_path": (case_explicit_path, True),
    "no_checkpoints": (case_no_checkpoints, (None, None)),
    "latest_skips_incomplete": (case_latest_skips_incomplete, "checkpoint-epoch-3"),
    "async_round_trip": (case_async_round_trip, (True, 4)),
    # the JAX package prunes an async save at dispatch, before it commits
    # (the newest does not count: one more survives until the next sync
    # save); the port prunes once it has committed
    "async_back_to_back": (case_async_back_to_back, None),
    "inflight_newest_does_not_displace_complete": (
        case_inflight_newest_does_not_displace_complete,
        (["checkpoint-epoch-20", "checkpoint-epoch-30"], "checkpoint-epoch-20")),
    "inflight_protected_despite_stale_higher_epochs": (
        case_inflight_protected_despite_stale_higher_epochs,
        ["checkpoint-epoch-3", "checkpoint-epoch-5"]),
    "crashed_garbage_is_deleted_not_retained": (
        case_crashed_garbage_is_deleted_not_retained,
        ["checkpoint-epoch-10", "checkpoint-epoch-20"]),
    "partial_commit_is_incomplete": (case_partial_commit_is_incomplete,
                                     [True, False, True, False]),
    "keep_last_prunes_oldest": (case_keep_last_prunes_oldest,
                                (3, ["checkpoint-epoch-5", "checkpoint-epoch-7"], 7)),
    "keep_last_zero_keeps_all": (case_keep_last_zero_keeps_all,
                                 ["checkpoint-epoch-1", "checkpoint-epoch-2",
                                  "checkpoint-epoch-3"]),
}


@pytest.mark.parametrize("name", list(DIRECTORY_CASES))
def test_directory_logic_matches_jax(tmp_path, name):
    case, want = DIRECTORY_CASES[name]
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    got_jax = case(tmp_path / "jax", _jax_api())
    got_port = case(tmp_path / "port", _port_api())
    if name == "async_back_to_back":
        three = ["checkpoint-epoch-1", "checkpoint-epoch-2", "checkpoint-epoch-3"]
        last = ["checkpoint-epoch-3", "checkpoint-epoch-4"]
        assert got_jax == (three, "checkpoint-epoch-3", last)
        assert got_port == (three[1:], "checkpoint-epoch-3", last)
        return
    assert got_jax == want
    assert got_port == got_jax


def test_staging_directories(tmp_path):
    """The port's own unfinished writes: the resume scan never sees a
    staging directory, pruning deletes a stale one but the protected
    checkpoint's, and saving an epoch again replaces its checkpoint."""
    api = _port_api()
    api.save(tmp_path, 3, 30)
    for name in ("checkpoint-epoch-5.tmp-abc123", "checkpoint-epoch-9.tmp-0a1b2c",
                 "checkpoint-epoch-3.old-ff00ff"):
        os.makedirs(tmp_path / name / "unet")
    assert _base(api.find(str(tmp_path), "latest")) == "checkpoint-epoch-3"
    api.prune(str(tmp_path), keep_last=1, protect=str(tmp_path / "checkpoint-epoch-5"))
    assert _left(tmp_path) == ["checkpoint-epoch-3", "checkpoint-epoch-5.tmp-abc123"]

    api.save(tmp_path, 3, 31)
    assert _left(tmp_path) == ["checkpoint-epoch-3", "checkpoint-epoch-5.tmp-abc123"]
    assert pckpt.load_checkpoint(str(tmp_path / "checkpoint-epoch-3"))[3]["global_step"] == 31


# ------------------------------------------------------------------ resume


def test_resume_at_an_epoch_boundary_is_bitwise(tmp_path):
    """4 epochs against 2 + restore + 2; the curriculum depends on the total
    (scheduler_num_scale_timesteps=2), so a resumed run that took it from
    its own loop would differ."""
    cfg = _cfg(num_epochs=4, scheduler_num_scale_timesteps=2)
    full = _trainer(cfg)
    full.train(0, 4, dirs=_dirs(tmp_path, "full", cfg))

    half = _trainer(cfg)
    dirs = _dirs(tmp_path, "half", cfg)
    half.train(0, 2, dirs=dirs)
    path = pckpt.find_resume_checkpoint(dirs.list_dir["checkpoint"], "latest")
    assert os.path.basename(path) == "checkpoint-epoch-1"
    resumed = _trainer(cfg)
    gs = resumed.restore(path)
    assert gs == half.global_step == 8 and resumed.state.step == 8
    assert resumed.loss_mean_epoch == half.loss_mean_epoch
    resumed.train(2, 2, 0, gs, dirs=_dirs(tmp_path, "resumed", cfg))
    assert len(resumed.loss_mean_epoch) == 4
    _assert_same_run(resumed, full)


@pytest.mark.parametrize("accum,at_step", [(1, 6), (2, 7)], ids=["accum1", "accum2-window"])
def test_sigterm_inside_an_epoch_resumes_bitwise(tmp_path, no_sigterm_kill, accum, at_step):
    """SIGTERM raised inside the step that makes global step `at_step`
    (epoch 1 of 4 steps): the run stops after that step and saves a
    preemption checkpoint; restored into a fresh trainer and finished, it
    equals the uninterrupted run. With accumulation 2 the stop falls inside
    a window (an odd step)."""
    cfg = _cfg(gradient_accumulation_steps=accum)
    full = _trainer(cfg)
    full.train(0, 3, dirs=_dirs(tmp_path, "full", cfg))

    pre = _trainer(cfg)
    dirs = _dirs(tmp_path, "pre", cfg)
    _preempt_at(pre, at_step)
    result = pre.train(0, 3, dirs=dirs)
    assert result["preempted"] and pre.global_step == at_step
    assert pre.state.optimizer.mini_step == (at_step % accum)
    assert len(pre.loss_mean_epoch) == 1  # the cut epoch's partial mean is left out
    (path,) = result["checkpoints"]
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert meta["preempted"] is True and meta["global_step"] == at_step
    with np.load(os.path.join(path, "history.npz")) as h:
        assert len(h["cut_epoch_losses"]) == at_step - 4 and len(h["lr_list"]) == at_step

    resumed = _trainer(cfg)
    gs = resumed.restore(pckpt.find_resume_checkpoint(dirs.list_dir["checkpoint"], "latest"))
    first_epoch, resume_step = divmod(gs, 4)
    assert (first_epoch, resume_step) == (1, at_step - 4)
    out = resumed.train(first_epoch, 3 - first_epoch, resume_step, gs,
                        dirs=_dirs(tmp_path, "resumed", cfg))
    assert not out["preempted"]
    _assert_same_run(resumed, full)


@pytest.mark.parametrize("missing", ["optimizer", "unet_ema"])
def test_restore_refuses_a_checkpoint_without_state(tmp_path, missing):
    cfg = _cfg(num_epochs=1, data_subset_num=4)
    t = _trainer(cfg)
    (path,) = t.train(0, 1, dirs=_dirs(tmp_path, "run", cfg))["checkpoints"]
    shutil.rmtree(os.path.join(path, missing))
    with pytest.raises(ValueError, match=missing):
        _trainer(cfg).restore(path)


# ------------------------------------------------------------------ against JAX


def _assert_update_close(name, got, ref, init, lr):
    """tests/test_torch_port_train.py's parameter tolerances."""
    diff2 = upd2 = 0.0
    loose = total = 0
    for k, r in ref.items():
        d = (got[k] - r).abs()
        assert d.max().item() <= lr, f"{name} {k}: max |diff| {d.max().item()}"
        loose += int((d > ATOL + RTOL * r.abs()).sum())
        total += r.numel()
        diff2 += float((d ** 2).sum())
        upd2 += float(((r - init[k]) ** 2).sum())
    assert upd2 > 0
    assert (diff2 / upd2) ** 0.5 <= RTOL, f"{name}: update norm differs by {(diff2 / upd2) ** 0.5}"
    assert loose <= 1e-3 * total, f"{name}: {loose} of {total} entries off"


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_step_after_restore_matches_jax(tmp_path, monkeypatch, case):
    """Steps on injected draws in both packages; the port's state is saved
    and restored into a fresh trainer after the first `before` steps (with
    accumulation 2, inside a window), which then takes the next step. That
    step matches JAX's (the optax state crossed a checkpoint only in the
    port) and the uninterrupted port's bitwise."""
    jmodel, jcfg, variables = jax_unet(seed=3)
    accum = CASES[case].get("gradient_accumulation_steps", 1)
    before, total = (2, 3) if accum == 1 else (3, 4)
    jc = JConfig(data_size=PARITY_SIZE, ddpm_num_steps=20, mean_option="degraded_area",
                 lr=1e-3, mixed_precision="no", out_channel=3, **CASES[case])
    jsched = jax_build_schedule(jc.ddpm_schedule, jc.ddpm_num_steps, PARITY_SIZE,
                                jc.select_degrade_pixel)
    used = jsched.timesteps_for_epoch(0, 10, 1)
    fx = _fixtures(len(used), seed=len(case))

    jlr = joptim.build_lr_schedule(jc.lr_scheduler, jc.lr, jc.lr_warmup_steps * accum, 20,
                                   jc.lr_cycle)
    tx = joptim.build_optimizer(jc.optim, jlr, 1.0, accum)
    params = jax.tree.map(jnp.asarray, variables)
    jstate = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                              ema_params=jax.tree.map(jnp.copy, params),
                              opt_state=tx.init(params))
    split, randint, degrade, shift = _jax_fakes(fx)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jdeg, "degrade_training", degrade)
        m.setattr(jshift, "schedule_shift", shift)
        jfn = jax.jit(jstep._make_step_impl(jmodel, jsched, jc, tx, used, jlr))
        j_metrics = []
        for i in range(total):
            jstate, mt = jfn(jstate, jnp.asarray(fx["images"][i]), jax.random.PRNGKey(i))
            j_metrics.append({k: float(v) for k, v in mt.items()})

    # 2 images a batch of 2, 20 epochs: the LR schedule's 20 steps
    cfg = Config(data_size=PARITY_SIZE, ddpm_num_steps=20, mean_option="degraded_area",
                 lr=1e-3, mixed_precision="no", out_channel=3, batch_size=2, num_epochs=20,
                 **CASES[case])
    data = InMemoryDataset(fx["images"][0], np.zeros(2))
    channels = 3 if cfg.degrade_channel == "3-channel" else 1

    def trainer():
        return Trainer(cfg, data, model=port_unet(jcfg, variables).train(), device="cpu")

    def run(t, steps):
        fn = t._get_step_fn(used)
        out = []
        for i in steps:
            m = fn(t.state, torch.from_numpy(fx["images"][i]), draws=_port_draws(fx, i, channels))
            t.global_step += 1
            out.append({k: float(v) for k, v in m.items()})
        return out

    first = trainer()
    run(first, range(before))
    path = first._save_checkpoint(types.SimpleNamespace(list_dir={"checkpoint": str(tmp_path)}),
                                  0, None, first._history())
    resumed = trainer()
    assert resumed.restore(path) == before
    assert resumed.state.optimizer.mini_step == before % accum
    got = run(resumed, range(before, total))
    ref = run(first, range(before, total))
    assert got == ref
    _assert_same(_sd(resumed.model), _sd(first.model), "params")
    _assert_same(_sd(resumed.state.ema_model), _sd(first.state.ema_model), "EMA")

    for key in j_metrics[0]:
        np.testing.assert_allclose([m[key] for m in got], [m[key] for m in j_metrics[before:]],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    init = weights.state_dict_from_flax(variables, jcfg)
    for name, module, jtree in (("params", resumed.model, jstate.params),
                                ("ema", resumed.state.ema_model, jstate.ema_params)):
        jref = weights.state_dict_from_flax(jax.tree.map(np.asarray, jtree), jcfg)
        _assert_update_close(name, _sd(module), jref, init, cfg.lr)


# ------------------------------------------------------------------ the CLI


def _cli_args(work, *extra):
    return ["--method", "mean_shift", "--device", "cpu", "--data_name", "synthetic",
            "--data_size", str(SIZE), "--data_subset", "True", "--data_subset_num", "8",
            "--batch_size", "4", "--num_epochs", "2", "--save_images_epochs", "100",
            "--ddpm_schedule", "log", "--ddpm_num_steps", "6", "--mean_option",
            "degraded_area", "--shift_type", "1-d_constant", "--sampling", "momentum",
            "--sample_num", "2", "--sample_latent_shape", "zero", "--block_out_channels",
            "8,16", "--layers_per_block", "1", "--use_wandb", "False", "--lr_warmup_steps",
            "0", "--dir_work", str(work), "--date", "d", "--time", "t", *extra]


def _stats(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line.split(" ", 1)[1])


def _set(args, flag, value):
    args = list(args)
    args[args.index(flag) + 1] = value
    return args


def test_cli_resumes_to_the_total_epochs(tmp_path, capsys, monkeypatch):
    """Two epochs, then the same run (--date/--time) resumed to 4 with
    retention 1 and async saves: 2 more epochs, one complete checkpoint
    left, with optimizer/ and history.npz. Then from --output_dir; a named
    checkpoint that does not exist raises; and --method sample serves the
    newest checkpoint."""
    args = _cli_args(tmp_path / "run")
    assert port_cli.main(args) == 0
    first = _stats(capsys.readouterr().out, "train_stats")
    assert first["global_step"] == 4 and not first["preempted"]
    ckpt_dir = os.path.dirname(first["checkpoints"][0])

    more = _set(args, "--num_epochs", "4") + [
        "--resume_from_checkpoint", "latest", "--keep_last_checkpoints", "1",
        "--async_checkpoints", "true", "--save_images_epochs", "1"]
    assert port_cli.main(more) == 0
    out = capsys.readouterr().out
    assert "Resuming from checkpoint" in out and "(epoch 2)" in out
    stats = _stats(out, "train_stats")
    assert stats["global_step"] == 8 and stats["epochs"] == 4
    assert stats["checkpoints"] == [os.path.join(ckpt_dir, f"checkpoint-epoch-{e}")
                                    for e in (2, 3)]
    assert os.listdir(ckpt_dir) == ["checkpoint-epoch-3"]
    last = os.path.join(ckpt_dir, "checkpoint-epoch-3")
    assert pckpt.is_complete_checkpoint(last)
    assert {"optimizer", "history.npz"} <= set(os.listdir(last))
    with open(os.path.join(os.path.dirname(ckpt_dir), "log", "metrics.jsonl")) as f:
        assert [json.loads(ln)["epoch"] for ln in f] == [0, 1, 2, 3]

    # --output_dir names where to look; this run writes a tree of its own
    other = _set(_set(more, "--time", "t2"), "--num_epochs", "5") + ["--output_dir", ckpt_dir]
    assert port_cli.main(other) == 0
    assert _stats(capsys.readouterr().out, "train_stats")["global_step"] == 10

    with pytest.raises(FileNotFoundError, match="does not exist"):
        port_cli.main(_set(more, "--resume_from_checkpoint", str(tmp_path / "nope")))

    served = []
    real = weights.load_checkpoint
    monkeypatch.setattr(weights, "load_checkpoint", lambda p: served.append(p) or real(p))
    serve = _set(_set(args, "--method", "sample"), "--dir_work", str(tmp_path / "serve"))
    assert port_cli.main(serve + ["--resume_from_checkpoint", "latest",
                                  "--output_dir", ckpt_dir]) == 0
    assert _stats(capsys.readouterr().out, "sample_stats")["finite"]
    assert served == [last]


# ------------------------------------------------------------------ two ranks

_RANKS = r"""
import json, os, signal, sys
import torch
torch.set_num_threads(1)
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.data.datasets import get_dataset
from masked_diffusion_tpu_torch.io.checkpoint import find_resume_checkpoint
from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
from masked_diffusion_tpu_torch.train.trainer import Trainer
from masked_diffusion_tpu_torch.utils import host
from masked_diffusion_tpu_torch.utils.dirs import Dir

work, cfg_json = sys.argv[1], sys.argv[2]
plan = make_mesh(2, 1, init_distributed("cpu"))
cfg = Config(**json.loads(cfg_json))
data = get_dataset("", "synthetic", cfg.data_size, data_subset=True,
                   num_data=cfg.data_subset_num, seed=cfg.seed)


def dirs(sub):
    return Dir(task="train", content=sub, dir_work=os.path.join(work, sub), data_name="synthetic",
               data_size=cfg.data_size, date="d", time="t", method=cfg.method,
               make_dirs=host.is_main_process())


def trainer():
    return Trainer(cfg, data, device="cpu", plan=plan)


def snapshot(t):
    return {"params": {k: v.clone() for k, v in t.model.state_dict().items()},
            "ema": {k: v.clone() for k, v in t.state.ema_model.state_dict().items()},
            "loss": t.loss_mean_epoch, "step": t.global_step}


full = trainer()
full.train(0, 2, dirs=dirs("full"))
out = {"full": snapshot(full)}

pre = trainer()
make = pre._get_step_fn


def get(used):
    fn = make(used)

    def step(*a, **k):
        res = fn(*a, **k)
        if plan.rank == 1 and pre.global_step == 1:  # rank 1's second step of epoch 0
            signal.raise_signal(signal.SIGTERM)
        return res
    return step


pre._get_step_fn = get
result = pre.train(0, 2, dirs=dirs("pre"))
out["pre"] = {"step": pre.global_step, "checkpoints": result["checkpoints"],
              "preempted": result["preempted"], "mini_step": pre.state.optimizer.mini_step}
host.barrier()
res = trainer()
gs = res.restore(find_resume_checkpoint(dirs("pre").list_dir["checkpoint"], "latest"))
first, skip = divmod(gs, data.num_batches(cfg.batch_size))
res.train(first, 2 - first, skip, gs, dirs=dirs("resumed"))
out["resumed"] = snapshot(res)
torch.save(out, os.path.join(work, f"rank{plan.rank}.pt"))
torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_ranks_preempted_on_one_rank_resume_bitwise(tmp_path):
    """Rank 1 alone gets SIGTERM in epoch 0 (of 3 steps, accumulation 2):
    both ranks train the epoch out, agree, and save one checkpoint at its
    end, inside an accumulation window (each rank's own gradient sum); the
    resumed 2-rank run equals the uninterrupted one bitwise on both ranks."""
    cfg = dict(method="mean_shift", data_size=SIZE, data_subset_num=24, batch_size=8,
               num_epochs=2, gradient_accumulation_steps=2, ddpm_schedule="log",
               ddpm_num_steps=6, mean_option="degraded_area", shift_type="1-d_constant",
               lr=1e-3, lr_scheduler="constant", lr_warmup_steps=0, sample_num=2,
               sample_latent_shape="zero", save_images_epochs=100, sampling="momentum",
               use_wandb=False, block_out_channels=[8, 16], layers_per_block=1)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=ROOT, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-c", _RANKS, str(tmp_path), json.dumps(cfg)],
                              cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for r in ranks:
        assert r["pre"]["preempted"] and r["pre"]["step"] == 3 and r["pre"]["mini_step"] == 1
        assert [os.path.basename(p) for p in r["pre"]["checkpoints"]] == ["checkpoint-epoch-0"]
        assert r["resumed"]["step"] == r["full"]["step"] == 6
        assert r["resumed"]["loss"] == r["full"]["loss"]
        for part in ("params", "ema"):
            _assert_same(r["resumed"][part], r["full"][part], part)
        _assert_same(r["full"]["params"], ranks[0]["full"]["params"], "ranks")
    assert "SIGTERM: resumable checkpoint saved at epoch 0" in logs[0]
    ckpts = glob.glob(str(tmp_path / "pre" / "**" / "checkpoint-epoch-*"), recursive=True)
    assert len(ckpts) == 1
    tensors, scalars = pckpt.load_checkpoint(ckpts[0])[2]
    assert scalars["grad_ranks"] == 2 and scalars["mini_step"] == 1
    grad = tensors["conv_in.weight.grad"]
    assert grad.shape[0] == 2 and not torch.equal(grad[0], grad[1])


# ------------------------------------------------------------------ port -> JAX


def test_the_jax_importer_reads_a_port_checkpoint(tmp_path):
    """masked_diffusion_tpu.io.import_torch.import_checkpoint, as it is,
    reads a checkpoint of the port's trainer (with optimizer/ and
    history.npz beside the weights): params and EMA equal the port's."""
    cfg = _cfg(num_epochs=1, data_subset_num=8)
    t = _trainer(cfg)
    (path,) = t.train(0, 1, dirs=_dirs(tmp_path, "run", cfg))["checkpoints"]
    assert {"optimizer", "history.npz"} <= set(os.listdir(path))
    out = import_torch.import_checkpoint(path, str(tmp_path / "jax"))
    sd, config = import_torch.load_diffusers_folder(os.path.join(path, "unet"))
    jcfg = import_torch.unet_config_from_diffusers(config)
    template = import_torch.map_state_dict(sd, jcfg)
    params, ema, _, meta = jckpt.load_checkpoint(out, template, template)
    assert meta["global_step"] == 2 and meta["epoch"] == 0
    for tree, module in ((params, t.model), (ema, t.state.ema_model)):
        got = weights.state_dict_from_flax(jax.tree.map(np.asarray, tree), jcfg)
        _assert_same(got, _sd(module), "imported")
