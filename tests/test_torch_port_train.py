"""The training slice: the port's train step against the JAX step, and the
port's trainer and CLI end to end on the CPU.

The JAX step (masked_diffusion_tpu/train/step.py:_make_step_impl) is jitted
with its draws replaced by fixtures, in the pattern of
tests/test_sampler_parity.py:59-120: jax.random.split hands the step key
through unchanged, so the fakes of jax.random.randint (the timestep draw),
degrade_ops.degrade_training and shift_ops.schedule_shift read the step
index from the key and return that step's fixed draws. The port's step gets
the same draws through `draws=` and runs its plain versions on the CPU:
the exact-k mask from the same uint32 bits (the JAX fake ranks the same
composite keys with masks_from_uniforms), the thresholding mask from the
same uniforms. Weights cross through state_dict_from_flax.

Tolerances, fp32 throughout, sums in another order. The metrics agree to
rtol 2e-3 (the tolerance of tests/test_train_parity.py), atol 1e-5. The
parameter updates (final minus initial, parameters and EMA) agree to 2e-3
in relative L2 norm over the whole model. Elementwise, at most 0.1% of the
entries may leave rtol 2e-3 / atol 1e-5, and none may differ by more than
the learning rate: Adam divides each coordinate by its own gradient scale,
so a coordinate whose gradient cancels to near zero turns summation-order
noise into a move of up to one LR per step (measured: 171 of 702499
entries, max 3.4e-4 at LR 1e-3, update norms within 2.9e-4).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from masked_diffusion_tpu.config import Config
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu.train import step as jstep
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import TrainDraws, create_train_state, make_train_step
from tests.test_torch_port_unet import SIZE, jax_unet, port_unet, two_torch_threads  # noqa: F401

B, C, STEPS = 2, 3, 5
HW = SIZE * SIZE
RTOL, ATOL = 2e-3, 1e-5


def _fixtures(n_used, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(STEPS, B, HW), dtype=np.uint64).astype(np.uint32)
    bits[:, 1] &= np.uint32(0xF0000000)  # tied top bits in one image
    lane_bits = max(1, (HW - 1).bit_length())
    keys = (bits & np.uint32((0xFFFFFFFF << lane_bits) & 0xFFFFFFFF)) | np.arange(
        HW, dtype=np.uint32)
    return dict(
        images=rng.uniform(-1, 1, size=(STEPS, B, SIZE, SIZE, C)).astype(np.float32),
        timeindex=rng.integers(0, n_used, size=(STEPS, B)).astype(np.int32),
        bits=bits, keys=keys,
        mask_u=rng.uniform(0, 1, size=(STEPS, B, SIZE, SIZE, C)).astype(np.float32),
        uniform=rng.uniform(-1, 1, size=(STEPS, B)).astype(np.float32),
        normal=rng.normal(size=(STEPS, B, SIZE, SIZE, C)).astype(np.float32),
    )


def _jax_fakes(fx):
    """Fakes reading the step index i from key[1] (keys are PRNGKey(i) and
    split passes them through)."""
    def split(key, num=2):
        return jnp.stack([key] * num)

    def randint(key, shape, minval, maxval, dtype=jnp.int32):
        return jnp.take(jnp.asarray(fx["timeindex"]), key[1], axis=0)

    def degrade_training(key, img, amount, select, channel, mean_option, mean_area,
                         mesh=None):
        b, h, w, c = img.shape
        if select == "indexing":
            keys = jnp.take(jnp.asarray(fx["keys"]), key[1], axis=0)
            masks = jdeg.masks_from_uniforms(keys, amount).reshape(b, h, w, 1)
        else:
            u = jnp.take(jnp.asarray(fx["mask_u"]), key[1], axis=0)
            u = u if channel == "3-channel" else u[..., :1]
            masks = (u > amount.astype(jnp.float32).reshape(b, 1, 1, 1)).astype(jnp.float32)
        masks = jnp.broadcast_to(masks, img.shape)
        mean = jdeg.compute_mean_pixel(img, masks, mean_option, mean_area)
        inv = 1.0 - masks
        return inv * mean + masks * img, masks, inv * mean + masks, jnp.broadcast_to(
            mean, img.shape)

    def schedule_shift(key, ratios_t, shape, shift_type, noise_mean=0.0,
                       dtype=jnp.float32, combine_perturbation=False):
        r = ratios_t.astype(jnp.float32)
        if shift_type == "1-d_constant":
            u = jnp.take(jnp.asarray(fx["uniform"]), key[1], axis=0)
            shift = (u * r)[:, None, None, None]
        elif shift_type == "noise_with_perturbation":
            nrm = jnp.take(jnp.asarray(fx["normal"]), key[1], axis=0)
            shift = (noise_mean + nrm) * r[:, None, None, None]
        else:
            raise AssertionError(shift_type)
        return jnp.broadcast_to(shift.astype(dtype), shape)

    return split, randint, degrade_training, schedule_shift


def _port_draws(fx, i, channels):
    return TrainDraws(
        timeindex=torch.from_numpy(fx["timeindex"][i].astype(np.int64)),
        bits=torch.from_numpy(fx["bits"][i].astype(np.int64)),
        mask_uniform=torch.from_numpy(
            fx["mask_u"][i, ..., :channels].transpose(0, 3, 1, 2).copy()),
        uniform=torch.from_numpy(fx["uniform"][i]),
        normal=torch.from_numpy(fx["normal"][i].transpose(0, 3, 1, 2).copy()),
    )


CASES = {
    # mean_shift, log+indexing, adamw + cosine with warmup, EMA, loss weights
    "mean_shift-indexing-adamw-cosine-ema-lossweight": dict(
        method="mean_shift", ddpm_schedule="log", select_degrade_pixel="indexing",
        shift_type="noise_with_perturbation", noise_mean=0.1, optim="adamw",
        lr_scheduler="cosine", lr_warmup_steps=2, use_ema=True, loss_weight_use=True,
        loss_weight_power_base=10.0),
    # base, linear+thresholding, 3-channel masks, channel-wise mean, adam +
    # linear decay, accumulation 2 (EMA and LR advance on sync steps only)
    "base-thresholding-adam-accum2-ema": dict(
        method="base", ddpm_schedule="linear", select_degrade_pixel="thresholding",
        degrade_channel="3-channel", mean_area="channel-wise", optim="adam",
        lr_scheduler="linear", lr_warmup_steps=1, gradient_accumulation_steps=2,
        use_ema=True),
}


@pytest.fixture(scope="module")
def unets():
    return jax_unet(seed=3)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(unets, monkeypatch, case):
    jmodel, jcfg, variables = unets
    cfg = Config(data_size=SIZE, ddpm_num_steps=20, mean_option="degraded_area", lr=1e-3,
                 mixed_precision="no", out_channel=C, **CASES[case])
    accum = cfg.gradient_accumulation_steps
    jsched = jax_build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                cfg.select_degrade_pixel)
    used = jsched.timesteps_for_epoch(0, 10, 1)
    fx = _fixtures(len(used), seed=len(case))
    total = 20

    # --- JAX
    jlr = joptim.build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum,
                                   total, cfg.lr_cycle)
    tx = joptim.build_optimizer(cfg.optim, jlr, 1.0, accum)
    params = jax.tree.map(jnp.asarray, variables)
    state = jstep.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        ema_params=jax.tree.map(jnp.copy, params) if cfg.use_ema else None,
        opt_state=tx.init(params))
    split, randint, degrade, shift = _jax_fakes(fx)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jdeg, "degrade_training", degrade)
        m.setattr(jshift, "schedule_shift", shift)
        jfn = jax.jit(jstep._make_step_impl(jmodel, jsched, cfg, tx, used, jlr))
        j_metrics = []
        for i in range(STEPS):
            state, mt = jfn(state, jnp.asarray(fx["images"][i]), jax.random.PRNGKey(i))
            j_metrics.append({k: float(v) for k, v in mt.items()})

    # --- port
    model = port_unet(jcfg, variables).train()
    lr = build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps * accum, total,
                           cfg.lr_cycle)
    opt = build_optimizer(cfg.optim, model.parameters(), lr, 1.0, accum)
    pstate = create_train_state(model, opt, use_ema=cfg.use_ema)
    step = make_train_step(model, build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                                 cfg.select_degrade_pixel),
                           cfg, opt, used, lr, device="cpu")
    t_metrics = []
    for i in range(STEPS):
        draws = _port_draws(fx, i, C if cfg.degrade_channel == "3-channel" else 1)
        mt = step(pstate, torch.from_numpy(fx["images"][i]), draws=draws)
        assert all(v.dim() == 0 for v in mt.values())
        t_metrics.append({k: float(v) for k, v in mt.items()})

    assert sorted(t_metrics[0]) == sorted(j_metrics[0])
    for key in j_metrics[0]:
        np.testing.assert_allclose([m[key] for m in t_metrics], [m[key] for m in j_metrics],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert pstate.step == STEPS and opt.count == STEPS // accum
    pairs = [("params", model, state.params)]
    if cfg.use_ema:
        pairs.append(("ema", pstate.ema_model, state.ema_params))
    init = weights.state_dict_from_flax(variables, jcfg)
    for name, tmod, jtree in pairs:
        ref = weights.state_dict_from_flax(jax.tree.map(np.asarray, jtree), jcfg)
        got = {k: v.detach() for k, v in tmod.state_dict().items()}
        diff2 = upd2 = 0.0
        loose = total = 0
        for k, r in ref.items():
            d = (got[k] - r).abs()
            assert d.max().item() <= cfg.lr, f"{name} {k}: max |diff| {d.max().item()}"
            loose += int((d > ATOL + RTOL * r.abs()).sum())
            total += r.numel()
            diff2 += float((d ** 2).sum())
            upd2 += float(((r - init[k]) ** 2).sum())
        assert upd2 > 0  # the optimizer moved the parameters
        assert (diff2 / upd2) ** 0.5 <= RTOL, f"{name}: update norm differs by {(diff2 / upd2) ** 0.5}"
        assert loose <= 1e-3 * total, f"{name}: {loose} of {total} entries off"


def _rel(a, b):
    return float(np.linalg.norm(np.ravel(a) - np.ravel(b)) / np.linalg.norm(np.ravel(b)))


def _first_step_jax(jmodel, jcfg, variables, cfg, fx, used, monkeypatch):
    """(loss, gradients in the port's names) of the JAX step's first step."""
    grads = []
    tx = joptim.build_optimizer(cfg.optim, lambda count: cfg.lr, None)

    def update(g, st, params=None):
        jax.debug.callback(lambda t: grads.append(jax.tree.map(np.array, t)), g)
        return tx.update(g, st, params)

    rec = optax.GradientTransformation(tx.init, update)
    params = jax.tree.map(jnp.asarray, variables)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params, ema_params=None,
                             opt_state=rec.init(params))
    jsched = jax_build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                cfg.select_degrade_pixel)
    split, randint, degrade, shift = _jax_fakes(fx)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", split)
        m.setattr(jax.random, "randint", randint)
        m.setattr(jdeg, "degrade_training", degrade)
        m.setattr(jshift, "schedule_shift", shift)
        fn = jax.jit(jstep._make_step_impl(jmodel, jsched, cfg, rec, used))
        _, mt = fn(state, jnp.asarray(fx["images"][0]), jax.random.PRNGKey(0))
        jax.effects_barrier()
    (g,) = grads
    return float(mt["train_loss"]), {k: v.numpy() for k, v in
                                     weights.state_dict_from_flax(g, jcfg).items()}


def _first_step_port(jcfg, variables, cfg, fx, used):
    model = port_unet(jcfg, variables).train()
    opt = build_optimizer(cfg.optim, model.parameters(), lambda count: cfg.lr, None)
    state = create_train_state(model, opt, use_ema=False)
    step = make_train_step(model, build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                                                 cfg.select_degrade_pixel),
                           cfg, opt, used, None, device="cpu")
    mt = step(state, torch.from_numpy(fx["images"][0]), draws=_port_draws(fx, 0, 1))
    return float(mt["train_loss"]), {k: p.grad.numpy().copy()
                                     for k, p in model.named_parameters()}


def test_train_step_bf16_matches_jax(unets, monkeypatch):
    """--mixed_precision bf16: the JAX UNet casts per op (compute dtype bf16,
    fp32 params), the port runs under autocast. The first step's loss and
    every parameter's gradient (no clipping), port bf16 against JAX bf16, in
    relative L2, within 2x the larger of the two sides' own bf16-vs-fp32
    distances. That bound alone cannot fail (the triangle inequality through
    the two fp32 steps, which agree to ~1e-6), so the JAX side's own
    distance is a yardstick too: for the loss and each gradient the port's
    bf16 may stray from its fp32 by at most 2x what JAX's bf16 strays from
    JAX's fp32, and over all gradients together the port's bf16 may stray
    from JAX's bf16 by at most 2x that too. (On the CPU at these shapes:
    1.56e-2 against JAX's own 1.24e-2 and the port's own 1.27e-2 over all
    gradients; per tensor the port's own distance is at most 1.55x JAX's.)
    Whole-model bounds catch casts that degrade much of the model; a cast
    confined to one op (the plain attention's scores, repaired earlier) is
    held at that op, in tests/test_torch_port_switches.py."""
    from masked_diffusion_tpu.models.unet import UNet2D as JaxUNet2D

    jmodel, jcfg, variables = unets
    case = dict(CASES["mean_shift-indexing-adamw-cosine-ema-lossweight"], use_ema=False)
    jsched = jax_build_schedule(case["ddpm_schedule"], 20, SIZE, case["select_degrade_pixel"])
    used = jsched.timesteps_for_epoch(0, 10, 1)
    fx = _fixtures(len(used), seed=5)
    out = {}
    for mp in ("no", "bf16"):
        cfg = Config(data_size=SIZE, ddpm_num_steps=20, mean_option="degraded_area", lr=1e-3,
                     mixed_precision=mp, out_channel=C, **case)
        jm = jmodel if mp == "no" else JaxUNet2D(config=jcfg, dtype=jnp.bfloat16)
        out["jax", mp] = _first_step_jax(jm, jcfg, variables, cfg, fx, used, monkeypatch)
        out["port", mp] = _first_step_port(jcfg, variables, cfg, fx, used)
    np.testing.assert_allclose(out["port", "no"][0], out["jax", "no"][0], rtol=RTOL)

    def distances(i, key=None):
        get = (lambda side, mp: out[side, mp][i]) if key is None else (
            lambda side, mp: out[side, mp][i][key])
        return (_rel(get("port", "bf16"), get("jax", "bf16")),
                _rel(get("jax", "bf16"), get("jax", "no")),
                _rel(get("port", "bf16"), get("port", "no")))

    names = list(out["jax", "no"][1])
    whole = {k: (v[0], np.concatenate([v[1][n].ravel() for n in names]))
             for k, v in out.items()}
    rows = [("loss",) + distances(0)] + [(n,) + distances(1, n) for n in names]
    for name, cross, own_jax, own_port in rows:
        assert own_jax > 0, name  # bf16 changed the JAX step
        assert cross <= 2 * max(own_jax, own_port), (name, cross, own_jax, own_port)
        assert own_port <= 2 * own_jax, (name, cross, own_jax, own_port)
    cross, own_jax, own_port = (_rel(whole["port", "bf16"][1], whole["jax", "bf16"][1]),
                                _rel(whole["jax", "bf16"][1], whole["jax", "no"][1]),
                                _rel(whole["port", "bf16"][1], whole["port", "no"][1]))
    assert cross <= 2 * own_jax, (cross, own_jax, own_port)


# ------------------------------------------------------ trainer and CLI, CPU


def _train_args(workdir, device="cpu", *extra):
    return [
        "--method", "mean_shift", "--data_name", "synthetic", "--data_size", str(SIZE),
        "--data_subset", "True", "--data_subset_num", "16", "--batch_size", "8",
        "--num_epochs", "2", "--save_images_epochs", "2", "--sampling", "momentum",
        "--ddpm_schedule", "log", "--ddpm_num_steps", "20", "--select_degrade_pixel",
        "indexing", "--mean_option", "degraded_area", "--shift_type", "1-d_constant",
        "--sample_num", "4", "--use_wandb", "False", "--block_out_channels", "32,64",
        "--layers_per_block", "1", "--lr", "1e-3", "--lr_warmup_steps", "0",
        "--dir_work", str(workdir), "--device", device, *extra,
    ]


def _stats(out, tag):
    line = [ln for ln in out.splitlines() if ln.startswith(tag + " ")][-1]
    return json.loads(line.split(" ", 1)[1])


def test_cli_trains_on_cpu_then_serves_its_checkpoint(tmp_path, capsys):
    assert port_cli.main(_train_args(tmp_path / "run")) == 0
    stats = _stats(capsys.readouterr().out, "train_stats")
    assert stats["epochs"] == 2 and stats["global_step"] == 4 and stats["device"] == "cpu"
    assert np.isfinite(stats["loss_mean_epoch"]).all()
    (ckpt,) = stats["checkpoints"]  # the cadence saves the last epoch only
    run = os.path.dirname(os.path.dirname(ckpt))
    with open(os.path.join(run, "log", "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    assert [ln["epoch"] for ln in lines] == [0, 1]
    assert all(np.isfinite(ln["train_loss"]) and "lr" in ln for ln in lines)
    assert os.path.basename(ckpt) == "checkpoint-epoch-1"
    for sub in ("unet", "unet_ema"):
        assert os.path.exists(os.path.join(ckpt, sub, weights.WEIGHTS_NAME))
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 1 and meta["global_step"] == 4
    assert meta["items"] == ["unet", "unet_ema", "optimizer"]
    assert meta["unet_config"]["block_out_channels"] == [32, 64]
    assert os.path.exists(os.path.join(ckpt, "history.npz"))
    grids = glob.glob(os.path.join(run, "train", "image", "ema_sample_img", "ema_sample_00001_*.png"))
    assert len(grids) == 2

    # the port's --method sample serves what --method mean_shift trained
    serve = [a if a != "mean_shift" else "sample" for a in _train_args(tmp_path / "serve")]
    assert port_cli.main(serve + ["--test_model_path", ckpt, "--batch_size", "4"]) == 0
    served = _stats(capsys.readouterr().out, "sample_stats")
    assert served["ema"] and served["finite"] and served["images"] == 4


def test_cli_trains_with_the_default_sampling_flags(tmp_path, capsys):
    """No --sampling and no --use_ema: the cadence samples the EMA weights
    with trajectory capture (--sampling base) and writes the result grids,
    11 fields x 4 items of trajectory grids, the train visuals, the loss
    curve and the trajectory means."""
    args = _train_args(tmp_path / "run")
    i = args.index("--sampling")
    del args[i:i + 2]
    assert port_cli.main(args) == 0
    stats = _stats(capsys.readouterr().out, "train_stats")
    (ckpt,) = stats["checkpoints"]
    run = os.path.dirname(os.path.dirname(ckpt))
    image = os.path.join(run, "train", "image")
    assert len(glob.glob(os.path.join(image, "ema_sample_img", "ema_sample_00001_*.png"))) == 2
    traj = glob.glob(os.path.join(image, "sample_all_t", "*_00001_item*.png"))
    assert len(traj) == 44
    from masked_diffusion_tpu_torch.sample.loop import TRAJECTORY_FIELDS

    assert {os.path.basename(p).rsplit("_00001_", 1)[0] for p in traj} == set(TRAJECTORY_FIELDS)
    visuals = {os.path.relpath(p, image) for p in glob.glob(os.path.join(image, "*", "*.png"))
               if "/sample_all_t/" not in p and "/ema_sample_img/" not in p}
    assert len(visuals) == 2 * 10  # global and local grids of the 10 mean-shift tensors
    for name in ("train_image/input", "noisy_image/degraded_img", "shift_input/shift",
                 "shift_noisy/shifted_degrade_img",
                 "predict_image/inverse_shift_reconstructed_img"):
        assert f"{name}_00001_global.png" in visuals and f"{name}_00001_local.png" in visuals
    assert os.path.exists(os.path.join(run, "train", "loss", "loss.png"))
    with open(os.path.join(run, "log", "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    (means,) = [ln for ln in lines if "ema_sample_t_mean" in ln]
    assert means["epoch"] == 1
    for key in ("ema_sample_mean", "ema_sample_t_mean", "ema_sample_0_mean",
                "ema_sample_shift_t_mean", "ema_sample_0_shift_mean"):
        assert np.isfinite(means[key]), key


def test_cli_trains_with_interpolation_shift_and_renders_the_sweep(tmp_path, capsys):
    """--interpolation_shift (refused before the interpolation sampler was
    ported): the cadence renders ema_interpolation_NNNNN.png beside the EMA
    grids; with indexing masks it is refused at construction, before a
    metric or a checkpoint is written."""
    thresholding = ["--ddpm_schedule", "linear", "--select_degrade_pixel", "thresholding"]
    assert port_cli.main(_train_args(tmp_path / "ok", "cpu", *thresholding,
                                     "--interpolation_shift", "0.5")) == 0
    (ckpt,) = _stats(capsys.readouterr().out, "train_stats")["checkpoints"]
    grids = sorted(os.listdir(os.path.join(os.path.dirname(os.path.dirname(ckpt)), "train",
                                           "image", "ema_sample_img")))
    assert grids == ["ema_interpolation_00001.png", "ema_sample_00001_global.png",
                     "ema_sample_00001_local.png"]
    with pytest.raises(ValueError, match="thresholding"):
        port_cli.main(_train_args(tmp_path / "refused", "cpu", "--interpolation_shift", "0.5"))
    assert not glob.glob(str(tmp_path / "refused" / "**" / "metrics.jsonl"), recursive=True)
    assert not glob.glob(str(tmp_path / "refused" / "**" / "checkpoint-epoch-*"), recursive=True)


@pytest.mark.parametrize("extra,match", [
    (["--remat", "true"], "--remat"),
    (["--attention_chunk", "16"], "--attention_chunk"),
    (["--mesh_model", "2"], "WORLD_SIZE is 1"),
    (["--epoch_scan", "true"], "--epoch_scan"),
    (["--tinyhead_attention", "false"], "--tinyhead_attention false"),
])
def test_unported_flags_raise_at_construction(tmp_path, capsys, extra, match):
    """The flags the port refused. --epoch_scan true still raises
    NotImplementedError before any file is written. Tensor parallelism is
    ported: --mesh_model 2 in one process (no process group of 2 ranks)
    raises the ValueError that names WORLD_SIZE, before any file is
    written (tests/test_torch_port_parallel.py runs it on 4 ranks). The
    three model switches now train through the CLI: --remat,
    --attention_chunk 16 (a quarter of the toy model's S = 64) and
    --tinyhead_attention false, the last with --encoder_reuse 2 on the
    cadence's sampler; each writes a checkpoint whose meta.json has no
    switch, served by --method sample without the switch."""
    if match in ("WORLD_SIZE is 1", "--epoch_scan"):
        error = ValueError if match == "WORLD_SIZE is 1" else NotImplementedError
        with pytest.raises(error, match=match):
            port_cli.main(_train_args(tmp_path, "cpu", *extra))
        if match == "WORLD_SIZE is 1":
            assert not any(tmp_path.iterdir())  # refused before the run tree exists
        assert not glob.glob(str(tmp_path / "**" / "metrics.jsonl"), recursive=True)
        assert not glob.glob(str(tmp_path / "**" / "checkpoint-epoch-*"), recursive=True)
        return
    if match == "--tinyhead_attention false":
        extra = extra + ["--encoder_reuse", "2"]
    args = _train_args(tmp_path / "train", "cpu", "--num_epochs", "1", "--save_images_epochs",
                       "1", *extra)
    assert port_cli.main(args) == 0
    stats = _stats(capsys.readouterr().out, "train_stats")
    assert stats["global_step"] == 2 and all(np.isfinite(stats["loss_mean_epoch"]))
    (ckpt,) = stats["checkpoints"]
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)["unet_config"]
    assert {"remat", "attention_chunk", "tinyhead_attention"}.isdisjoint(meta)
    serve = _train_args(tmp_path / "serve", "cpu")
    serve[serve.index("mean_shift")] = "sample"
    assert port_cli.main(serve + ["--test_model_path", ckpt]) == 0
    assert _stats(capsys.readouterr().out, "sample_stats")["finite"]


def test_cli_training_refuses_cuda_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(_train_args(tmp_path, "cuda"))


def test_non_finite_loss_saves_a_post_mortem_and_raises(tmp_path):
    from masked_diffusion_tpu_torch.config import Config
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.train.trainer import Trainer
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    cfg = Config(method="base", data_size=SIZE, batch_size=8, num_epochs=1, use_ema=False,
                 block_out_channels=(32, 64), layers_per_block=1, ddpm_schedule="log",
                 ddpm_num_steps=20)
    data = get_dataset("", "synthetic", SIZE, data_subset=True, num_data=16)
    trainer = Trainer(cfg, data, device="cpu")
    trainer._get_step_fn = lambda used: lambda *a, **k: {"train_loss": torch.tensor(float("nan"))}
    dirs = Dir(task="train", content="c", dir_work=str(tmp_path), method="base")
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train(dirs=dirs)
    with open(os.path.join(dirs.list_dir["checkpoint"], "checkpoint-epoch-0", "meta.json")) as f:
        assert json.load(f)["non_finite_loss"] is True
