"""The sampling slice as a whole: the port's reverse loop against the JAX
loop's fused branch, and the port's CLI end to end on the CPU.

The JAX make_sample_fn runs with MDT_PALLAS_FUSED=1, with its
fused_degrade_update replaced by a stand-in that applies the JAX row math
(fused_rows) to fixed injected bit fields, and schedule_shift by a fixture on
fixed draws — the pattern of tests/test_sampler_parity.py:59-120. The port's
make_sample_fn runs on the CPU (its plain versions) with the same bits and
draws through `draws=`. Weights cross through state_dict_from_flax. Final
samples agree to atol = rtol = 2e-3 (tests/test_sampler_parity.py:303).
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config
from masked_diffusion_tpu.io import export_torch
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.sample import make_sample_fn as jax_make_sample_fn
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.sample.loop import StepDraws, make_sample_fn
from tests.test_torch_port_unet import SIZE, jax_unet, port_unet, two_torch_threads  # noqa: F401

N, T, C = 2, 5, 3
HW = SIZE * SIZE
_rng = np.random.default_rng(42)
BITS_T = _rng.integers(0, 2**32, size=(N, HW), dtype=np.uint64).astype(np.uint32)
BITS_N = _rng.integers(0, 2**32, size=(N, HW), dtype=np.uint64).astype(np.uint32)
BITS_N[1] &= np.uint32(0xF0000000)  # tied top bits in one image
UNIFORM = _rng.uniform(-1.0, 1.0, size=(N,)).astype(np.float32)
NORMAL = _rng.normal(size=(N, SIZE, SIZE, C)).astype(np.float32)  # NHWC


def fake_fused_degrade_update(key, sample_t, sample_0, amount_t, amount_next, *,
                              select, mean_mode, mean_value=0.0,
                              rule="base_momentum", interpret=False):
    """The TPU kernel's math (fused_rows) on the fixed bit fields."""
    b, h, w, c = sample_t.shape
    rows = lambda x: x.transpose(0, 3, 1, 2).reshape(b, c * h * w)  # noqa: E731
    out, mask_n = jfd.fused_rows(
        jnp.asarray(BITS_T), jnp.asarray(BITS_N), rows(sample_t), rows(sample_0),
        jnp.asarray(amount_t, jnp.float32).reshape(b, 1),
        jnp.asarray(amount_next, jnp.float32).reshape(b, 1),
        channels=c, select=select, mean_mode=mean_mode, mean_value=mean_value, rule=rule,
    )
    new = out.reshape(b, c, h, w).transpose(0, 2, 3, 1)
    return new, jnp.broadcast_to(mask_n.reshape(b, h, w, 1), (b, h, w, c))


def fixture_shift(key, ratios_t, shape, shift_type, noise_mean=0.0, dtype=jnp.float32,
                  combine_perturbation=False):
    """ops/shift.py's formulas on the fixed draws."""
    r = ratios_t.astype(jnp.float32)
    if shift_type == "1-d_constant":
        shift = (jnp.asarray(UNIFORM) * r)[:, None, None, None]
    elif shift_type == "noise_with_perturbation":
        shift = (noise_mean + jnp.asarray(NORMAL)) * r[:, None, None, None]
    else:
        raise AssertionError(shift_type)
    return jnp.broadcast_to(shift.astype(dtype), shape)


def port_draws(i):
    return StepDraws(
        bits=torch.from_numpy(np.stack([BITS_T, BITS_N]).astype(np.int64)),
        uniform=torch.from_numpy(UNIFORM),
        normal=torch.from_numpy(NORMAL.transpose(0, 3, 1, 2).copy()),
    )


@pytest.fixture(scope="module")
def unets():
    return jax_unet(seed=5)


@pytest.mark.parametrize("rule", ["base_momentum", "base_sampling"])
@pytest.mark.parametrize("sched,select,shift_type", [
    ("linear", "thresholding", "1-d_constant"),
    ("log", "indexing", "noise_with_perturbation"),
])
def test_reverse_loop_matches_jax_fused_branch(unets, monkeypatch, sched, select,
                                               shift_type, rule):
    jmodel, jcfg, variables = unets
    cfg = Config(
        method="sample", data_size=SIZE, ddpm_schedule=sched, ddpm_num_steps=T,
        select_degrade_pixel=select, degrade_channel="1-channel",
        mean_option="degraded_area", mean_area="image-wise", shift_type=shift_type,
        noise_mean=0.1, momentum_adaptive=rule, sampling_mask_dependency="independent",
        mixed_precision="no", out_channel=C,
    )
    jsched = jax_build_schedule(sched, T, SIZE, select)
    used = jsched.timesteps_for_epoch(1, 10, 1)
    latent = np.broadcast_to(
        np.asarray([0.2, -0.3], np.float32)[:, None, None, None], (N, SIZE, SIZE, C)
    ).copy()

    monkeypatch.setenv("MDT_PALLAS_FUSED", "1")
    monkeypatch.setattr(jfd, "fused_degrade_update", fake_fused_degrade_update)
    monkeypatch.setattr(jshift, "schedule_shift", fixture_shift)
    jfn = jax_make_sample_fn(jmodel, jsched, cfg, used)
    j_out = np.asarray(jfn(jax.tree.map(jnp.asarray, variables), jnp.asarray(latent),
                           jax.random.PRNGKey(0)))

    fn = make_sample_fn(port_unet(jcfg, variables), build_schedule(sched, T, SIZE, select),
                        cfg, used, device="cpu")
    t_out = fn(torch.from_numpy(latent), draws=port_draws).numpy()
    assert t_out.shape == (N, SIZE, SIZE, C)
    assert np.isfinite(j_out).all() and np.isfinite(t_out).all()
    assert np.abs(j_out - latent).max() > 1e-2  # the loop moved the sample
    np.testing.assert_allclose(t_out, j_out, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("override,mode", [
    (dict(momentum_adaptive="momentum"), "momentum_adaptive=momentum"),
    (dict(sampling_mask_dependency="dependent_prev"), "sampling_mask_dependency"),
    (dict(degrade_channel="3-channel"), "degrade_channel=3-channel"),
    (dict(mean_option="non_degraded_area"), "mean_option=non_degraded_area"),
    (dict(mean_area="channel-wise"), "mean_area=channel-wise"),
    (dict(encoder_reuse=2), "encoder_reuse=2"),
])
def test_unported_modes_raise_naming_the_mode(unets, override, mode):
    _, jcfg, variables = unets
    cfg = Config(data_size=SIZE, ddpm_schedule="linear", ddpm_num_steps=T,
                 select_degrade_pixel="thresholding", mean_option="degraded_area")
    sched = build_schedule("linear", T, SIZE, "thresholding")
    model = port_unet(jcfg, variables)
    used = np.arange(1, T + 1)
    with pytest.raises(NotImplementedError, match=mode):
        make_sample_fn(model, sched, cfg.replace(**override), used, device="cpu")
    with pytest.raises(NotImplementedError, match="capture_trajectory"):
        make_sample_fn(model, sched, cfg.replace(capture_trajectory=True), used, device="cpu")


def _export_checkpoint(tmp_path, variables, jcfg):
    """A JAX UNet written in the export layout by the JAX exporter."""
    ckpt = tmp_path / "checkpoint-epoch-0"
    sd = export_torch.state_dict_from_params(variables, jcfg)
    export_torch._write_pretrained(
        str(ckpt / "unet"), sd, export_torch.diffusers_config_from_unet(jcfg)
    )
    return str(ckpt)


def _cli_args(ckpt, workdir, device):
    return [
        "--method", "sample", "--test_model_path", ckpt, "--data_name", "synthetic",
        "--data_size", str(SIZE), "--data_subset", "True", "--data_subset_num", "16",
        "--block_out_channels", "32,64", "--layers_per_block", "1",
        "--batch_size", "2", "--sample_num", "3", "--ddpm_schedule", "log",
        "--ddpm_num_steps", "6", "--select_degrade_pixel", "indexing",
        "--mean_option", "degraded_area", "--use_wandb", "False",
        "--dir_work", str(workdir), "--device", device,
    ]


def test_cli_samples_on_cpu_from_an_exported_checkpoint(unets, tmp_path, capsys):
    _, jcfg, variables = unets
    ckpt = _export_checkpoint(tmp_path, variables, jcfg)
    assert port_cli.main(_cli_args(ckpt, tmp_path / "run", "cpu")) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("sample_stats ")]
    stats = json.loads(line[-1].split(" ", 1)[1])
    assert stats["images"] == 3 and stats["batches"] == 2 and stats["finite"]
    assert stats["steps"] == 6 and stats["device"] == "cpu" and not stats["ema"]
    pngs = glob.glob(os.path.join(stats["out_dir"], "*.png"))
    assert len(pngs) == 3 + 2


def test_cli_never_carries_on_without_cuda(unets, tmp_path):
    _, jcfg, variables = unets
    ckpt = _export_checkpoint(tmp_path, variables, jcfg)
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(_cli_args(ckpt, tmp_path / "run", "cuda"))
    with pytest.raises(SystemExit, match="not yet ported"):
        port_cli.main(_cli_args(ckpt, tmp_path / "run", "cpu")[2:] + ["--method", "test"])
