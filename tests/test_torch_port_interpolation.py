"""Interpolation sampling: the port's ops and sampler against the JAX
package's, and the trainer's --interpolation_shift cadence on the CPU.

The ops: latent_initial_interpolation for a positive, negative and zero
shift; schedule_shift_interpolation with the clamp active on both sides;
degrade_interpolation_sampling on one injected (1, H, W, 1) field (jax.random
.uniform replaced by a fixture) with a const, a degraded_area and a
non_degraded_area mean (the last falls through to the degraded-area mean).
atol 1e-6, fp32.

The sampler (JAX masked_diffusion_tpu/sample/interpolation.py): jax.random
.split is replaced by a fake whose keys carry the reverse step, so the
fixture uniform hands the JAX loop's degrade op that step's shared field;
the port gets the same field per step through `draws=`. Weights cross
through state_dict_from_flax. Final samples and the grid agree to atol =
rtol = 2e-3 (tests/test_torch_port_sampler.py's) for base_momentum,
momentum and boosting; base_sampling and indexing raise in both.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.config import Config
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.sample import latent as jlatent
from masked_diffusion_tpu.sample.interpolation import (
    make_interpolation_sample_fn as jax_make_interpolation_sample_fn,
)
from masked_diffusion_tpu_torch.ops import degrade as tdeg
from masked_diffusion_tpu_torch.ops import shift as tshift
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.sample import latent as tlatent
from masked_diffusion_tpu_torch.sample.interpolation import make_interpolation_sample_fn
from masked_diffusion_tpu_torch.sample.loop import StepDraws
from tests.test_torch_port_unet import SIZE, jax_unet, port_unet, two_torch_threads  # noqa: F401

N, T, C = 3, 6, 3
OP_ATOL = 1e-6
TOL = 2e-3
_rng = np.random.default_rng(11)
FIELDS = _rng.uniform(size=(T, SIZE, SIZE)).astype(np.float32)  # one field a reverse step


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("shift", [0.5, -0.3, 0.0])
def test_latent_initial_interpolation_matches_jax(shift):
    jl, jmu = jlatent.latent_initial_interpolation(5, C, SIZE, shift)
    tl, tmu = tlatent.latent_initial_interpolation(5, C, SIZE, shift, device="cpu")
    assert tl.shape == (5, SIZE, SIZE, C) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=OP_ATOL, rtol=0)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=OP_ATOL, rtol=0)


def test_schedule_shift_interpolation_matches_jax_with_the_clamp_on_both_sides():
    ratios = np.asarray([0.9, 0.9, 0.2, 0.5], np.float32)
    mu = np.asarray([-0.8, 0.8, 0.0, 0.3], np.float32)
    for c in (1.5, -1.5, 0.4):
        shape = (4, SIZE, SIZE, C)
        j = jshift.schedule_shift_interpolation(jnp.asarray(ratios), jnp.asarray(mu), c, shape)
        t = tshift.schedule_shift_interpolation(torch.from_numpy(ratios), torch.from_numpy(mu),
                                                c, (4, C, SIZE, SIZE))
        assert t.shape == (4, C, SIZE, SIZE)
        np.testing.assert_allclose(t.numpy(), nchw(j), atol=OP_ATOL, rtol=0)
    # c = 1.5: image 1's 1.35 clamps to -mu + r = 0.1 (the upper side);
    # c = -1.5: image 0's -1.35 clamps to -mu - r = -0.1 (the lower side)
    up = tshift.schedule_shift_interpolation(torch.from_numpy(ratios), torch.from_numpy(mu),
                                             1.5, (4, 1, 1, 1)).flatten()
    low = tshift.schedule_shift_interpolation(torch.from_numpy(ratios), torch.from_numpy(mu),
                                              -1.5, (4, 1, 1, 1)).flatten()
    assert up[1].item() == pytest.approx(-0.8 + 0.9) and up[1] < 1.5 * 0.9
    assert low[0].item() == pytest.approx(0.8 - 0.9) and low[0] > -1.5 * 0.9


def _field_uniform(key, shape, *a, **k):
    """jax.random.uniform's stand-in: the fixture field of the key's step."""
    assert tuple(shape) == (1, SIZE, SIZE, 1), shape
    return jnp.asarray(FIELDS)[key[0] - 1][None, :, :, None]


@pytest.mark.parametrize("mean_option", [0.25, "degraded_area", "non_degraded_area"])
def test_degrade_interpolation_sampling_matches_jax(monkeypatch, mean_option):
    rng = np.random.default_rng(3)
    img = rng.uniform(-1, 1, (4, SIZE, SIZE, C)).astype(np.float32)
    amount = np.asarray([0.0, 0.3, 0.7, 1.0], np.float32)  # all kept .. all degraded
    monkeypatch.setattr(jax.random, "uniform", _field_uniform)
    out = jdeg.degrade_interpolation_sampling(jnp.asarray([3, 0], jnp.uint32), jnp.asarray(img),
                                              jnp.asarray(amount), mean_option)
    got = tdeg.degrade_interpolation_sampling(
        torch.from_numpy(nchw(img).copy()), torch.from_numpy(amount), mean_option,
        uniforms=torch.from_numpy(FIELDS[2][None, None].copy()))
    for j, t in zip(out, got):
        assert t.shape == (4, C, SIZE, SIZE)
        np.testing.assert_allclose(t.numpy(), nchw(j), atol=OP_ATOL, rtol=0)
    masks = got[1]
    assert torch.equal(masks[:, :1].expand_as(masks), masks)  # shared by the channels
    assert torch.equal(masks[2:3, 0] <= masks[1:2, 0], torch.ones_like(masks[1:2, 0],
                                                                      dtype=torch.bool))


def fake_split(key, num=2):
    """Keys (reverse step, role): the carried key counts the steps."""
    step = key[0] + 1
    return jnp.stack([jnp.stack([step, jnp.uint32(j)]) for j in range(num)])


@pytest.fixture(scope="module")
def unets():
    return jax_unet(channels=(16, 32), seed=9, jit_init=True)


def _cfg(**over):
    kw = dict(method="mean_shift", data_size=SIZE, ddpm_schedule="linear", ddpm_num_steps=T,
              select_degrade_pixel="thresholding", mean_option="degraded_area",
              mean_area="image-wise", momentum_adaptive="base_momentum", sample_num=N,
              mixed_precision="no", out_channel=C, adaptive_momentum_rate=0.3,
              interpolation_shift=0.5)
    kw.update(over)
    return Config(**kw)


@pytest.mark.parametrize("rule,shift", [("base_momentum", 0.5), ("momentum", -0.4),
                                        ("boosting", 0.5)])
def test_interpolation_sampler_matches_jax(unets, monkeypatch, rule, shift):
    jmodel, jcfg, variables = unets
    cfg = _cfg(momentum_adaptive=rule, interpolation_shift=shift)
    jsched = jax_build_schedule("linear", T, SIZE, "thresholding")
    used = jsched.timesteps_for_epoch(1, 10, 1)
    assert len(used) == T
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", fake_split)
        m.setattr(jax.random, "uniform", _field_uniform)
        jfn = jax_make_interpolation_sample_fn(jmodel, jsched, cfg, used, shift)
        j_out, j_mu = jfn(jax.tree.map(jnp.asarray, variables), jax.random.PRNGKey(0))
        j_out, j_mu = np.asarray(j_out), np.asarray(j_mu)

    fn = make_interpolation_sample_fn(port_unet(jcfg, variables),
                                      build_schedule("linear", T, SIZE, "thresholding"),
                                      cfg, used, shift, device="cpu")

    def draws(i):  # draws(i) serves used[i], walked from the end
        return StepDraws(mask_uniform=torch.from_numpy(FIELDS[T - 1 - i][None, None].copy()))

    t_out, t_mu = fn(draws=draws)
    t_out = t_out.numpy()
    assert t_out.shape == (N, SIZE, SIZE, C) and np.isfinite(t_out).all()
    np.testing.assert_allclose(t_mu.numpy(), j_mu, atol=OP_ATOL)
    latent = np.broadcast_to(j_mu[:, None, None, None], t_out.shape)
    assert np.abs(j_out - latent).max() > 1e-2  # the loop moved the sample
    np.testing.assert_allclose(t_out, j_out, atol=TOL, rtol=TOL)
    # its own draws: the same seed repeats, the field is shared by the batch
    a, _ = fn(torch.Generator().manual_seed(1))
    b, _ = fn(torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.isfinite(a).all()


@pytest.mark.parametrize("over,match", [
    (dict(momentum_adaptive="base_sampling"), "base_sampling"),
    (dict(select_degrade_pixel="indexing", ddpm_schedule="log"), "thresholding"),
])
def test_unsupported_modes_raise_as_jax(unets, over, match):
    jmodel, jcfg, variables = unets
    cfg = _cfg(**over)
    used = np.arange(1, T + 1)
    sched = jax_build_schedule(cfg.ddpm_schedule, T, SIZE, cfg.select_degrade_pixel)
    with pytest.raises(ValueError, match=match):
        jax_make_interpolation_sample_fn(jmodel, sched, cfg, used, 0.5)
    with pytest.raises(ValueError, match=match):
        make_interpolation_sample_fn(port_unet(jcfg, variables),
                                     build_schedule(cfg.ddpm_schedule, T, SIZE,
                                                    cfg.select_degrade_pixel),
                                     cfg, used, 0.5, device="cpu")


def test_trainer_renders_the_interpolation_sweep_on_the_cadence(tmp_path):
    """--interpolation_shift through the trainer: the cadence writes
    ema_interpolation_NNNNN.png with EMA on and with it off (the raw
    weights), and an indexing run is refused at construction."""
    from masked_diffusion_tpu_torch.config import Config as TConfig
    from masked_diffusion_tpu_torch.data.datasets import get_dataset
    from masked_diffusion_tpu_torch.train.trainer import Trainer
    from masked_diffusion_tpu_torch.utils.dirs import Dir

    data = get_dataset("", "synthetic", SIZE, data_subset=True, num_data=8)
    base = dict(method="mean_shift", data_size=SIZE, batch_size=4, num_epochs=1,
                block_out_channels=(16, 32), layers_per_block=1, ddpm_schedule="linear",
                ddpm_num_steps=T, select_degrade_pixel="thresholding",
                mean_option="degraded_area", shift_type="1-d_constant", sampling="momentum",
                sample_num=3, sample_latent_shape="uniform", interpolation_shift=0.5,
                lr_warmup_steps=0)
    for use_ema in (True, False):
        cfg = TConfig(**base, use_ema=use_ema)
        dirs = Dir("train", "t", str(tmp_path / f"ema{use_ema}"), data_name="synthetic",
                   method="mean_shift", date="d", time="t")
        trainer = Trainer(cfg, data, device="cpu")
        trainer.train(dirs=dirs)
        pngs = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(dirs.list_dir["ema_sample_img"], "*.png")))
        assert "ema_interpolation_00000.png" in pngs, pngs
        assert ("ema_sample_00000_global.png" in pngs) == use_ema
    with pytest.raises(ValueError, match="thresholding"):
        Trainer(TConfig(**{**base, "select_degrade_pixel": "indexing",
                           "ddpm_schedule": "log"}), data, device="cpu")
    with pytest.raises(ValueError, match="base_sampling"):
        Trainer(TConfig(**base, momentum_adaptive="base_sampling"), data, device="cpu")
