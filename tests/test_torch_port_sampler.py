"""The sampling slice as a whole: the port's reverse loop against the JAX
loop, on both of its branches, and the port's CLI end to end on the CPU.

Fused branch: the JAX make_sample_fn runs with MDT_PALLAS_FUSED=1, with its
fused_degrade_update replaced by a stand-in that applies the JAX row math
(fused_rows) to fixed injected bit fields, and schedule_shift by a fixture
on fixed draws — the pattern of tests/test_sampler_parity.py:59-120. The
port's make_sample_fn runs on the CPU (its plain versions) with the same
bits and draws through `draws=`.

Plain branch (the JAX loop's non-fused branch, loop.py:292-383; the JAX
gate is off on the CPU): jax.random.split is replaced by a fake whose keys
carry (reverse step, role), so the fixtures monkeypatched into the JAX
degrade ops (generate_masks, nested_threshold_masks) and schedule_shift
return that step's draws for t or t-1: exact-k masks from uint32 bits
(masks_from_uniforms on the composite keys the port's kernel ranks),
thresholding masks from uniforms whose first channel is the top 24 bits of
the same bits (the fused kernel's thresholding draw, so modes the port runs
fused see the same masks). The port gets the same draws per step through
`draws=`. Nothing of the JAX package is edited.

Weights cross through state_dict_from_flax. Final samples, and with capture
all 11 fields (through sample/loop.trajectory_images) and the 4 means,
agree to atol = rtol = 2e-3 (tests/test_sampler_parity.py:303).
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
from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.sample import make_sample_fn as jax_make_sample_fn
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.sample.loop import (
    TRAJECTORY_FIELDS,
    TRAJECTORY_MEANS,
    StepDraws,
    make_sample_fn,
    trajectory_images,
)
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


# ------------------------------------------------------------ plain branch
# per reverse step (row 0 = the first, t = T) and role (0: t, 1: t-1)
R = T
_prng = np.random.default_rng(7)
P_BITS = _prng.integers(0, 2**32, size=(R, 2, N, HW), dtype=np.uint64).astype(np.uint32)
P_BITS[:, :, 1] &= np.uint32(0xF0000000)  # tied top bits in one image
_LANE = max(1, (HW - 1).bit_length())
P_KEYS = (P_BITS & np.uint32((0xFFFFFFFF << _LANE) & 0xFFFFFFFF)) | np.arange(HW, dtype=np.uint32)
P_U = _prng.uniform(size=(R, 2, N, SIZE, SIZE, C)).astype(np.float32)
P_U[..., 0] = ((P_BITS >> 8).astype(np.float32) / 16777216.0).reshape(R, 2, N, SIZE, SIZE)
P_UNIFORM = _prng.uniform(-1.0, 1.0, size=(R, N)).astype(np.float32)
P_NORMAL = _prng.normal(size=(R, N, SIZE, SIZE, C)).astype(np.float32)


def fake_split(key, num=2):
    """Keys (reverse step, role): the carried key counts the steps; the
    loop's k_shift, k_deg_t and k_deg_next get roles 1, 2 and 3."""
    step = key[0] + 1
    return jnp.stack([jnp.stack([step, jnp.uint32(j)]) for j in range(num)])


def _row_role(key):
    return key[0] - 1, key[1] - 2


def fixture_generate_masks(key, img, amount, select_degrade_pixel, degrade_channel,
                           mesh=None):
    b, h, w, c = img.shape
    row, role = _row_role(key)
    if select_degrade_pixel == "indexing":
        keys = jnp.asarray(P_KEYS)[row, role]
        masks = jdeg.masks_from_uniforms(keys, amount).reshape(b, h, w, 1)
    else:
        u = jnp.asarray(P_U)[row, role][..., : c if degrade_channel == "3-channel" else 1]
        masks = (u > amount.astype(jnp.float32).reshape(b, 1, 1, 1)).astype(jnp.float32)
    return jnp.broadcast_to(masks, img.shape)


def fixture_nested_masks(key, batch, height, width, channels, ratios_a, ratios_b,
                         per_channel):
    row, _ = _row_role(key)
    u = jnp.asarray(P_U)[row, 0][..., : channels if per_channel else 1]
    return tuple((u > r.astype(jnp.float32).reshape(batch, 1, 1, 1)).astype(jnp.float32)
                 for r in (ratios_a, ratios_b))


def fixture_step_shift(key, ratios_t, shape, shift_type, noise_mean=0.0, dtype=jnp.float32,
                       combine_perturbation=False):
    row, _ = _row_role(key)
    r = ratios_t.astype(jnp.float32)
    if shift_type == "1-d_constant":
        shift = (jnp.asarray(P_UNIFORM)[row] * r)[:, None, None, None]
    elif shift_type == "noise_with_perturbation":
        shift = (noise_mean + jnp.asarray(P_NORMAL)[row]) * r[:, None, None, None]
    else:
        raise AssertionError(shift_type)
    return jnp.broadcast_to(shift.astype(dtype), shape)


def plain_draws(n_steps, channels):
    def draws(i):
        row = n_steps - 1 - i  # draws(i) serves used[i], walked from the end
        return StepDraws(
            bits=torch.from_numpy(P_BITS[row].astype(np.int64)),
            mask_uniform=torch.from_numpy(
                P_U[row, ..., :channels].transpose(0, 1, 4, 2, 3).copy()),
            uniform=torch.from_numpy(P_UNIFORM[row]),
            normal=torch.from_numpy(P_NORMAL[row].transpose(0, 3, 1, 2).copy()),
        )
    return draws


def _plain_cell(unets, monkeypatch, capture_items=0, **modes):
    """Both loops on one mode and the same per-step draws. Returns (JAX
    result, port result, latent): sample_0, or with capture_items > 0
    (sample_0, trajectory) of each."""
    jmodel, jcfg, variables = unets
    kw = dict(method="sample", data_size=SIZE, ddpm_schedule="linear", ddpm_num_steps=T,
              select_degrade_pixel="thresholding", degrade_channel="1-channel",
              mean_option="degraded_area", mean_area="image-wise", shift_type="1-d_constant",
              noise_mean=0.1, momentum_adaptive="base_momentum",
              sampling_mask_dependency="independent", mixed_precision="no", out_channel=C,
              adaptive_momentum_rate=0.3)
    kw.update(modes)
    if kw["select_degrade_pixel"] == "indexing":
        kw["ddpm_schedule"] = "log"
    cfg = Config(**kw)
    jsched = jax_build_schedule(cfg.ddpm_schedule, T, SIZE, cfg.select_degrade_pixel)
    used = jsched.timesteps_for_epoch(1, 10, 1)
    assert 1 < len(used) <= R
    latent = np.random.default_rng(3).uniform(-1, 1, size=(N, SIZE, SIZE, C)).astype(np.float32)
    capture = capture_items > 0

    monkeypatch.delenv("MDT_PALLAS_FUSED", raising=False)
    with monkeypatch.context() as m:
        m.setattr(jax.random, "split", fake_split)
        m.setattr(jdeg, "generate_masks", fixture_generate_masks)
        m.setattr(jdeg, "nested_threshold_masks", fixture_nested_masks)
        m.setattr(jshift, "schedule_shift", fixture_step_shift)
        jfn = jax_make_sample_fn(jmodel, jsched, cfg, used, capture_trajectory=capture,
                                 capture_items=capture_items)
        j_out = jfn(jax.tree.map(jnp.asarray, variables), jnp.asarray(latent),
                    jax.random.PRNGKey(0))
        j_out = jax.tree.map(np.asarray, j_out)

    fn = make_sample_fn(port_unet(jcfg, variables),
                        build_schedule(cfg.ddpm_schedule, T, SIZE, cfg.select_degrade_pixel),
                        cfg, used, device="cpu", capture_trajectory=capture,
                        capture_items=capture_items)
    channels = C if cfg.degrade_channel == "3-channel" else 1
    t_out = fn(torch.from_numpy(latent), draws=plain_draws(len(used), channels))
    return j_out, t_out, latent


def _assert_samples_close(j_out, t_out, latent):
    t_out = t_out.numpy()
    assert t_out.shape == (N, SIZE, SIZE, C)
    assert np.isfinite(j_out).all() and np.isfinite(t_out).all()
    assert np.abs(j_out - latent).max() > 1e-2  # the loop moved the sample
    np.testing.assert_allclose(t_out, j_out, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("dependency", ["independent", "dependent_prev", "dependent_t"])
@pytest.mark.parametrize("rule", ["base_sampling", "base_momentum", "momentum", "boosting"])
def test_reverse_loop_matches_jax_plain_branch(unets, monkeypatch, dependency, rule):
    """The dependency x rule grid at thresholding (tests/test_sampler_parity.py:
    306-315). Independent base_sampling/base_momentum run the port's fused
    branch against the JAX non-fused one on the same masks."""
    _assert_samples_close(*_plain_cell(unets, monkeypatch, sampling_mask_dependency=dependency,
                                       momentum_adaptive=rule))


# the modes the port refused before its plain branch, each now held against JAX
ONCE_REFUSED = {
    "momentum_adaptive=momentum": dict(momentum_adaptive="momentum",
                                       select_degrade_pixel="indexing"),
    "sampling_mask_dependency": dict(sampling_mask_dependency="dependent_prev",
                                     momentum_adaptive="boosting",
                                     select_degrade_pixel="indexing"),
    "degrade_channel=3-channel": dict(degrade_channel="3-channel",
                                      sampling_mask_dependency="dependent_t"),
    "mean_option=non_degraded_area": dict(mean_option="non_degraded_area",
                                          select_degrade_pixel="indexing",
                                          sampling_mask_dependency="dependent_prev"),
    "mean_area=channel-wise": dict(mean_area="channel-wise", degrade_channel="3-channel",
                                   momentum_adaptive="momentum",
                                   shift_type="noise_with_perturbation"),
}


@pytest.mark.parametrize("mode", sorted(ONCE_REFUSED))
def test_once_unported_modes_match_jax(unets, monkeypatch, mode):
    _assert_samples_close(*_plain_cell(unets, monkeypatch, **ONCE_REFUSED[mode]))


@pytest.mark.parametrize("modes", [
    dict(select_degrade_pixel="indexing", momentum_adaptive="base_momentum"),
    dict(sampling_mask_dependency="dependent_t", momentum_adaptive="momentum",
         degrade_channel="3-channel", mean_area="channel-wise"),
    dict(sampling_mask_dependency="dependent_prev", momentum_adaptive="boosting",
         select_degrade_pixel="indexing", mean_option="non_degraded_area"),
], ids=["independent-base_momentum-indexing", "dependent_t-momentum-3-channel",
        "dependent_prev-boosting-indexing"])
def test_trajectory_capture_matches_jax(unets, monkeypatch, modes):
    """All 11 captured fields of the first k = 1 image (JAX's flattened
    layout through trajectory_images) and the 4 full-batch means."""
    (j0, jtraj), (t0, ttraj), latent = _plain_cell(unets, monkeypatch, capture_items=1,
                                                   **modes)
    _assert_samples_close(j0, t0, latent)
    n = jtraj["sample_t"].shape[0]
    assert set(ttraj) == set(TRAJECTORY_FIELDS) | {"means"}
    for name in TRAJECTORY_FIELDS:
        got = ttraj[name].numpy()
        assert got.shape == (n, 1, SIZE, SIZE, C), name
        np.testing.assert_allclose(got, trajectory_images(jtraj[name], SIZE, SIZE, C),
                                   atol=2e-3, rtol=2e-3, err_msg=name)
    np.testing.assert_array_equal(ttraj["sample_t"][0, 0].numpy(), latent[0])
    for name in TRAJECTORY_MEANS:
        got = ttraj["means"][name].numpy()
        assert got.shape == (n,)
        np.testing.assert_allclose(got, jtraj["means"][name], atol=2e-3, rtol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("select", ["indexing", "thresholding"])
def test_plain_branch_draws_from_its_generators(unets, select):
    """Without draws the plain branch takes its masks from the call's
    generator: the same seed repeats bitwise, another differs; captured
    exact-k masks hold the schedule's count of degraded pixels; draws
    lacking the masks' field are refused."""
    _, jcfg, variables = unets
    sched_name = "log" if select == "indexing" else "linear"
    cfg = Config(data_size=SIZE, ddpm_schedule=sched_name, ddpm_num_steps=T,
                 select_degrade_pixel=select, momentum_adaptive="boosting",
                 mean_option="degraded_area", shift_type="1-d_constant", out_channel=C)
    sched = build_schedule(sched_name, T, SIZE, select)
    used = sched.timesteps_for_epoch(1, 10, 1)
    fn = make_sample_fn(port_unet(jcfg, variables), sched, cfg, used, device="cpu",
                        capture_trajectory=True, capture_items=N)
    latent = torch.zeros(N, SIZE, SIZE, C)
    a, ta = fn(latent, torch.Generator().manual_seed(1))
    b, _ = fn(latent, torch.Generator().manual_seed(1))
    c, _ = fn(latent, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()
    if select == "indexing":
        amounts = sched.degrade_amount(torch.as_tensor(used[::-1].copy())).numpy()
        degraded = (1.0 - ta["degrade_mask_t"][..., 0]).sum(dim=(2, 3)).numpy()
        np.testing.assert_array_equal(degraded, np.broadcast_to(amounts[:, None], degraded.shape))
    with pytest.raises(ValueError, match="mask draws"):
        fn(latent, draws=lambda i: StepDraws(uniform=torch.zeros(N)))


@pytest.mark.parametrize("override,mode", [
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
    with pytest.raises(NotImplementedError, match=mode):
        make_sample_fn(model, sched, cfg.replace(**override), used, device="cpu",
                       capture_trajectory=True)
    with pytest.raises(ValueError, match="momentum_adaptive"):
        make_sample_fn(model, sched, cfg.replace(momentum_adaptive="bogus"), used, device="cpu")


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
    with pytest.raises(SystemExit, match="unknown --method"):
        port_cli.main(_cli_args(ckpt, tmp_path / "run", "cpu")[2:] + ["--method", "bogus"])
