"""Port schedule and shift ops against the JAX package.

Tables, degrade amounts, shift ratios and the curriculum must equal the JAX
ones exactly; couplings raise the same errors; each shift family, fed the
draws the JAX function makes from the same key, gives the JAX shift field
(NCHW in the port, NHWC in JAX).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops import schedule as jsched
from masked_diffusion_tpu.ops import shift as jshift
from masked_diffusion_tpu_torch.ops import schedule as tsched
from masked_diffusion_tpu_torch.ops import shift as tshift

FAMILIES = [
    ("linear", 1000, 64, "thresholding"),
    ("log", 4096, 64, "indexing"),
    ("log", 300, 32, "thresholding"),
    ("exponential", 500, 64, "thresholding"),
    ("sigmoid", 4096, 64, "indexing"),
    ("sigmoid", 200, 16, "indexing"),
]


@pytest.mark.parametrize("name,steps,size,select", FAMILIES)
def test_schedule_matches_jax(name, steps, size, select):
    j = jsched.build_schedule(name, steps, size, select)
    t = tsched.build_schedule(name, steps, size, select)
    assert t.num_steps == j.num_steps and t.image_size == j.image_size
    np.testing.assert_array_equal(t.table, j.table)
    np.testing.assert_array_equal(t.ratios, j.ratios)
    ts = np.arange(1, j.num_steps + 1, dtype=np.int32)
    np.testing.assert_array_equal(
        t.degrade_amount(torch.from_numpy(ts)).numpy(),
        np.asarray(j.degrade_amount(jnp.asarray(ts))),
    )
    np.testing.assert_array_equal(
        t.shift_ratio(torch.from_numpy(ts)).numpy(),
        np.asarray(j.shift_ratio(jnp.asarray(ts))),
    )
    for epoch, length, scale in ((0, 10, 1), (1, 10, 1), (0, 10, 3), (4, 10, 3), (9, 10, 3)):
        np.testing.assert_array_equal(
            t.timesteps_for_epoch(epoch, length, scale),
            j.timesteps_for_epoch(epoch, length, scale),
        )


def test_log_4096_dedups_to_1421_steps():
    assert tsched.build_schedule("log", 4096, 64, "indexing").num_steps == 1421


@pytest.mark.parametrize("name,select,steps,size", [
    ("linear", "indexing", 10, 8),
    ("exponential", "indexing", 10, 8),
    ("sigmoid", "thresholding", 10, 8),
    ("linear", "bogus", 10, 8),
    ("cosine", "indexing", 10, 8),
    ("log", "indexing", 100, 8),  # more steps than pixels
])
def test_invalid_couplings_raise_the_same_errors(name, select, steps, size):
    with pytest.raises(ValueError) as jerr:
        jsched.build_schedule(name, steps, size, select)
    with pytest.raises(ValueError) as terr:
        tsched.build_schedule(name, steps, size, select)
    assert str(terr.value) == str(jerr.value)


B, H, W, C = 3, 4, 5, 3


def _jax_draws(key, shift_type, combine):
    """The draws ops/shift.py:62-89 makes from `key`, in the port's NCHW."""
    def nchw(a):
        return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())

    if shift_type == "1-d_constant":
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (B,), minval=-1.0, maxval=1.0))), None
    if shift_type == "3-d_constant":
        return nchw(jax.random.uniform(key, (B, 1, 1, C), minval=-1.0, maxval=1.0)), None
    if shift_type == "noise_reduction":
        return None, nchw(jax.random.normal(key, (B, H, W, 1)))
    if shift_type == "noise_std_reduction":
        return None, nchw(jax.random.normal(key, (B, H, W, C)))
    if shift_type == "noise_with_perturbation":
        k_noise, k_pert = jax.random.split(key)
        normal = nchw(jax.random.normal(k_noise, (B, H, W, C)))
        uniform = nchw(jax.random.uniform(k_pert, (B, 1, 1, 1), minval=-1.0, maxval=1.0))
        return uniform, normal
    return None, None


@pytest.mark.parametrize("shift_type", tshift.SHIFT_TYPES)
@pytest.mark.parametrize("noise_mean,combine", [(0.0, False), (0.3, True)])
def test_shift_families_match_jax(shift_type, noise_mean, combine):
    key = jax.random.PRNGKey(11)
    ratios = np.asarray([0.1, 0.5, 0.9], np.float32)
    expect = np.asarray(jshift.schedule_shift(
        key, jnp.asarray(ratios), (B, H, W, C), shift_type, noise_mean,
        combine_perturbation=combine,
    ))
    uniform, normal = _jax_draws(key, shift_type, combine)
    got = tshift.shift_from_draws(
        shift_type, torch.from_numpy(ratios), (B, C, H, W), uniform, normal,
        noise_mean=noise_mean, combine_perturbation=combine,
    )
    assert tuple(got.shape) == (B, C, H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), expect, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shift_type", tshift.SHIFT_TYPES)
def test_generator_form_draws_the_declared_shapes(shift_type):
    gen = torch.Generator().manual_seed(0)
    ratios = torch.tensor([0.2, 0.4, 0.6])
    shift = tshift.schedule_shift(gen, ratios, (B, C, H, W), shift_type)
    assert tuple(shift.shape) == (B, C, H, W) and torch.isfinite(shift).all()
    again = tshift.schedule_shift(torch.Generator().manual_seed(0), ratios, (B, C, H, W),
                                  shift_type)
    torch.testing.assert_close(shift, again, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tshift.shift_from_draws("bogus", ratios, (B, C, H, W))
