"""The port at the flagship's full width against the JAX package's numbers.

tests/data/jax_full_width.npz is what the JAX package computes on the CPU
(tests/jax_full_width.py; tests/test_torch_port_full_width_reference.py
holds the file to a recomputation) for the flagship (6 levels of
(128, 128, 256, 256, 512, 512), 2 layers a block, 113.7M params) and
CelebA-HQ's topology (--num_attention 5) at 64x64 and batch 2, with the
seeded weights of io/weights.seeded_state_dict. Here the port's plain
versions compute the same cases on the CPU through
masked_diffusion_tpu_torch/tools/full_width.py, which chip_smoke.py phase 30
runs on the card through the kernels. Tolerances (relative L2 unless
stated; measured on the CPU in brackets):

- forward, fp32: within FWD_RTOL = 1e-5 (flagship 1.36e-6, CelebA-HQ
  1.48e-6). bf16 (JAX compute dtype bf16 with fp32 params, the port under
  autocast): within 2x JAX's own bf16-vs-fp32 distance, as is the port's
  own (flagship 1.70e-2 apart, own 1.27e-2 JAX, 1.35e-2 port; CelebA-HQ
  1.74e-2, 1.29e-2, 1.43e-2).
- one train step (AdamW + cosine, clip 1.0, EMA), both bench modes: fp32
  loss within 2e-3 (3.9e-7, 1.1e-7), the clipped gradient's projections
  within GRAD_RTOL = 1e-4 (2.9e-6, 5.9e-6), the update's within 2e-3
  (6.6e-5, 1.6e-4: Adam's first step turns gradients near zero into moves
  of up to one LR); bf16 as tests/test_torch_port_train.py's bf16 test,
  the loss and each of the 450 parameters' gradients and the whole
  gradient (full_width.py's docstring has the rule and why 64 projections).
- three reverse steps from t = T, fused branch, both bench modes:
  sample_t within atol = rtol = 2e-3 elementwise (at most 0.06 of it).

Planted faults the comparison catches and toy widths cannot reach: a
GroupNorm eps 100x in the plain version (1.21e-3 from JAX's fp32 forward),
and the two same-shaped skips of up block 1 (level 4, 4x4, 512 channels)
taken in the wrong order (2.65e-2): a 2-level toy has one skip of each
shape at a level.
"""

import os

import numpy as np
import pytest
import torch

from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models import unet as unet_mod
from masked_diffusion_tpu_torch.ops import groupnorm
from masked_diffusion_tpu_torch.tools import full_width as fw
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def ref():
    return fw.load()


@pytest.fixture(scope="module")
def flagship():
    return fw.seeded_model(fw.MODELS["flagship"])


def _quiet(msg):
    pass


def test_reference_file_holds_the_seeded_inputs(ref):
    """The file is small, holds every case's arrays and nothing else, and
    its inputs are full_width.inputs(), the seeds' numbers, bitwise."""
    assert os.path.getsize(fw.PATH) < 2 * 2**20
    assert set(ref) == set(fw.inputs()) | set(fw.output_keys())
    for key, value in fw.inputs().items():
        assert ref[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ref[key], value, err_msg=key)


def test_seeded_weights_cross_both_converters_bitwise(ref, flagship):
    """seeded_state_dict is the same bits on a second call and on the
    machine that wrote the file (each tensor's sum), and the JAX package's
    importer (map_state_dict) followed by the port's state_dict_from_flax
    gives them back bitwise."""
    from masked_diffusion_tpu.models.factory import build_unet as jax_build_unet
    from tests.jax_full_width import jax_variables

    sd = flagship.state_dict()
    again = weights.seeded_state_dict(flagship, fw.WEIGHTS_SEED)
    assert list(again) == list(sd)
    assert all(torch.equal(again[k], v) for k, v in sd.items())
    np.testing.assert_allclose(fw.weight_sums(flagship), ref["weights/flagship/sums"], rtol=1e-12)
    assert len(sd) == 450 and sum(v.numel() for v in sd.values()) == 113673219
    jcfg = jax_build_unet(num_attention=fw.MODELS["flagship"]).config
    back = weights.state_dict_from_flax(jax_variables(sd, jcfg), jcfg)
    assert sorted(back) == sorted(sd) == sorted(str(n) for n in ref["train/names"])
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    # no tensor is left at its init: conv_out, zero at init, is seeded too
    assert sd["conv_out.weight"].abs().min() > 0


@pytest.mark.parametrize("name", list(fw.MODELS))
def test_forward_matches_jax(ref, flagship, name):
    model = flagship if name == "flagship" else fw.seeded_model(fw.MODELS[name])
    np.testing.assert_allclose(fw.weight_sums(model), ref[f"weights/{name}/sums"], rtol=1e-12)
    port = {dtype: fw.forward(model, ref, dtype, "cpu") for dtype in fw.DTYPES}
    assert all(np.isfinite(v).all() and v.shape == (2, 64, 64, 3) for v in port.values())
    assert np.abs(port["fp32"]).max() > 1e-2  # the output depends on the weights
    fw.raise_on_misses(fw.forward_rows(ref, name, port))


@pytest.mark.parametrize("mode", list(fw.MODES))
def test_train_step_matches_jax(ref, flagship, mode):
    steps = fw.train_pair(ref, mode, "cpu", flagship)
    assert all(np.isfinite(steps[d]["loss"]) for d in fw.DTYPES)
    fw.raise_on_misses(fw.train_rows(ref, mode, steps))


@pytest.mark.parametrize("mode", list(fw.MODES))
def test_reverse_steps_match_jax(ref, flagship, mode):
    out = fw.reverse_steps(ref, mode, "cpu", flagship)
    assert out.shape == (fw.REVERSE_STEPS, 2, 64, 64, 3) and np.isfinite(out).all()
    assert np.abs(out[-1] - fw.sample_latent(ref)).max() > 1e-2  # the loop moved the sample
    fw.raise_on_misses(fw.reverse_rows(ref, mode, out))


def _skips_swapped(block: int):
    """UNet2D.forward with up block `block`'s first two skips taken in the
    wrong order (no cache, no remat)."""
    def forward(self, x, timesteps, cached=None, return_cached=False):
        cfg = self.config
        temb = self.time_embedding(unet_mod.timestep_embedding(
            timesteps, cfg.block_out_channels[0], cfg.flip_sin_to_cos, cfg.freq_shift))
        h = self.conv_in(x)
        skips = [h]
        for blk in self.down_blocks:
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h)
                skips.append(h)
            for down in blk.downsamplers:
                h = down(h)
                skips.append(h)
        h = self.mid_block.resnets[1](self.mid_block.attentions[0](
            self.mid_block.resnets[0](h, temb)), temb)
        for i, blk in enumerate(self.up_blocks):
            if i == block:
                assert skips[-1].shape == skips[-2].shape
                skips[-1], skips[-2] = skips[-2], skips[-1]
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if len(blk.attentions):
                    h = blk.attentions[j](h)
            for up in blk.upsamplers:
                h = up(h)
        return self.conv_out(self.conv_norm_out(h))

    return forward


@pytest.mark.parametrize("fault", ["groupnorm_eps_x100", "up_block_1_skips_swapped"])
def test_planted_fault_fails_the_comparison(ref, flagship, monkeypatch, fault):
    """Each fault moves the fp32 forward far outside FWD_RTOL; the same
    forward without it is within (test_forward_matches_jax)."""
    if fault == "groupnorm_eps_x100":
        plain = groupnorm.group_norm_silu_plain
        monkeypatch.setattr(groupnorm, "group_norm_silu_plain",
                            lambda x, scale, bias, groups, eps=1e-5, silu=True:
                            plain(x, scale, bias, groups, 100 * eps, silu))
    else:
        monkeypatch.setattr(unet_mod.UNet2D, "forward", _skips_swapped(1))
    rows = fw.forward_rows(ref, "flagship", {"fp32": fw.forward(flagship, ref, "fp32", "cpu")},
                           _quiet)
    with pytest.raises(fw.Misses, match="forward flagship fp32"):
        fw.raise_on_misses(rows)
    assert rows[0][1] > 10 * fw.FWD_RTOL
