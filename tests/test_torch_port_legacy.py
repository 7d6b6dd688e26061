"""The legacy GAN/EBM slice: the port's GAN, EBGAN and saliency models, the
GAN trainer and the legacy entry point, against the JAX package.

Every model's variables are seeded numpy values in the tree its Flax init
makes, with nonzero biases, norm scales off 1 and residual gammas off 0 (a
fresh PAM/CAM gamma is 0, which makes both modules the identity and would
prove nothing), converted with io/legacy_weights.py and loaded with strict=True.
The fp32 forwards agree to atol 2e-5 / rtol 2e-4 (the UNet tests' class:
conv sums in another order).

The trainer: three steps of the JAX step (its optimizers' update wrapped
to record the gradients they are given) and of the port's
step, from the same weights, on the same batches and with the JAX step's
own draws injected (z from split(key)[0], each Langevin step's noise from
a fresh split of split(key)[1], as the JAX fori_loop draws them). Losses
agree to rtol 1e-4, the first step's gradients to atol 1e-6 and the
parameters after three steps to atol 1e-5 (all but a few Adam entries:
see the test).
"""

import functools
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from masked_diffusion_tpu.models import ebgan as jebgan
from masked_diffusion_tpu.models import gan as jgan
from masked_diffusion_tpu.models import saliency as jsal
from masked_diffusion_tpu.train.gan_trainer import GANTrainer as JGANTrainer
from masked_diffusion_tpu_torch.cli import main_train as port_cli
from masked_diffusion_tpu_torch.io import legacy_weights as lw
from masked_diffusion_tpu_torch.models import ebgan, gan, saliency
from masked_diffusion_tpu_torch.train.gan_trainer import GANTrainer
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401

ATOL, RTOL = 2e-5, 2e-4


def _numpy(tree):
    if hasattr(tree, "items"):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _fill(shapes, seed):
    """Seeded numpy variables of the tree of ShapeDtypeStructs `shapes`:
    kernels N(0, 1/fan_in), biases N(0, 0.2^2), norm scales 1 + N(0, 0.2^2),
    gammas in [0.5, 1.5] (a fresh gamma is 0: PAM and CAM the identity)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[:-1])), shape)
        elif name == "gamma":
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = (name == "scale") + rng.normal(0, 0.2, shape)
        return np.asarray(v, np.float32)

    return _numpy(jax.tree_util.tree_map_with_path(fill, shapes))


def _variables(model, seed, *args):
    """Variables in the tree `model.init` makes, its shapes by
    jax.eval_shape (Flax's random init compiles for seconds on the CPU)."""
    return _fill(jax.eval_shape(model.init, jax.random.PRNGKey(0), *map(jnp.asarray, args)),
                 seed)


def _nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2), order="C"))


def _out(t):
    """A port output as the JAX layout: NCHW maps to NHWC numpy."""
    t = t.detach()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(want).max() > 1e-3  # the output depends on the weights
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _parity(jmodel, tmodel, convert, seed, *inputs):
    """The JAX model (one compiled apply) and the port's on the converted
    weights: (variables, the port's outputs, the JAX outputs), as numpy
    tuples in the JAX layout."""
    v = _variables(jmodel, seed, *inputs)
    tmodel.load_state_dict(convert(v), strict=True)
    want = jax.jit(jmodel.apply)(v, *map(jnp.asarray, inputs))
    with torch.no_grad():
        got = tmodel.eval()(*[_nchw(x) if x.ndim == 4 else torch.from_numpy(x)
                              for x in inputs])
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)  # noqa: E731
    return (v, tuple(_out(t) for t in as_tuple(got)),
            tuple(np.asarray(a) for a in as_tuple(want)))


def _check(*args):
    _, got, want = _parity(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)
    return got


# ------------------------------------------------------------------- GAN


def test_gan_models_match_jax():
    rng = np.random.default_rng(0)
    z = rng.normal(size=(3, 16)).astype(np.float32)
    (img,) = _check(jgan.Generator(dim_features=8, out_channels=3), gan.Generator(16, 8, 3),
                    lw.gan_state_dict, 1, z)
    assert img.shape == (3, 32, 32, 3) and img.min() >= 0 and img.max() <= 1  # sigmoid
    (logit,) = _check(jgan.Discriminator(dim_features=8), gan.Discriminator(3, 8, 32),
                      lw.gan_state_dict, 2, img)
    assert logit.shape == (3,)
    # at 64x64 the last map is 2x2: the NHWC flatten order reaches linear1
    x = rng.uniform(-1, 1, size=(2, 64, 64, 1)).astype(np.float32)
    _check(jgan.Discriminator(dim_features=4), gan.Discriminator(1, 4, 64), lw.gan_state_dict,
           3, x)


# ----------------------------------------------------------------- EBGAN


def test_nearest_and_bilinear_upsampling_match_jax():
    """ebgan's nearest x2 reads index i // 2 on both sides; jax.image.resize
    "bilinear" upsampling is F.interpolate(align_corners=False)."""
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 3)).astype(np.float32)
    near = np.asarray(jebgan._up2(jnp.asarray(x)))
    np.testing.assert_array_equal(near, x[:, np.arange(10) // 2][:, :, np.arange(14) // 2])
    np.testing.assert_array_equal(_out(ebgan._up2(_nchw(x))), near)
    bil = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 9, 3), "bilinear"))
    got = torch.nn.functional.interpolate(_nchw(x), size=(10, 9), mode="bilinear",
                                          align_corners=False)
    np.testing.assert_allclose(_out(got), bil, atol=1e-6)


def test_ebgan_models_match_jax():
    """EBGenerator, EBDiscriminator (whose flat (H, W, C) vectors reach the
    embedding, fc_norm2's groups and the reshape) and the AutoEncoder (its
    dec1/dec2 are Flax's ConvTranspose(3, 2, "SAME"), at 28x28 and 16x16)."""
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 62)).astype(np.float32)
    (img,) = _check(jebgan.EBGenerator(), ebgan.EBGenerator(), lw.ebgan_state_dict, 1, z)
    assert img.shape == (2, 32, 32, 1) and np.abs(img).max() <= 1  # tanh
    recon, emb = _check(jebgan.EBDiscriminator(), ebgan.EBDiscriminator(),
                        lw.ebgan_state_dict, 2, img)
    assert recon.shape == img.shape and emb.shape == (2, 32)
    for size in (28, 16):
        x = rng.uniform(-1, 1, size=(2, size, size, 1)).astype(np.float32)
        (out,) = _check(jebgan.AutoEncoder(image_size=size), ebgan.AutoEncoder(image_size=size),
                        lw.ebgan_state_dict, 3, x)
        assert out.shape == x.shape


# -------------------------------------------------------------- saliency

W, LATENT = 8, 4


@pytest.fixture(scope="module")
def saliency_inputs():
    rng = np.random.default_rng(11)
    return (rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32),
            rng.normal(size=(2, LATENT)).astype(np.float32),
            rng.uniform(0, 1, size=(2, 32, 32, 1)).astype(np.float32))


def test_saliency_generators_match_jax(saliency_inputs):
    x, z, _ = saliency_inputs
    v, got, want = _parity(
        jsal.SaliencyModel("generator", "from_latent", width=W, latent_dim=LATENT),
        saliency.SaliencyModel("generator", "from_latent", width=W, latent_dim=LATENT),
        lw.saliency_state_dict, 1, x, z)
    assert v["params"]["pam"]["gamma"] >= 0.5 and v["params"]["cam"]["gamma"] >= 0.5
    assert got[0].shape == (2, 32, 32, 1)
    _close(got[0], want[0])
    (out,) = _check(jsal.SaliencyModel("generator", "from_image", width=W),
                    saliency.SaliencyModel("generator", "from_image", width=W),
                    lw.saliency_state_dict, 2, x)
    assert out.shape == (2, 32, 32, 1)


def test_attention_modules_match_jax():
    """PAM and CAM alone, with nonzero gammas, on a map with C // 8 = 2."""
    x = np.random.default_rng(12).normal(size=(2, 6, 5, 16)).astype(np.float32)
    for jmod, tmod in ((jsal.PositionAttention(), saliency.PositionAttention(16)),
                       (jsal.ChannelAttention(), saliency.ChannelAttention())):
        (out,) = _check(jmod, tmod, lw.saliency_state_dict, 7, x)
        assert np.abs(out - x).max() > 1e-2  # gamma is not 0: not the identity


def test_descriptor_and_holistic_attention_match_jax(saliency_inputs):
    x, _, seg = saliency_inputs
    (energy,) = _check(jsal.SaliencyModel("descriptor", width=W),
                       saliency.SaliencyModel("descriptor", width=W),
                       lw.saliency_state_dict, 5, x, seg)
    assert energy.shape == (2,)

    np.testing.assert_allclose(saliency.gaussian_kernel_2d(9, 2.0).numpy(),
                               np.asarray(jsal.gaussian_kernel_2d(9, 2.0)), atol=1e-8)
    attn = np.zeros((2, 24, 20, 1), np.float32)
    attn[0, 8, 8] = 1.0
    attn[1] = seg[1, :24, :20]
    feat = np.random.default_rng(14).normal(size=(2, 24, 20, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jsal.holistic_attention)(jnp.asarray(attn), jnp.asarray(feat)))
    _close(_out(saliency.holistic_attention(_nchw(attn), _nchw(feat))), want)


@pytest.mark.parametrize("work,method", [("critic", "from_latent"), ("generator", "bogus")])
def test_saliency_dispatch_errors(work, method):
    for factory in (jsal.SaliencyModel, saliency.SaliencyModel):
        with pytest.raises(NotImplementedError, match="model selection error"):
            factory(work, method)


# --------------------------------------------------------------- trainer

B, DL, STEPS = 4, 8, 3


def _jax_draws(key, length):
    k_z, k_l = jax.random.split(key)
    z = np.array(jax.random.normal(k_z, (B, DL)))
    noise = []
    for _ in range(length):
        k_l, k = jax.random.split(k_l)
        noise.append(np.asarray(jax.random.normal(k, (B, DL))))
    return z, np.asarray(noise, np.float32).reshape(length, B, DL)


def _recording(tx, store):
    """tx whose update hands the gradients it is given to `store` (a
    debug callback: the step stays one compiled program)."""
    def update(grads, state, params=None):
        jax.debug.callback(lambda g: store.append(jax.tree.map(np.array, g)), grads)
        return tx.update(grads, state, params)

    return optax.GradientTransformation(tx.init, update)


def _jax_trainer(monkeypatch, **kw):
    """The JAX GANTrainer, its networks' init made by _fill from
    jax.eval_shape (the same tree; a fresh process's eager init compiles op
    by op for ~25 s)."""
    seeds = iter(range(10, 20))

    def init(self, rng, *args, **kwargs):
        return _fill(jax.eval_shape(functools.partial(flax.linen.Module.init, self), rng, *args),
                     next(seeds))

    def apply(self, variables, *args, **kwargs):
        return jax.eval_shape(functools.partial(flax.linen.Module.apply, self), variables, *args)

    with monkeypatch.context() as m:
        m.setattr(jgan.Generator, "init", init)
        m.setattr(jgan.Discriminator, "init", init)
        m.setattr(jgan.Generator, "apply", apply)  # only the init's shape probe
        return JGANTrainer(**kw)


TRAINER_CASES = {
    "adam": dict(optim_name="adam"),
    "adamw-langevin-weight_reg": dict(optim_name="adamw", langevin_length=2, langevin_lr=0.05,
                                      langevin_noise_lr=0.01, weight_reg=0.1),
    "sgd": dict(optim_name="sgd"),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_gan_trainer_steps_match_jax(monkeypatch, case):
    kw = dict(dim_latent=DL, dim_features=4, out_channels=3, lr_g=1e-3, lr_d=2e-3,
              lr_g_min=1e-4, lr_d_min=2e-4, total_steps=4, seed=1, **TRAINER_CASES[case])
    jtr = _jax_trainer(monkeypatch, **kw)
    g0, d0 = _numpy(jtr.state.g_params), _numpy(jtr.state.d_params)
    tr = GANTrainer(device="cpu", **kw)
    tr.G.load_state_dict(lw.gan_state_dict(g0), strict=True)
    tr.D.load_state_dict(lw.gan_state_dict(d0), strict=True)

    g_grads, d_grads = [], []
    jtr.tx_g, jtr.tx_d = _recording(jtr.tx_g, g_grads), _recording(jtr.tx_d, d_grads)
    jstep = jax.jit(jtr._make_step())
    rng = np.random.default_rng(len(case))
    state = jtr.state
    for i in range(STEPS):
        real = rng.uniform(0, 1, size=(B, 32, 32, 3)).astype(np.float32)
        key = jax.random.PRNGKey(100 + i)
        state, jm = jstep(state, jnp.asarray(real), key)
        jax.effects_barrier()
        z, noise = _jax_draws(key, tr.langevin_length)
        tm = tr.step(_nchw(real), torch.from_numpy(z), torch.from_numpy(noise))
        for k in ("loss_d", "loss_g"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} {i}")
        if i == 0:
            for net, jg in ((tr.G, g_grads[0]), (tr.D, d_grads[0])):
                want = lw.gan_state_dict(jg)
                for name, p in net.named_parameters():
                    np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=1e-6,
                                               err_msg=name)
    assert len(g_grads) == len(d_grads) == STEPS
    assert tr.opt_g.count == tr.opt_d.count == STEPS
    # Adam divides each coordinate by its own gradient scale, so where a
    # gradient is near zero the two sides' last-bit differences become
    # moves of up to one LR a step in either direction (measured: 1 entry of
    # 18432 in D's conv1 off by 3.1e-5 at LR 2e-3 under adamw). Those
    # entries, at most 0.1% of a network, are bounded by 2 LR instead.
    for net, jp, p0, lr in ((tr.G, state.g_params, g0, kw["lr_g"]),
                            (tr.D, state.d_params, d0, kw["lr_d"])):
        want, init = lw.gan_state_dict(_numpy(jp)), lw.gan_state_dict(p0)
        loose = total = 0
        for name, p in net.named_parameters():
            assert (want[name] - init[name]).abs().max() > 0, name  # the step moved it
            d = (p.detach() - want[name]).abs()
            assert d.max() <= 2 * lr, f"{name}: {d.max()}"
            loose += int((d > 1e-5).sum())
            total += d.numel()
        assert loose <= 1e-3 * total, f"{loose} of {total} entries off by more than 1e-5"


def test_cosine_decay_equals_optax():
    from masked_diffusion_tpu_torch.train.gan_trainer import cosine_decay

    for lr_max, lr_min, total in ((2e-4, 0.0, 10), (1e-3, 1e-4, 3), (5e-4, 5e-5, 1)):
        want = optax.cosine_decay_schedule(lr_max, max(1, total), alpha=lr_min / lr_max)
        got = cosine_decay(lr_max, lr_min, total)
        np.testing.assert_allclose([got(c) for c in range(total + 3)],
                                   [float(want(c)) for c in range(total + 3)], rtol=1e-6)


# ------------------------------------------------------------------- CLI


def test_legacy_cli_trains_on_cpu(tmp_path, capsys):
    rc = port_cli.main([
        "--device", "cpu", "--data_name", "synthetic", "--data_size", "32",
        "--data_subset_use", "True", "--data_subset_num", "16", "--batch_size", "8",
        "--dim_feature", "4", "--dim_latent", "8", "--epoch_length", "1", "--save_every", "1",
        "--langevin_length", "1", "--langevin_lr", "0.01", "--dir_work", str(tmp_path),
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "final losses: G=" in out
    stats = json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("gan_stats ")).split(" ", 1)[1])
    assert stats["steps"] == 2 and stats["device"] == "cpu"
    assert np.isfinite(stats["loss_g"] + stats["loss_d"]).all()
    (png,) = stats["samples"]
    assert os.path.basename(png) == "gan_sample_00000.png" and os.path.exists(png)
    assert os.path.dirname(png).endswith(os.path.join("train", "image", "sample_image"))


def test_legacy_cli_refuses_cuda_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(["--data_name", "synthetic", "--dir_work", str(tmp_path)])


def test_legacy_parser_defaults_equal_the_jax_entry_point():
    import main_train

    jdef = {a.dest: a.default for a in main_train.build_parser()._actions}
    tdef = {a.dest: a.default for a in port_cli.build_parser()._actions}
    assert tdef.pop("device") == "cuda"
    assert tdef == jdef
