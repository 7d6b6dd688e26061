"""The JAX package's numbers at the flagship's full width, written by JAX on
the CPU, for the port to be held against on the CPU (tier-1,
tests/test_torch_port_full_width.py) and on the card (chip_smoke.py phase
30).

    python -m tests.jax_full_width      # rewrites tests/data/jax_full_width.npz

The models are the flagship (6 levels of (128, 128, 256, 256, 512, 512),
2 layers a block, --num_attention 1, 113.7M params) and CelebA-HQ's topology
(--num_attention 5: tiny-head attention at S = 1024 and 256), both at 64x64
and batch 2. Their weights are the port's io/weights.seeded_state_dict at
WEIGHTS_SEED, carried into JAX by the JAX package's own importer
(masked_diffusion_tpu/io/import_torch.py:map_state_dict), so the file holds
no weights: only inputs, made from numpy seeds, and outputs.

  weights/          each seeded tensor's sum, a model
  forward/          the UNet at two timesteps (one an image), fp32 and
                    bf16 (compute dtype bf16, fp32 params), both models
  train/            one flagship train step (mean_shift, AdamW + cosine,
                    clip 1.0, EMA) in both bench modes, linear +
                    thresholding at T=1000 and log + indexing at T=4096
                    (1421 steps), fp32 and bf16, on injected draws
                    (tests/test_torch_port_train.py's fakes): the loss,
                    seeded random projections (io/weights.seeded_projections)
                    of each parameter's clipped gradient and of its update,
                    and each gradient's bf16-vs-fp32 distance, exact (the
                    EMA after its first update is checked to be the
                    parameters)
  sample/           three reverse steps from t = T of the fused branch
                    (MDT_PALLAS_FUSED=1, the Pallas kernel's plain reference
                    fused_rows on injected bits), both bench modes, fp32:
                    sample_t after each step

The inputs, the seeds, the sizes and the tolerances are
masked_diffusion_tpu_torch/tools/full_width.py's, which holds the port
against this file.

JAX runs no Pallas kernel here: on the CPU its UNet takes flax's GroupNorm
and the einsum attention, and the fused step is its plain reference, as the
JAX package's own CPU tests run them.
tests/test_torch_port_full_width_reference.py recomputes this file in
memory and fails if it has drifted from the JAX package.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

if __name__ == "__main__":  # the settings tests/conftest.py makes before jax starts
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from masked_diffusion_tpu_torch.tools.full_width import (  # noqa: E402
    DTYPES,
    GRAD_K,
    MODELS,
    MODES,
    PATH,
    REVERSE_STEPS,
    SIZE,
    TOTAL_STEPS,
    UPDATE_K,
    inputs,
    projections,
    sample_config,
    sample_latent,
    sample_used,
    seeded_model,
    train_config,
    train_used,
    weight_sums,
)


def train_fixtures(data: dict, mode: str, n_used: int) -> dict:
    """data's draws of `mode` as tests/test_torch_port_train.py's fixtures:
    timesteps taken modulo the mode's used timesteps, the composite keys
    the exact-k kernel ranks, mask uniforms on one channel."""
    bits = data[f"train/{mode}/bits"]
    hw = bits.shape[-1]
    lane_bits = max(1, (hw - 1).bit_length())
    keys = (bits & np.uint32((0xFFFFFFFF << lane_bits) & 0xFFFFFFFF)) | np.arange(
        hw, dtype=np.uint32)
    return dict(images=data["train/images"], timeindex=data[f"train/{mode}/timeindex"] % n_used,
                bits=bits, keys=keys, mask_u=data[f"train/{mode}/mask_u"],
                uniform=data[f"train/{mode}/uniform"])


def jax_variables(state_dict, jcfg):
    """The port's state dict through the JAX package's importer: its
    folder reader's name rule (diffusers' to_out.0 -> to_out), then
    map_state_dict."""
    from masked_diffusion_tpu.io.import_torch import map_state_dict

    sd = {k.replace(".to_out.0.", ".to_out."): v.detach().numpy()
          for k, v in state_dict.items()}
    return map_state_dict(sd, jcfg)


def port_layout(tree, jcfg, base=None):
    """(name, float32 array) for each parameter of a JAX tree (minus
    base's), under the port's names and layout (io/weights.flax_layout, the
    converter's table), one tensor at a time."""
    from masked_diffusion_tpu_torch.io.weights import flax_layout

    bases = flax_layout(base["params"], jcfg) if base is not None else None
    for name, leaf, perm in flax_layout(tree["params"], jcfg):
        a = np.asarray(leaf, np.float32)
        if bases is not None:
            a = a - np.asarray(next(bases)[1], np.float32)
        yield name, (a.transpose(perm) if perm else a)


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.ravel(a - b)) / np.linalg.norm(np.ravel(b)))


@contextmanager
def patched(*triples):
    """setattr(obj, name, value) for each triple, undone on exit."""
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in triples]
    for obj, name, value in triples:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)


class TracedUNet:
    """A JAX UNet2D whose apply is jitted once, so that the forward, the
    train steps and the sampler reuse one trace of the model a dtype and
    input shape (flax takes seconds to trace the 113.7M-param UNet); XLA
    inlines the call into each program."""

    def __init__(self, jcfg, dtype: str):
        from masked_diffusion_tpu.models.unet import UNet2D

        self.module = UNet2D(config=jcfg, dtype=jnp.float32 if dtype == "fp32" else jnp.bfloat16)
        self.apply = jax.jit(self.module.apply, static_argnames=("deterministic",))


def jax_forward(model: TracedUNet, variables, data) -> np.ndarray:
    x = jnp.asarray(data["forward/x"]).astype(model.module.dtype)
    out = jax.jit(model.apply)(variables, x, jnp.asarray(data["forward/t"]), deterministic=True)
    return np.asarray(out, np.float32)


def jax_train_step(model: TracedUNet, variables, jcfg, data, mode: str, dtype: str) -> dict:
    """One JAX train step (train/step.py:_make_step_impl) on the injected
    draws: loss, and the projections of the clipped gradient (the one the
    optimizer applies: optax's clip_by_global_norm of the gradient the
    chain receives) and of the update, and the clipped gradient itself
    ("gradient", {port name: array}). Raises if the EMA after its first
    update is not the parameters (decay 0 at the first step)."""
    import optax

    from masked_diffusion_tpu.config import Config
    from masked_diffusion_tpu.ops import degrade as jdeg
    from masked_diffusion_tpu.ops import shift as jshift
    from masked_diffusion_tpu.ops.schedule import build_schedule
    from masked_diffusion_tpu.train import optim as joptim
    from masked_diffusion_tpu.train import step as jstep
    from tests.test_torch_port_train import _jax_fakes

    cfg = train_config(mode, dtype, Config)
    sched = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE, cfg.select_degrade_pixel)
    used = train_used(sched)
    fx = train_fixtures(data, mode, len(used))
    lr = joptim.build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps, TOTAL_STEPS,
                                  cfg.lr_cycle)
    tx = joptim.build_optimizer(cfg.optim, lr, 1.0, 1)
    grads = []

    def update(g, st, params=None):
        jax.debug.callback(lambda t: grads.append(t), g)
        return tx.update(g, st, params)

    rec = optax.GradientTransformation(tx.init, update)
    params = jax.tree.map(jnp.array, variables)
    state = jstep.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                             ema_params=jax.tree.map(jnp.array, variables),
                             opt_state=jax.jit(rec.init)(params))
    split, randint, degrade, shift = _jax_fakes(fx)
    with patched((jax.random, "split", split), (jax.random, "randint", randint),
                 (jdeg, "degrade_training", degrade), (jshift, "schedule_shift", shift)):
        fn = jax.jit(jstep._make_step_impl(model, sched, cfg, rec, used, lr), donate_argnums=0)
        new, metrics = fn(state, jnp.asarray(fx["images"][0]), jax.random.PRNGKey(0))
        jax.effects_barrier()
    (g,) = grads
    norm = np.sqrt(sum(float(np.sum(np.square(np.asarray(x), dtype=np.float64)))
                       for x in jax.tree.leaves(g)))
    scale = np.float32(min(1.0, 1.0 / norm))
    gradient = {name: a * scale for name, a in port_layout(g, jcfg)}
    del g, grads
    if not all(np.array_equal(e, p) for e, p in zip(jax.tree.leaves(new.ema_params),
                                                    jax.tree.leaves(new.params))):
        raise AssertionError(f"train {mode} {dtype}: JAX's EMA is not the parameters after "
                             "the first update")
    names = list(gradient)
    grad, update = projections(gradient.items(), GRAD_K), projections(
        port_layout(new.params, jcfg, variables), UPDATE_K)
    return {"names": np.asarray(names), "loss": np.asarray(float(metrics["train_loss"])),
            "grad": np.stack([grad[n] for n in names]),
            "update": np.stack([update[n] for n in names]), "gradient": gradient}


def _step_row(key):
    """The reverse step a faked key carries (tests/test_torch_port_sampler.py's
    fake_split: the carried key counts the steps)."""
    return key[0] - 1


def jax_reverse_steps(model: TracedUNet, variables, data, mode: str) -> np.ndarray:
    """REVERSE_STEPS + 1 steps of JAX's make_sample_fn from t = T on the
    fused branch: sample_t after each of the first REVERSE_STEPS,
    (steps, B, H, W, C). The fused kernel is its plain reference fused_rows
    on the step's injected bits, the shift its formula on the step's
    injected uniforms."""
    from masked_diffusion_tpu.config import Config
    from masked_diffusion_tpu.ops import shift as jshift
    from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
    from masked_diffusion_tpu.ops.schedule import build_schedule
    from masked_diffusion_tpu.sample import make_sample_fn
    from tests.test_torch_port_sampler import fake_split

    cfg = sample_config(mode, Config)
    sched = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE, cfg.select_degrade_pixel)
    bits, uniform = jnp.asarray(data["sample/bits"]), jnp.asarray(data["sample/uniform"])
    after = {}

    def fused(key, sample_t, sample_0, amount_t, amount_next, *, select, mean_mode,
              mean_value=0.0, rule="base_momentum", interpret=False):
        b, h, w, c = sample_t.shape
        rows = lambda x: x.transpose(0, 3, 1, 2).reshape(b, c * h * w)  # noqa: E731
        row = _step_row(key)
        out, mask_n = jfd.fused_rows(
            bits[row, 0], bits[row, 1], rows(sample_t), rows(sample_0),
            jnp.asarray(amount_t, jnp.float32).reshape(b, 1),
            jnp.asarray(amount_next, jnp.float32).reshape(b, 1), channels=c, select=select,
            mean_mode=mean_mode, mean_value=mean_value, rule=rule)
        new = out.reshape(b, c, h, w).transpose(0, 2, 3, 1)
        jax.debug.callback(lambda r, x: after.__setitem__(int(r), np.array(x)), row, new)
        return new, jnp.broadcast_to(mask_n.reshape(b, h, w, 1), (b, h, w, c))

    def shift(key, ratios_t, shape, shift_type, noise_mean=0.0, dtype=jnp.float32,
              combine_perturbation=False):
        assert shift_type == "1-d_constant", shift_type
        s = (uniform[_step_row(key)] * ratios_t.astype(jnp.float32))[:, None, None, None]
        return jnp.broadcast_to(s.astype(dtype), shape)

    os.environ["MDT_PALLAS_FUSED"] = "1"
    try:
        with patched((jax.random, "split", fake_split), (jfd, "fused_degrade_update", fused),
                     (jshift, "schedule_shift", shift)):
            fn = make_sample_fn(model, sched, cfg, sample_used(sched))
            np.asarray(fn(variables, jnp.asarray(sample_latent(data)), jax.random.PRNGKey(0)))
            jax.effects_barrier()
    finally:
        del os.environ["MDT_PALLAS_FUSED"]
    return np.stack([after[i] for i in range(REVERSE_STEPS)])


class Reference:
    """The JAX side of each part of the file, computed now; each model's
    variables and traced UNets are built once and kept."""

    def __init__(self):
        self.data = inputs()
        self._models = {}

    def model(self, name: str):
        """(jcfg, variables, {dtype: TracedUNet}, each seeded tensor's sum)."""
        if name not in self._models:
            from masked_diffusion_tpu.models.factory import build_unet as jax_build_unet

            jcfg = jax_build_unet(num_attention=MODELS[name]).config
            port = seeded_model(MODELS[name])
            self._models[name] = (jcfg, jax_variables(port.state_dict(), jcfg),
                                  {dtype: TracedUNet(jcfg, dtype) for dtype in DTYPES},
                                  weight_sums(port))
        return self._models[name]

    def forward(self) -> dict:
        out = {}
        for name in MODELS:
            _, variables, models, sums = self.model(name)
            out[f"weights/{name}/sums"] = sums
            for dtype in DTYPES:
                out[f"forward/{name}/{dtype}"] = jax_forward(models[dtype], variables, self.data)
        return out

    def train(self, mode: str) -> dict:
        jcfg, variables, models, _ = self.model("flagship")
        out, gradient = {}, {}
        for dtype in DTYPES:
            step = jax_train_step(models[dtype], variables, jcfg, self.data, mode, dtype)
            gradient[dtype] = step.pop("gradient")
            out["train/names"] = step.pop("names")
            for key, value in step.items():
                out[f"train/{mode}/{dtype}/{key}"] = value
        out[f"train/{mode}/bf16/own"] = np.asarray(
            [rel_l2(gradient["bf16"][n], gradient["fp32"][n]) for n in out["train/names"]])
        return out

    def reverse(self) -> dict:
        _, variables, models, _ = self.model("flagship")
        return {f"sample/{mode}/sample_t": jax_reverse_steps(models["fp32"], variables,
                                                             self.data, mode)
                for mode in MODES}


def compute() -> dict:
    """The file's arrays, computed now."""
    ref = Reference()
    out = dict(ref.data)
    out.update(ref.forward())
    for mode in MODES:
        out.update(ref.train(mode))
    out.update(ref.reverse())
    return out


def main() -> int:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **compute())
    print(f"wrote {PATH}: {os.path.getsize(PATH)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
