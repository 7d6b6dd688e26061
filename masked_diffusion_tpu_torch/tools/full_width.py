"""The port held against the JAX package's numbers at the flagship's full width.

tests/data/jax_full_width.npz holds what the JAX package computed on the
CPU (tests/jax_full_width.py writes it from the constants and inputs of this
module): the flagship (113.7M params) and CelebA-HQ's topology
(--num_attention 5) at 64x64, batch 2, with the weights of
io/weights.seeded_state_dict at WEIGHTS_SEED, which both sides rebuild from
the seed. This module computes the port's side of each case on a device and
holds it against the file; tests/test_torch_port_full_width.py runs it on
the CPU (the kernels' plain versions), chip_smoke.py phase 30 on the card
(the kernels). Each case, its tolerance, and the distance each measured
(relative L2 unless stated):

  forward    the UNet at two timesteps (one an image). fp32 (on the card
             with TF32 off) within FWD_RTOL. bf16 (under autocast, as the
             trainer runs it) by the rule of tests/test_torch_port_unet.py:
             within 2x the larger of the two sides' own bf16-vs-fp32
             distances and within 2x JAX's own (the second implies the
             first), the port's own within 2x JAX's own.
  train      one flagship step (mean_shift, AdamW + cosine, clip 1.0, EMA)
             in both bench modes on injected draws, fp32 and bf16: the loss,
             seeded random projections (io/weights.seeded_projections) of
             each parameter's clipped gradient (GRAD_K of them) and of its
             update (UPDATE_K), and JAX's own bf16-vs-fp32 distance of each
             parameter's gradient, exact; the EMA after its first update
             equal to the parameters, bitwise, as JAX's (decay 0 at the
             first step). fp32: the loss within TRAIN_RTOL (relative), the
             gradient and the update over the whole model within GRAD_RTOL
             and UPDATE_RTOL. bf16 by the rule of
             tests/test_torch_port_train.py's bf16 test: the loss and every
             parameter's gradient within 2x the larger of the two sides' own
             distances (the port's exact, the cross distance from the
             projections), the port's own within 2x JAX's own, the whole
             gradient within 2x JAX's own. The projections' distance of one
             parameter scatters about the exact one by ~1/sqrt(2 GRAD_K):
             at 16 projections the scatter alone broke the rule for one of
             the 450 parameters whose exact distances keep it (1.12 of the
             bound against 0.76 exact); at 64 the worst estimate on the CPU
             is 0.86 of its bound.
  reverse    three reverse steps from t = T on the fused branch in both
             bench modes, fp32, on injected bits and shifts: sample_t after
             each step within atol = rtol = REVERSE_TOL elementwise
             (tests/test_torch_port_sampler.py's).

`check(ref, device)` first holds the seeded weights to the file's record of
them (each tensor's sum), then runs every case, logging each distance
beside its bound, and raises after the last case if any missed.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PATH = os.path.join(_ROOT, "tests", "data", "jax_full_width.npz")
WEIGHTS_SEED = 17  # io/weights.seeded_state_dict
PROJECTION_SEED = 23  # io/weights.seeded_projections
SIZE, BATCH, CHANNELS = 64, 2, 3
MODELS = {"flagship": 1, "celeba_hq": 5}  # --num_attention
FORWARD_T = (3.0, 700.0)  # one timestep an image
DTYPES = ("fp32", "bf16")
# the bench's two modes: (schedule, selection, --ddpm_num_steps)
MODES = {"thresholding": ("linear", "thresholding", 1000), "indexing": ("log", "indexing", 4096)}
LR = 1e-4
TOTAL_STEPS = 100  # the cosine schedule's length
REVERSE_STEPS = 3  # stored; one more runs, so that none of the three is the loop's last
GRAD_K, UPDATE_K = 64, 16  # projections a parameter of its gradient and of its update

FWD_RTOL = 1e-5
TRAIN_RTOL = 2e-3  # the loss (tests/test_torch_port_train.py's RTOL)
GRAD_RTOL = 1e-4
UPDATE_RTOL = 2e-3  # tests/test_torch_port_train.py's update bound
REVERSE_TOL = 2e-3


# ------------------------------------------------------------------ inputs


def inputs() -> dict:
    """Every input, from numpy seeds: the forward's x (NHWC) and t, one
    train step's images and draws a mode (leading axis: the step), and the
    reverse steps' bits ((step, t or t-1, image, pixel) uint32) and shift
    uniforms. Both bench modes' reverse steps share them."""
    hw = SIZE * SIZE
    rng = np.random.default_rng(1)
    out = {"forward/x": rng.normal(size=(BATCH, SIZE, SIZE, CHANNELS)).astype(np.float32),
           "forward/t": np.asarray(FORWARD_T, np.float32),
           "train/images": rng.uniform(-1, 1, (1, BATCH, SIZE, SIZE, CHANNELS)).astype(
               np.float32)}
    for mode, seed in (("thresholding", 2), ("indexing", 3)):
        rng = np.random.default_rng(seed)
        out[f"train/{mode}/bits"] = rng.integers(0, 2**32, (1, BATCH, hw),
                                                 dtype=np.uint64).astype(np.uint32)
        out[f"train/{mode}/timeindex"] = rng.integers(0, 1000, (1, BATCH)).astype(np.int32)
        out[f"train/{mode}/mask_u"] = rng.uniform(0, 1, (1, BATCH, SIZE, SIZE, 1)).astype(
            np.float32)
        out[f"train/{mode}/uniform"] = rng.uniform(-1, 1, (1, BATCH)).astype(np.float32)
    rng = np.random.default_rng(4)
    out["sample/latent"] = rng.uniform(-1, 1, BATCH).astype(np.float32)
    out["sample/bits"] = rng.integers(0, 2**32, (REVERSE_STEPS + 1, 2, BATCH, hw),
                                      dtype=np.uint64).astype(np.uint32)
    out["sample/uniform"] = rng.uniform(-1, 1, (REVERSE_STEPS + 1, BATCH)).astype(np.float32)
    return out


def _config_cls(config_cls):
    if config_cls is None:
        from masked_diffusion_tpu_torch.config import Config as config_cls
    return config_cls


def train_config(mode: str, dtype: str, config_cls=None):
    """The train step's Config (the bench's flags); config_cls: either
    package's Config (default the port's)."""
    sched, select, t_steps = MODES[mode]
    return _config_cls(config_cls)(
        method="mean_shift", data_size=SIZE, ddpm_schedule=sched, ddpm_num_steps=t_steps,
        select_degrade_pixel=select, degrade_channel="1-channel", mean_option="degraded_area",
        mean_area="image-wise", shift_type="1-d_constant", optim="adamw",
        lr_scheduler="cosine", lr=LR, lr_warmup_steps=0, use_ema=True,
        mixed_precision="no" if dtype == "fp32" else "bf16", out_channel=CHANNELS)


def sample_config(mode: str, config_cls=None):
    """The reverse loop's Config: a mode of the fused branch (base_momentum,
    independent masks, 1-channel, an image-wise degraded_area mean)."""
    sched, select, t_steps = MODES[mode]
    return _config_cls(config_cls)(
        method="sample", data_size=SIZE, ddpm_schedule=sched, ddpm_num_steps=t_steps,
        select_degrade_pixel=select, degrade_channel="1-channel", mean_option="degraded_area",
        mean_area="image-wise", shift_type="1-d_constant", momentum_adaptive="base_momentum",
        sampling_mask_dependency="independent", mixed_precision="no", out_channel=CHANNELS)


def train_used(schedule) -> np.ndarray:
    return schedule.timesteps_for_epoch(0, 10, 1)


def sample_used(schedule) -> np.ndarray:
    """The last REVERSE_STEPS + 1 used timesteps: the loop walks them from T."""
    return schedule.timesteps_for_epoch(1, 10, 1)[-(REVERSE_STEPS + 1):]


def sample_latent(data: dict) -> np.ndarray:
    """The reverse loop's latent, NHWC: one value an image, as the mean fill
    of a fully degraded image (--sample_latent_shape uniform)."""
    lat = data["sample/latent"][:, None, None, None]
    return np.broadcast_to(lat, (BATCH, SIZE, SIZE, CHANNELS)).astype(np.float32)


def output_keys() -> Dict[str, str]:
    """{key of an output array in the file: the part of the JAX side that
    computes it ("forward", "train-<mode>" or "reverse")}; the rest of the
    file is inputs()."""
    keys = {}
    for name in MODELS:
        keys[f"weights/{name}/sums"] = "forward"
        keys.update({f"forward/{name}/{d}": "forward" for d in DTYPES})
    keys["train/names"] = f"train-{next(iter(MODES))}"
    for mode in MODES:
        keys.update({f"train/{mode}/{d}/{k}": f"train-{mode}"
                     for d in DTYPES for k in ("loss", "grad", "update")})
        keys[f"train/{mode}/bf16/own"] = f"train-{mode}"
    keys.update({f"sample/{mode}/sample_t": "reverse" for mode in MODES})
    return keys


def load(path: str = PATH) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# --------------------------------------------------------------- the port


def seeded_model(num_attention: int, device="cpu") -> torch.nn.Module:
    """The port's UNet at the model's topology with the seeded weights."""
    from masked_diffusion_tpu_torch.io.weights import seeded_state_dict
    from masked_diffusion_tpu_torch.models.factory import build_unet

    model = build_unet(num_attention=num_attention)
    model.load_state_dict(seeded_state_dict(model, WEIGHTS_SEED), strict=True)
    return model.to(device)


def projections(named, k: int) -> Dict[str, np.ndarray]:
    """{name: k seeded projections, float32} of (name, tensor) pairs."""
    from masked_diffusion_tpu_torch.io.weights import seeded_projections

    return {name: seeded_projections(name, t, PROJECTION_SEED, k).astype(np.float32)
            for name, t in named}


def weight_sums(model) -> np.ndarray:
    """Each seeded tensor's float64 sum, in state-dict order: the file's
    record of the weights it was computed with."""
    return np.asarray([float(v.double().sum()) for v in model.state_dict().values()])


def forward(model, data: dict, dtype: str, device) -> np.ndarray:
    """The UNet's output, NHWC float32: fp32, or bf16 under autocast."""
    device = torch.device(device)
    x = torch.from_numpy(data["forward/x"].transpose(0, 3, 1, 2).copy()).to(device)
    t = torch.from_numpy(data["forward/t"]).to(device)
    model.eval()
    with torch.inference_mode(), torch.autocast(device.type, torch.bfloat16,
                                                enabled=dtype == "bf16"):
        out = model(x, t)
    return out.float().permute(0, 2, 3, 1).cpu().numpy()


def train_draws(data: dict, mode: str, n_used: int, device):
    from masked_diffusion_tpu_torch.train.step import TrainDraws

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return TrainDraws(
        timeindex=on(data[f"train/{mode}/timeindex"][0].astype(np.int64) % n_used),
        bits=on(data[f"train/{mode}/bits"][0].astype(np.int64)),
        mask_uniform=on(data[f"train/{mode}/mask_u"][0].transpose(0, 3, 1, 2)),
        uniform=on(data[f"train/{mode}/uniform"][0]))


def train_step(data: dict, mode: str, dtype: str, device, model=None) -> dict:
    """One port train step from the seeded flagship on the injected draws:
    the loss, the projections of each parameter's clipped gradient (the
    one AdamW applies; .grad after the step) and of its update, and the
    clipped gradient itself ("gradient", on `device`). Raises if the EMA
    after its first update is not the parameters. model: the seeded
    flagship on `device`, left at its first weights (a copy trains)."""
    from masked_diffusion_tpu_torch.models.factory import build_unet
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
    from masked_diffusion_tpu_torch.train.step import create_train_state, make_train_step

    device = torch.device(device)
    cfg = train_config(mode, dtype)
    schedule = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                              cfg.select_degrade_pixel)
    used = train_used(schedule)
    if model is None:
        model = seeded_model(MODELS["flagship"], device)
    init = {k: v.detach() for k, v in model.state_dict().items()}
    net = build_unet(num_attention=MODELS["flagship"]).to(device)
    net.load_state_dict(init)
    lr = build_lr_schedule(cfg.lr_scheduler, cfg.lr, cfg.lr_warmup_steps, TOTAL_STEPS,
                           cfg.lr_cycle)
    opt = build_optimizer(cfg.optim, net.parameters(), lr, 1.0, 1)
    state = create_train_state(net, opt, use_ema=True)
    step = make_train_step(net, schedule, cfg, opt, used, lr, device=device)
    images = torch.from_numpy(data["train/images"][0]).to(device)
    loss = step(state, images, draws=train_draws(data, mode, len(used), device))["train_loss"]
    ema = dict(state.ema_model.named_parameters())
    for k, p in net.named_parameters():
        if not torch.equal(ema[k], p):
            raise AssertionError(f"train {mode} {dtype}: the EMA's {k} is not the parameter "
                                 "after the first update (decay 0)")
    params = dict(net.named_parameters())
    out = {"loss": float(loss),
           "gradient": {k: p.grad.detach().clone() for k, p in params.items()},
           "update": projections(((k, p.detach() - init[k]) for k, p in params.items()),
                                 UPDATE_K)}
    out["grad"] = projections(out["gradient"].items(), GRAD_K)
    del state, opt, step, net, params
    return out


def train_pair(data: dict, mode: str, device, model=None, before: Optional[Callable] = None):
    """train_step in fp32 and in bf16, and the port's own bf16-vs-fp32
    distance of each parameter's gradient, exact: {"fp32": .., "bf16": ..,
    "own": {name: distance}}, the gradients dropped. before(case) runs
    before each step."""
    steps = {}
    for dtype in DTYPES:
        if before:
            before(f"train {mode} {dtype}")
        steps[dtype] = train_step(data, mode, dtype, device, model)
    g32, g16 = steps["fp32"].pop("gradient"), steps["bf16"].pop("gradient")
    steps["own"] = {k: float((g16[k] - g32[k]).norm() / g32[k].norm()) for k in g32}
    return steps


@contextlib.contextmanager
def recording_fused_steps(record: Callable):
    """Route the reverse loop's fused step through a wrapper that hands each
    new sample_t (NCHW) to record(step, sample_t) and returns it unchanged:
    the kernel (or its plain version) runs as it does on the main path."""
    import masked_diffusion_tpu_torch.sample.loop as loop_mod

    real = loop_mod.fused_degrade_update_sharded
    calls = []

    def wrapper(*args, **kwargs):
        new, mask = real(*args, **kwargs)
        record(len(calls), new)
        calls.append(1)
        return new, mask

    loop_mod.fused_degrade_update_sharded = wrapper
    try:
        yield
    finally:
        loop_mod.fused_degrade_update_sharded = real


def reverse_steps(data: dict, mode: str, device, model=None) -> np.ndarray:
    """REVERSE_STEPS + 1 steps of the port's reverse loop from t = T on the
    fused branch, on the injected bits and shift uniforms: sample_t after
    each of the first REVERSE_STEPS, (steps, B, H, W, C) float32."""
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.loop import StepDraws, fused_mode, make_sample_fn

    device = torch.device(device)
    cfg = sample_config(mode)
    if fused_mode(cfg) is None:
        raise AssertionError(f"{mode}: the reverse steps' mode is not the fused branch's")
    schedule = build_schedule(cfg.ddpm_schedule, cfg.ddpm_num_steps, SIZE,
                              cfg.select_degrade_pixel)
    used = sample_used(schedule)
    if model is None:
        model = seeded_model(MODELS["flagship"], device)
    bits = torch.from_numpy(data["sample/bits"].astype(np.int64)).to(device)
    uniform = torch.from_numpy(data["sample/uniform"]).to(device)
    n = len(used)

    def draws(i):  # the loop's step index i walks n-1 .. 0; row j = n-1-i from t = T
        j = n - 1 - i
        return StepDraws(bits=bits[j], uniform=uniform[j])

    after = {}
    fn = make_sample_fn(model, schedule, cfg, used, device=device)
    with recording_fused_steps(lambda j, x: after.__setitem__(j, x.permute(0, 2, 3, 1).cpu())):
        fn(torch.from_numpy(sample_latent(data)).to(device), draws=draws)
    return np.stack([after[j].numpy() for j in range(REVERSE_STEPS)])


# ---------------------------------------------------------------- distances


def rel_l2(a, b) -> float:
    a, b = np.ravel(np.asarray(a, np.float64)), np.ravel(np.asarray(b, np.float64))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


class Misses(AssertionError):
    pass


def _row(log, what, value, bound, rows):
    ok = value <= bound
    rows.append((what, value, bound, ok))
    log(f"{what}: {value:.3g} (bound {bound:.3g}){'' if ok else '  MISS'}")


def forward_rows(ref: dict, name: str, port: dict, log=print) -> list:
    """port: {"fp32": output, "bf16": output} (bf16 optional). Rows (what,
    distance, bound, ok)."""
    rows = []
    j32, j16 = ref[f"forward/{name}/fp32"], ref[f"forward/{name}/bf16"]
    _row(log, f"forward {name} fp32", rel_l2(port["fp32"], j32), FWD_RTOL, rows)
    if "bf16" not in port:
        return rows
    cross, own_j, own_p = (rel_l2(port["bf16"], j16), rel_l2(j16, j32),
                           rel_l2(port["bf16"], port["fp32"]))
    # within 2x the larger own distance and 2x JAX's: the second implies the first
    _row(log, f"forward {name} bf16 (own: JAX {own_j:.3g}, port {own_p:.3g})", cross,
         2 * own_j, rows)
    _row(log, f"forward {name} bf16, the port's own", own_p, 2 * own_j, rows)
    return rows


def _whole(proj: Dict[str, np.ndarray], names) -> np.ndarray:
    return np.concatenate([proj[n] for n in names])


def train_rows(ref: dict, mode: str, port: dict, log=print) -> list:
    """port: train_pair(...)."""
    rows = []
    names = [str(n) for n in ref["train/names"]]
    pre = f"train/{mode}"
    j32 = {k: ref[f"{pre}/fp32/{k}"] for k in ("loss", "grad", "update")}
    p32 = port["fp32"]
    _row(log, f"train {mode} fp32 loss (JAX {float(j32['loss']):.6f}, port "
              f"{p32['loss']:.6f})", abs(p32["loss"] - float(j32["loss"])) / abs(
                  float(j32["loss"])), TRAIN_RTOL, rows)
    for key, bound in (("grad", GRAD_RTOL), ("update", UPDATE_RTOL)):
        _row(log, f"train {mode} fp32 {key}", rel_l2(_whole(p32[key], names), j32[key]), bound,
             rows)
    j16 = {k: ref[f"{pre}/bf16/{k}"] for k in ("loss", "grad", "own")}
    p16 = port["bf16"]
    lj32, lj16 = float(j32["loss"]), float(j16["loss"])
    cross = abs(p16["loss"] - lj16) / abs(lj16)
    own_j, own_p = abs(lj16 - lj32) / abs(lj32), abs(p16["loss"] - p32["loss"]) / abs(
        p32["loss"])
    _row(log, f"train {mode} bf16 loss (own: JAX {own_j:.3g}, port {own_p:.3g})", cross,
         2 * max(own_j, own_p), rows)
    _row(log, f"train {mode} bf16 loss, the port's own", own_p, 2 * own_j, rows)
    shares = []
    for i, n in enumerate(names):  # each parameter as a share of its bounds; the worst logged
        cross, own_j, own_p = rel_l2(p16["grad"][n], j16["grad"][i]), j16["own"][i], port["own"][n]
        shares.append((max(cross / (2 * max(own_j, own_p)), own_p / (2 * own_j)), n, cross,
                       own_j, own_p))
    share, n, cross, own_j, own_p = max(shares)
    _row(log, f"train {mode} bf16 gradient, the worst of {len(names)} parameters, {n} "
              f"(cross {cross:.3g}, own: JAX {own_j:.3g}, port {own_p:.3g}), as a share of "
              "its bounds", share, 1.0, rows)
    cross, own_j = (rel_l2(_whole(p16["grad"], names), j16["grad"]),
                    rel_l2(j16["grad"], j32["grad"]))
    _row(log, f"train {mode} bf16 whole gradient (JAX's own {own_j:.3g})", cross, 2 * own_j,
         rows)
    return rows


def reverse_rows(ref: dict, mode: str, port: np.ndarray, log=print) -> list:
    """Elementwise: max over entries of |port - JAX| / (atol + rtol |JAX|),
    bound 1."""
    rows = []
    jax_t = ref[f"sample/{mode}/sample_t"]
    for j in range(REVERSE_STEPS):
        d = np.abs(port[j].astype(np.float64) - jax_t[j])
        share = float(np.max(d / (REVERSE_TOL + REVERSE_TOL * np.abs(jax_t[j]))))
        _row(log, f"reverse {mode} step {j + 1}: max |diff| {d.max():.3g}, rel L2 "
                  f"{rel_l2(port[j], jax_t[j]):.3g}, as a share of atol = rtol = {REVERSE_TOL}",
             share, 1.0, rows)
    return rows


def raise_on_misses(rows: list) -> None:
    missed = [r for r in rows if not r[3]]
    if missed:
        raise Misses("; ".join(f"{w}: {v:.3g} > {b:.3g}" for w, v, b, _ in missed))


def check(ref: dict, device, log=print, before: Optional[Callable] = None) -> list:
    """Every case on `device`; logs each distance beside its bound, raises
    Misses after the last case if any missed. fp32 runs with TF32 off.
    before(case) is called before each case (chip_smoke.py resets the
    launch counts there)."""
    device = torch.device(device)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for name, num_attention in MODELS.items():
            model = seeded_model(num_attention, device)
            sums = weight_sums(model)
            if not np.allclose(sums, ref[f"weights/{name}/sums"], rtol=1e-12, atol=0):
                raise AssertionError(f"{name}: the seeded weights are not the file's (this "
                                     "numpy draws other numbers from the seeds)")
            port = {}
            for dtype in DTYPES:
                if before:
                    before(f"forward {name} {dtype}")
                port[dtype] = forward(model, ref, dtype, device)
            rows += forward_rows(ref, name, port, log)
            if name != "flagship":
                continue
            for mode in MODES:
                rows += train_rows(ref, mode, train_pair(ref, mode, device, model, before), log)
                if before:
                    before(f"reverse {mode}")
                rows += reverse_rows(ref, mode, reverse_steps(ref, mode, device, model), log)
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    raise_on_misses(rows)
    return rows
