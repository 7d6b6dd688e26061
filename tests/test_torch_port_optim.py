"""The port's optimizer, LR laws, EMA and loss-weight table against the JAX
package's (train/optim.py, models/ema.py, ops/schedule.py).

Over 20 updates of a small parameter list with seeded gradients (some above
the clip norm, some below), the port's clip + adam/adamw/sgd under every LR
law, with accumulation 1 and 2, follows optax's chain step for step. fp32 on
both sides, but the LR is a float64 host number in the port and float32 in
JAX, and torch's Adam divides sqrt(v) by sqrt(1 - b2^t) where optax takes
sqrt(v / (1 - b2^t)): parameters of size ~1 agree to rtol 1e-5, atol 1e-5
after 20 updates of size ~LR = 0.05 (measured: 1.3e-6 at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.models import ema as jema
from masked_diffusion_tpu.ops.schedule import build_schedule as jax_build_schedule
from masked_diffusion_tpu.train import optim as joptim
from masked_diffusion_tpu_torch.models import ema as tema
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.train import optim as toptim

SHAPES = [(5, 4), (7,), (3, 3)]
UPDATES, LR, WARMUP, TOTAL = 20, 0.05, 4, 16


@pytest.mark.parametrize("law", ["cosine", "hard_cosine", "constant", "linear"])
def test_lr_schedule_matches_jax(law):
    ref = joptim.build_lr_schedule(law, LR, WARMUP, TOTAL, 0.5)
    got = toptim.build_lr_schedule(law, LR, WARMUP, TOTAL, 0.5)
    steps = range(TOTAL + 5)
    np.testing.assert_allclose([got(s) for s in steps], [float(ref(s)) for s in steps],
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        toptim.build_lr_schedule("bogus", LR, 0, 1)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("law", ["cosine", "hard_cosine", "constant", "linear"])
@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_matches_optax(name, law, accum):
    rng = np.random.default_rng(len(name) * 7 + len(law) + accum)
    init = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    grads = [[rng.normal(scale=rng.choice([0.05, 2.0]), size=s).astype(np.float32)
              for s in SHAPES] for _ in range(UPDATES * accum)]

    tx = joptim.build_optimizer(name, joptim.build_lr_schedule(law, LR, WARMUP, TOTAL), 1.0,
                                accum)
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(params, state, g):
        upd, state = tx.update(g, state, params)
        return jax.tree.map(lambda p, u: p + u, params, upd), state

    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt = toptim.build_optimizer(name, params, toptim.build_lr_schedule(law, LR, WARMUP, TOTAL),
                                 1.0, accum)
    for i, g in enumerate(grads):
        jparams, jstate = jstep(jparams, jstate, [jnp.asarray(x) for x in g])
        opt.zero_grad()
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        moved = opt.update()
        assert moved == ((i + 1) % accum == 0)
        for p, ref in zip(params, jparams):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref), rtol=1e-5,
                                       atol=1e-5, err_msg=f"micro step {i}")
    assert opt.count == UPDATES


def test_clip_is_optax_formula():
    g = [torch.full((4,), 3.0), torch.full((9,), 4.0)]  # global norm sqrt(180)
    norm = float(toptim.clip_by_global_norm_(g, 1.0))
    np.testing.assert_allclose(norm, np.sqrt(4 * 9 + 9 * 16), rtol=1e-6)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(torch.cat(g))), 1.0, rtol=1e-6)
    small = [torch.full((4,), 0.1)]
    toptim.clip_by_global_norm_(small, 1.0)
    assert torch.equal(small[0], torch.full((4,), 0.1))  # below the norm: untouched


def test_ema_decay_matches_jax():
    got = [tema.ema_decay(s, 1.0, 0.75, 0.0, 0.9999) for s in range(51)]
    ref = [float(jema.ema_decay(s, 1.0, 0.75, 0.0, 0.9999)) for s in range(51)]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert got[0] == got[1] == 0.0
    assert tema.ema_decay(10**9) == 0.9999  # the clamp
    got = [tema.ema_decay(s, use_warmup=False) for s in range(20)]
    ref = [float(jema.ema_decay(s, use_warmup=False)) for s in range(20)]
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(0)
    ema = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    params = [rng.normal(size=s).astype(np.float32) for s in SHAPES]
    for step in (1, 2, 7):
        ref = jema.ema_update([jnp.asarray(e) for e in ema], [jnp.asarray(p) for p in params],
                              step)
        got = [torch.from_numpy(e.copy()) for e in ema]
        tema.ema_update(got, [torch.from_numpy(p) for p in params], tema.ema_decay(step))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,select", [("log", "indexing"), ("linear", "thresholding")])
def test_loss_weights_match_jax(name, select):
    jsched = jax_build_schedule(name, 40, 16, select)
    tsched = build_schedule(name, 40, 16, select)
    np.testing.assert_allclose(tsched.loss_weight_table(10.0).numpy(),
                               np.asarray(jsched.loss_weight_table(10.0)), rtol=1e-6)
    idx = np.array([0, 3, 17, jsched.num_steps - 1])
    np.testing.assert_allclose(tsched.loss_weights(torch.from_numpy(idx), 10.0).numpy(),
                               np.asarray(jsched.loss_weights(jnp.asarray(idx), 10.0)), rtol=1e-6)
