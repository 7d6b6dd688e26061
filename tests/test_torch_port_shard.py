"""The data-parallel kernel forms and their plumbing, on the CPU.

The port's counterparts of masked_diffusion_tpu/ops/pallas/shard.py and the
two sharded kernels (ops/pallas/fused_degrade.py:fused_degrade_update_sharded,
ops/pallas/kmask.py:exact_count_masks_pallas_sharded) run one launch per rank
on its rows with the rank folded into the seed (ops/shard.py). As
tests/test_pallas_sharded.py does for the JAX harness, the sharded form of
every rank of an N-rank plan must equal the single-device call on that
rank's rows with the folded seed, bitwise (CPU tensors take the plain
versions; the CUDA kernels are held to the same on the card by
chip_smoke.py phase 18). The per-rank math on injected bits, concatenated
over the ranks, equals the JAX package's on the global batch with the same
bits (the two PRNG streams cannot match). Also: the fold, the mesh plan's
checks and helpers against the JAX ones, and that a 1-rank plan is bitwise
the single-process path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masked_diffusion_tpu.ops import degrade as jdeg
from masked_diffusion_tpu.ops.pallas import fused_degrade as jfd
from masked_diffusion_tpu.ops.pallas.shard import data_parallel_kernel as jax_harness
from masked_diffusion_tpu.parallel import mesh as jmesh
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.ops import degrade as tdeg
from masked_diffusion_tpu_torch.ops import fused_degrade as tfd
from masked_diffusion_tpu_torch.ops import kmask as tkm
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.ops.shard import data_parallel_kernel, fold_generator, fold_seed
from masked_diffusion_tpu_torch.parallel import mesh as tmesh
from masked_diffusion_tpu_torch.parallel.mesh import MeshPlan
from masked_diffusion_tpu_torch.sample.loop import make_sample_fn
from masked_diffusion_tpu_torch.train.optim import build_lr_schedule, build_optimizer
from masked_diffusion_tpu_torch.train.step import create_train_state, make_train_step
from masked_diffusion_tpu_torch.utils import host
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401

CPU = torch.device("cpu")
B, C, H, W = 16, 3, 8, 8
HW = H * W
LANE_BITS = (HW - 1).bit_length()


def _plans(n):
    return [MeshPlan(CPU, data_size=n, rank=r) for r in range(n)]


def _rows(n, r):
    per = B // n
    return slice(r * per, (r + 1) * per)


def _fused_inputs(select, seed=0):
    rng = np.random.default_rng(seed)
    xt = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(size=(B, C, H, W)).astype(np.float32))
    if select == "indexing":
        amounts = rng.integers(0, HW + 1, size=(2, B)).astype(np.float32)
        amounts[:, 0] = amounts[:, B // 2] = HW // 3  # local image 0 of ranks 0 and 1 at N=2
    else:
        amounts = rng.uniform(0, 1, size=(2, B)).astype(np.float32)
    return xt, x0, torch.from_numpy(amounts)


# ------------------------------------------------------------------ the fold


def test_fold_seed_rank_zero_is_the_identity_and_ranks_differ():
    for seed in (0, 1, 12345, 2**62 - 1, (0 + 1) * 1_000_003 + 7):
        assert fold_seed(seed, 0) == seed
        folded = [fold_seed(seed, r) for r in range(8)]
        assert len(set(folded)) == 8
        assert all(0 <= s < 2**63 for s in folded)
        assert folded == [fold_seed(seed, r) for r in range(8)]  # deterministic
    assert fold_seed(1, 1) != fold_seed(2, 1)
    gen = torch.Generator().manual_seed(3)
    assert fold_generator(gen, 0) is gen and fold_generator(None, 1) is None
    seed = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(3)))
    assert fold_generator(gen, 2).initial_seed() == fold_seed(seed, 2)


# ------------------------------------------------------------ sharded forms


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("select", ["thresholding", "indexing"])
def test_fused_sharded_equals_per_shard_calls(select, n):
    xt, x0, amounts = _fused_inputs(select)
    kw = dict(select=select, mean_mode="degraded_area", rule="base_momentum", offset=3)
    outs, refs = [], []
    for r, plan in enumerate(_plans(n)):
        rows = _rows(n, r)
        outs.append(tfd.fused_degrade_update_sharded(
            xt[rows], x0[rows], amounts[0, rows], amounts[1, rows], plan=plan, batch=B,
            seed=99, **kw))
        refs.append(tfd.fused_degrade_update(
            xt[rows], x0[rows], amounts[0, rows], amounts[1, rows], seed=fold_seed(99, r),
            **kw))
    for (out, mask), (ref, ref_mask) in zip(outs, refs):
        assert torch.equal(out, ref) and torch.equal(mask, ref_mask)
    assert tfd.fused_degrade_update_sharded.launches == 0  # the CPU launches nothing
    if select == "indexing":  # exact k per shard, and distinct streams per rank
        for r, (_, mask) in enumerate(outs):
            zeros = (1.0 - mask).reshape(B // n, HW).sum(1)
            assert torch.equal(zeros, amounts[1, _rows(n, r)])
        assert not torch.equal(outs[0][1][0], outs[1][1][0])


@pytest.mark.parametrize("n", [2, 4])
def test_kmask_sharded_equals_per_shard_calls(n):
    rng = np.random.default_rng(1)
    counts = torch.from_numpy(rng.integers(0, HW + 1, size=B).astype(np.int32))
    counts[0] = counts[B // n] = HW // 2
    seed = int(torch.randint(0, 2**62, (1,), generator=torch.Generator().manual_seed(5)))
    masks = []
    for r, plan in enumerate(_plans(n)):
        rows = _rows(n, r)
        got = tkm.exact_count_masks_sharded(B, H, W, counts[rows], plan=plan,
                                            generator=torch.Generator().manual_seed(5))
        # rank 0 draws from the shared generator, rank r from the folded one
        ref_gen = torch.Generator().manual_seed(5 if r == 0 else fold_seed(seed, r))
        ref = tkm.exact_count_masks(B // n, H, W, counts[rows], generator=ref_gen)
        assert torch.equal(got, ref)
        assert torch.equal((1.0 - got).reshape(B // n, HW).sum(1).int(), counts[rows])
        masks.append(got)
    assert not torch.equal(masks[0][0], masks[1][0])  # local image 0, same count


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_forms_with_injected_bits_are_the_rows_calls(n):
    rng = np.random.default_rng(2)
    bits = torch.from_numpy(rng.integers(0, 2**32, size=(2, B, HW), dtype=np.uint64)
                            .astype(np.int64))
    xt, x0, amounts = _fused_inputs("indexing", 3)
    counts = amounts[0].to(torch.int32)
    for r, plan in enumerate(_plans(n)):
        rows = _rows(n, r)
        out = tfd.fused_degrade_update_sharded(
            xt[rows], x0[rows], amounts[0, rows], amounts[1, rows], plan=plan, batch=B,
            select="indexing", mean_mode="const", mean_value=0.25, bits=bits[:, rows])
        ref = tfd.fused_degrade_update(
            xt[rows], x0[rows], amounts[0, rows], amounts[1, rows], select="indexing",
            mean_mode="const", mean_value=0.25, bits=bits[:, rows])
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        got = tkm.exact_count_masks_sharded(B, H, W, counts[rows], plan=plan, bits=bits[0, rows])
        assert torch.equal(got, tkm.exact_count_masks(B // n, H, W, counts[rows],
                                                      bits=bits[0, rows]))


def test_indivisible_batch_raises_the_jax_message():
    jplan = jmesh.make_mesh(data=4, model=1)
    with pytest.raises(ValueError) as jerr:
        jax_harness(lambda k, x: x, mesh=jplan.mesh)(jax.random.PRNGKey(0), jnp.zeros((6, 2)))
    plan = MeshPlan(CPU, data_size=4, rank=1)
    xt, x0, amounts = _fused_inputs("thresholding")
    for call in (
        lambda: tfd.fused_degrade_update_sharded(
            xt[:2], x0[:2], amounts[0, :2], amounts[1, :2], plan=plan, batch=6,
            select="thresholding", mean_mode="const"),
        lambda: tkm.exact_count_masks_sharded(6, H, W, amounts[0, :2].int(), plan=plan),
        lambda: tmesh.local_rows(6, plan),
    ):
        with pytest.raises(ValueError) as err:
            call()
        assert str(err.value) == str(jerr.value) == "batch 6 not divisible by mesh axis data=4"


def test_harness_refuses_arguments_that_are_not_the_ranks_rows():
    call = data_parallel_kernel(lambda seed, x: x, MeshPlan(CPU, data_size=2, rank=1))
    assert torch.equal(call(8, 0, torch.ones(4)), torch.ones(4))
    with pytest.raises(ValueError, match="rank 1 of 2: an argument has 8 rows"):
        call(8, 0, torch.ones(8))


# ------------------------------------------- against the JAX package's math


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("select", ["thresholding", "indexing"])
def test_per_shard_fused_math_equals_jax_fused_rows_on_the_global_batch(select, n):
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2**32, size=(2, B, HW), dtype=np.uint64).astype(np.uint32)
    bits[:, 4:8] &= np.uint32(0xE0000000)  # heavy ties
    xt, x0, amounts = _fused_inputs(select, 5)
    kw = dict(select=select, mean_mode="degraded_area", mean_value=0.0, rule="base_momentum")
    j_out, j_mask = jfd.fused_rows(
        jnp.asarray(bits[0]), jnp.asarray(bits[1]), jnp.asarray(xt.reshape(B, -1).numpy()),
        jnp.asarray(x0.reshape(B, -1).numpy()), jnp.asarray(amounts[0, :, None].numpy()),
        jnp.asarray(amounts[1, :, None].numpy()), channels=C, **kw)
    tbits = torch.from_numpy(bits.astype(np.int64))
    parts = [tfd.fused_degrade_update_sharded(
        xt[_rows(n, r)], x0[_rows(n, r)], amounts[0, _rows(n, r)], amounts[1, _rows(n, r)],
        plan=plan, batch=B, bits=tbits[:, _rows(n, r)], **kw) for r, plan in enumerate(_plans(n))]
    out = torch.cat([p[0] for p in parts]).reshape(B, -1).numpy()
    mask = torch.cat([p[1] for p in parts]).reshape(B, HW).numpy()
    np.testing.assert_array_equal(mask, np.asarray(j_mask))
    np.testing.assert_allclose(out, np.asarray(j_out), rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_per_shard_masks_equal_jax_exact_count_masks_on_the_global_batch(n, monkeypatch):
    rng = np.random.default_rng(6)
    perm = np.stack([rng.permutation(HW) for _ in range(B)])
    u = (perm / HW).astype(np.float32)  # distinct draws, exact in fp32
    bits = torch.from_numpy((perm.astype(np.uint64) << np.uint64(32 - LANE_BITS)).astype(np.int64))
    counts = rng.integers(0, HW + 1, size=B).astype(np.int32)
    counts[:3] = (0, HW, 1)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(u))
    ref = np.asarray(jdeg.exact_count_masks(jax.random.PRNGKey(0), B, H, W, jnp.asarray(counts)))
    tcounts = torch.from_numpy(counts)
    got = torch.cat([tkm.exact_count_masks_sharded(B, H, W, tcounts[_rows(n, r)], plan=plan,
                                                   bits=bits[_rows(n, r)])
                     for r, plan in enumerate(_plans(n))])
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)


def test_degrade_routes_indexing_through_the_sharded_form_under_a_plan():
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.uniform(-1, 1, (B // 2, C, H, W)).astype(np.float32))
    amount = torch.from_numpy(rng.integers(0, HW + 1, B // 2).astype(np.int64))
    plan = MeshPlan(CPU, data_size=2, rank=1)
    got = tdeg.generate_masks(img, amount, "indexing", "1-channel",
                              generator=torch.Generator().manual_seed(3), plan=plan)
    ref = tkm.exact_count_masks_sharded(B, H, W, amount.int(), plan=plan,
                                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, ref.expand(B // 2, C, H, W))
    single = tdeg.generate_masks(img, amount, "indexing", "1-channel",
                                 generator=torch.Generator().manual_seed(3))
    assert not torch.equal(got, single)  # rank 1 draws its own stream


# ------------------------------------------------------------ plan and host


def test_make_mesh_without_a_process_group():
    plan = tmesh.make_mesh(-1, 1, CPU)
    assert (plan.data_size, plan.rank, plan.device) == (1, 0, CPU)
    assert tmesh.make_mesh(1, 1, CPU).data_size == 1
    with pytest.raises(ValueError, match="--mesh_data 2 but WORLD_SIZE is 1"):
        tmesh.make_mesh(2, 1, CPU)
    with pytest.raises(ValueError, match="--mesh_model 2 .* WORLD_SIZE is 1"):
        tmesh.make_mesh(-1, 2, CPU)  # tensor parallelism needs a group of ranks
    assert tmesh.init_distributed("cpu") == CPU  # WORLD_SIZE unset
    # --multihost is torchrun across nodes: one process without it is refused
    with pytest.raises(RuntimeError, match="--multihost True but WORLD_SIZE is 1.*--nnodes"):
        tmesh.init_distributed("cpu", multihost=True)


def test_more_ranks_than_cards_are_refused_without_a_card_index(monkeypatch):
    """--device cuda gives each rank a card of its own; sharing one is asked
    for with an index. This machine's card count is what it is (0 here)."""
    cards = torch.cuda.device_count()
    ranks = cards + 2  # a process group has two ranks at least
    for var, value in dict(WORLD_SIZE=ranks, RANK=0, LOCAL_RANK=0, LOCAL_WORLD_SIZE=ranks,
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=29500).items():
        monkeypatch.setenv(var, str(value))
    with pytest.raises(ValueError, match=f"{ranks} ranks on this node but {cards} CUDA card"):
        tmesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("n,multiple", [(5, 1), (5, 2), (8, 4), (1, 8), (100, 8)])
def test_round_up_equals_the_jax_helper_and_bounds_the_rows(n, multiple):
    assert tmesh.round_up(n, multiple) == jmesh.round_up(n, multiple)
    plan = MeshPlan(CPU, data_size=multiple, rank=multiple - 1)
    rows = tmesh.local_rows(tmesh.round_up(n, multiple), plan)
    assert rows.stop == tmesh.round_up(n, multiple)


def test_host_helpers_are_the_identity_for_one_process():
    x = torch.arange(6.0).reshape(3, 2)
    assert host.process_index() == 0 and host.process_count() == 1 and host.is_main_process()
    np.testing.assert_array_equal(host.fetch(x), x.numpy())
    assert host.mean_over_ranks(x) is x
    date, clock = host.synced_timestamp()
    assert len(date) == 10 and len(clock) == 8
    host.barrier()


# ------------------------------------------- a 1-rank plan is today's path


def _toy_model():
    from masked_diffusion_tpu_torch.models.factory import build_unet

    torch.manual_seed(0)
    return build_unet(3, H, W, block_out_channels=(16, 32), layers_per_block=1)


def test_one_rank_plan_samples_bitwise_as_without_a_plan(monkeypatch):
    """The loop reaches the fused kernel through its sharded form on a
    1-rank plan: bitwise the single-device call it made without one."""
    from masked_diffusion_tpu_torch.sample import loop

    cfg = Config(data_size=H, select_degrade_pixel="indexing", ddpm_schedule="log",
                 ddpm_num_steps=8, mean_option="degraded_area", shift_type="1-d_constant")
    sched = build_schedule("log", 8, H, "indexing")
    used = sched.timesteps_for_epoch(1, 10, 1)
    latent = torch.from_numpy(np.random.default_rng(8).uniform(-1, 1, (2, H, W, 3))
                              .astype(np.float32))

    def single_device(*args, plan, batch, **kw):
        return tfd.fused_degrade_update(*args, **kw)

    outs = []
    for plan in (None, MeshPlan(CPU), "single-device"):
        if plan == "single-device":
            monkeypatch.setattr(loop, "fused_degrade_update_sharded", single_device)
            plan = None
        fn = make_sample_fn(_toy_model(), sched, cfg, used, device="cpu", plan=plan)
        outs.append(fn(latent, torch.Generator().manual_seed(4)))
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_one_rank_plan_trains_bitwise_as_without_a_plan(monkeypatch):
    """The step reaches the exact-k kernel through its sharded form on a
    1-rank plan: bitwise the single-device call it made without one."""
    cfg = Config(method="mean_shift", data_size=H, select_degrade_pixel="indexing",
                 ddpm_schedule="log", ddpm_num_steps=8, mean_option="degraded_area",
                 shift_type="1-d_constant", lr=1e-3, gradient_accumulation_steps=2)
    sched = build_schedule("log", 8, H, "indexing")
    used = sched.timesteps_for_epoch(0, 10, 1)
    batch = torch.from_numpy(np.random.default_rng(9).uniform(-1, 1, (4, H, W, 3))
                             .astype(np.float32))

    def single_device(batch, height, width, counts, *, plan, generator=None, bits=None):
        return tkm.exact_count_masks(batch, height, width, counts, generator=generator,
                                     bits=bits)

    params = []
    for plan in (None, MeshPlan(CPU), "single-device"):
        if plan == "single-device":
            monkeypatch.setattr(tdeg, "exact_count_masks_sharded", single_device)
            plan = None
        model = _toy_model()
        lr = build_lr_schedule("cosine", 1e-3, 0, 10)
        opt = build_optimizer("adamw", model.parameters(), lr, 1.0, 2)
        state = create_train_state(model, opt, use_ema=True, plan=plan)
        assert state.ddp is None
        step = make_train_step(model, sched, cfg, opt, used, lr, device="cpu", plan=plan)
        gen = torch.Generator().manual_seed(fold_seed(11, 0))
        losses = [step(state, batch, gen)["train_loss"] for _ in range(3)]
        params.append((torch.stack(losses), [p.detach().clone() for p in model.parameters()],
                       [p.detach().clone() for p in state.ema_model.parameters()]))
    for other in params[1:]:
        assert torch.equal(params[0][0], other[0])
        for a, b in zip(params[0][1] + params[0][2], other[1] + other[2]):
            assert torch.equal(a, b)
