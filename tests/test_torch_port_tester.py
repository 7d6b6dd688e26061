"""The diversity tester (--method test): the port's tester.py against the
JAX package's, its CLI on the CPU, and a 2-rank gloo run.

Inputs are numpy arrays from seeds, NHWC, fed to both modules. The dedup
passes get planted near-copies at cosines 0.9 +- 1e-3 (either side of the
threshold), an all-zero image and empty inputs: the kept images must be
the same, index for index. Downsampling for the nearest-neighbour match is
held against jax.image.resize (bilinear, which antialiases when it shrinks)
at 16->8, 12->8 and 8->16 within atol 1e-5, and the picks of
get_nearest_neighbor, with and without flips, must be equal.
assign_similar_neighbor must fill the same buckets and report the same
changed set, including a sample that a sample before it in the same round
keeps out. Tester.run runs with _sample_batch replaced in both packages by
the same batch sequence: unique_images, num_unique_history, rounds, img_set
and the files written must be equal.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from masked_diffusion_tpu import tester as jtester
from masked_diffusion_tpu.config import Config as JConfig
from masked_diffusion_tpu.data.datasets import InMemoryDataset as JDataset
from masked_diffusion_tpu.utils.dirs import Dir as JDir
from masked_diffusion_tpu_torch import tester as ttester
from masked_diffusion_tpu_torch.cli import main_train_masked as port_cli
from masked_diffusion_tpu_torch.config import Config as TConfig
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset as TDataset
from masked_diffusion_tpu_torch.io import weights
from masked_diffusion_tpu_torch.models.factory import build_unet
from masked_diffusion_tpu_torch.utils.dirs import Dir as TDir
from tests.test_torch_port_unet import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, C = 8, 3
TH = ttester.COSINE_SIMILARITY_TH
assert TH == jtester.COSINE_SIMILARITY_TH


def _unit(v):
    return v / np.linalg.norm(v)


def near_copy(rng, img, cos):
    """An image whose cosine with img is `cos` (a random orthogonal part),
    scaled by a random positive factor."""
    x = _unit(img.reshape(-1).astype(np.float64))
    z = rng.normal(size=x.shape)
    z = _unit(z - (z @ x) * x)
    y = cos * x + np.sqrt(1.0 - cos * cos) * z
    return (y * rng.uniform(0.5, 2.0) * np.linalg.norm(img)).reshape(img.shape).astype(np.float32)


def images(rng, n, size=S):
    return rng.uniform(-1, 1, (n, size, size, C)).astype(np.float32)


def _planted_batch(seed=0):
    """[b0, b1, b0 at 0.901 (dropped), b1 at 0.899 (kept), zeros, b2,
    b2 at 0.95 (dropped), b0 at 0.899 (kept), b3 at 0.901 (dropped)]."""
    rng = np.random.default_rng(seed)
    b = images(rng, 4)
    batch = np.stack([b[0], b[1], near_copy(rng, b[0], TH + 1e-3), near_copy(rng, b[1], TH - 1e-3),
                      np.zeros_like(b[0]), b[2], near_copy(rng, b[2], 0.95),
                      near_copy(rng, b[0], TH - 1e-3), b[3], near_copy(rng, b[3], TH + 1e-3)])
    return batch, [0, 1, 3, 4, 5, 7, 8]


def _same_rows(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_cosine_matrix_matches_jax():
    rng = np.random.default_rng(1)
    a, b = images(rng, 5), images(rng, 7)
    a[2] = 0.0  # the zero image's cosines are 0, not NaN
    got = ttester.cosine_matrix(a, b, device="cpu")
    assert got.shape == (5, 7) and got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, jtester.cosine_matrix(a, b), atol=1e-6)
    assert not got[2].any()


def test_greedy_dedup_keeps_what_jax_keeps():
    batch, kept = _planted_batch()
    want = jtester.greedy_dedup(batch)
    _same_rows(ttester.greedy_dedup(batch, device="cpu"), want)
    _same_rows(want, batch[kept])
    # the order matters: the near-copy first keeps it and drops the original
    flipped = batch[[2, 0, 1]]
    _same_rows(ttester.greedy_dedup(flipped, device="cpu"), jtester.greedy_dedup(flipped))
    _same_rows(ttester.greedy_dedup(flipped, device="cpu"), flipped[[0, 2]])
    empty = batch[:0]
    assert ttester.greedy_dedup(empty, device="cpu").shape == empty.shape


def test_dedup_against_drops_what_jax_drops():
    rng = np.random.default_rng(2)
    previous = images(rng, 3)
    batch = np.stack([near_copy(rng, previous[0], TH + 1e-3), near_copy(rng, previous[1], TH - 1e-3),
                      np.zeros((S, S, C), np.float32), images(rng, 1)[0],
                      near_copy(rng, previous[2], 0.99)])
    want = jtester.dedup_against(batch, previous)
    _same_rows(ttester.dedup_against(batch, previous, device="cpu"), want)
    _same_rows(want, batch[[1, 2, 3]])
    for a, b in ((batch[:0], previous), (batch, previous[:0])):
        _same_rows(ttester.dedup_against(a, b, device="cpu"), jtester.dedup_against(a, b))


@pytest.mark.parametrize("src,dst", [(16, 8), (12, 8), (8, 16)])
def test_downsample_matches_jax_resize(src, dst):
    x = images(np.random.default_rng(src), 3, src)
    got = ttester._downsample_batch(x, dst, device="cpu")
    assert got.shape == (3, dst, dst, C)
    np.testing.assert_allclose(got, jtester._downsample_batch(x, dst), atol=1e-5, rtol=0)


@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("compare_size", [8, 32])
def test_nearest_neighbor_picks_what_jax_picks(flip, compare_size):
    rng = np.random.default_rng(4)
    dataset = images(rng, 12, 16)
    samples = np.concatenate([dataset[[3, 7]] + 0.3 * images(rng, 2, 16),
                              dataset[5:6, :, ::-1, :], images(rng, 3, 16)])
    want = jtester.get_nearest_neighbor(samples, dataset, compare_size, flip)
    got = ttester.get_nearest_neighbor(samples, dataset, compare_size, flip, device="cpu")
    _same_rows(got, want)


def test_nearest_neighbor_flip_augment():
    """tests/test_transforms_imaging.py's flip case, on the port."""
    rng = np.random.default_rng(0)
    dataset = rng.uniform(-1, 1, (5, 16, 16, 3)).astype(np.float32)
    query = dataset[2:3, :, ::-1, :].copy()
    nn_flip = ttester.get_nearest_neighbor(query, dataset, compare_size=16, flip_augment=True,
                                           device="cpu")
    np.testing.assert_allclose(nn_flip[0], dataset[2], atol=1e-5)
    assert not np.allclose(nn_flip[0], query[0])
    nn_noflip = ttester.get_nearest_neighbor(query, dataset, compare_size=16,
                                             flip_augment=False, device="cpu")
    assert not np.allclose(nn_noflip[0], query[0])


def _cfg(cls, **over):
    kw = dict(data_size=S, data_subset_num=5, sample_num=6, ddpm_schedule="linear",
              ddpm_num_steps=4, select_degrade_pixel="thresholding",
              mean_option="degraded_area", out_channel=C)
    kw.update(over)
    return cls(**kw)


def _port_tester(data, **over):
    """The port's Tester on the CPU; its sampler never runs here."""
    return ttester.Tester(_cfg(TConfig, **over), TDataset(data, np.zeros(len(data))),
                          torch.nn.Identity(), device="cpu")


def _jax_tester(data, **over):
    """The JAX Tester without its model (its sampler never runs here)."""
    t = jtester.Tester.__new__(jtester.Tester)
    t.cfg, t.dataset = _cfg(JConfig, **over), JDataset(data, np.zeros(len(data)))
    return t


def test_assign_similar_neighbor_fills_the_buckets_jax_fills():
    rng = np.random.default_rng(5)
    g = images(rng, 3)
    generated = np.stack([g[0], near_copy(rng, g[0], 0.95), g[1], near_copy(rng, g[0], 0.85),
                          g[2], near_copy(rng, g[1], TH + 1e-3)])
    idx = np.array([0, 0, 1, 0, 2, 1])
    start = [np.empty((0, S, S, C), np.float32) for _ in range(4)]
    start[2] = near_copy(rng, g[2], 0.97)[None]  # bucket 2 already holds a copy of g[2]
    out = {}
    for name, tester in (("jax", _jax_tester(g)), ("port", _port_tester(g))):
        out[name] = tester.assign_similar_neighbor(generated, [b.copy() for b in start], idx)
    (jset, jchanged), (tset, tchanged) = out["jax"], out["port"]
    assert tchanged == jchanged == {0, 1}
    for jb, tb in zip(jset, tset):
        _same_rows(tb, jb)
    # the second sample was kept out by the first, added earlier in the round
    _same_rows(tset[0], generated[[0, 3]])
    assert len(tset[1]) == 1 and len(tset[2]) == 1 and len(tset[3]) == 0


def _batches(seed=6):
    """Four rounds of 6: copies within and across rounds, 2, 3 and 6
    unique after rounds 1-3, so a target of 5 stops there (the fourth is
    never drawn)."""
    rng = np.random.default_rng(seed)
    u = images(rng, 6)
    first = np.stack([u[0], near_copy(rng, u[0], 0.99), u[1], u[1], near_copy(rng, u[0], 0.95),
                      u[0]])
    second = np.stack([near_copy(rng, u[1], 0.97)] * 3 + [u[2], u[2], u[0]])
    third = np.stack([u[0], u[3], near_copy(rng, u[3], 0.85), u[4], u[4], u[2]])
    return [first, second, third, np.stack([u[5]] * 6)]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".png"))


@pytest.mark.parametrize("max_rounds", [1000, 2])
def test_run_matches_jax_on_the_same_batches(tmp_path, monkeypatch, max_rounds):
    data = images(np.random.default_rng(7), 5)
    results, roots = {}, {}
    for name, tester, dir_cls in (("jax", _jax_tester(data), JDir),
                                  ("port", _port_tester(data), TDir)):
        seq = iter(_batches())
        monkeypatch.setattr(tester, "_sample_batch", lambda key: next(seq), raising=False)
        roots[name] = str(tmp_path / name)
        dirs = dir_cls("train", "t", roots[name], data_name="synthetic", method="test",
                       date="d", time="t")
        results[name] = tester.run(dirs, max_rounds=max_rounds)
    j, t = results["jax"], results["port"]
    assert t["rounds"] == j["rounds"] == min(3, max_rounds)
    assert t["num_unique_history"] == j["num_unique_history"]
    assert j["num_unique_history"] == [2, 3, 6][:max_rounds]
    _same_rows(t["unique_images"], j["unique_images"])
    assert len(t["img_set"]) == len(j["img_set"]) == 5
    for jb, tb in zip(j["img_set"], t["img_set"]):
        _same_rows(tb, jb)
    assert _files(roots["port"]) == _files(roots["jax"])
    names = {os.path.basename(f) for f in _files(roots["port"])}
    assert {"sample_page_0.png", "number_of_sample.png", "final_sample.png"} <= names
    assert any(n.startswith("neighbor_") for n in names)
    assert t["timed_rounds"] == t["rounds"] - 1 and t["seconds"] >= t["sample_seconds"] >= 0


def test_tester_samples_with_the_ema_weights_whenever_it_has_them():
    torch.manual_seed(0)
    model = build_unet(C, 16, 16, block_out_channels=(16, 32), layers_per_block=1)
    ema = {k: v + 1.0 for k, v in model.state_dict().items()}
    cfg = dict(data_size=16, use_ema=False, sample_latent_shape="uniform")
    data = images(np.random.default_rng(0), 2, 16)
    with_ema = ttester.Tester(_cfg(TConfig, **cfg), TDataset(data, np.zeros(2)), model, ema,
                              device="cpu")
    plain = ttester.Tester(_cfg(TConfig, **cfg), TDataset(data, np.zeros(2)), model,
                           device="cpu")
    w = "conv_in.weight"
    assert torch.equal(with_ema.model.state_dict()[w], ema[w])
    assert torch.equal(plain.model.state_dict()[w], model.state_dict()[w])
    batch = plain._sample_batch(torch.Generator().manual_seed(1))
    assert batch.shape == (6, 16, 16, C) and np.isfinite(batch).all()


# ------------------------------------------------------------------ the CLI
def _checkpoint(tmp_path):
    """A toy UNet with an EMA, written in the export layout by the port."""
    torch.manual_seed(3)
    model = build_unet(C, 16, 16, block_out_channels=(16, 32), layers_per_block=1)
    torch.nn.init.normal_(model.conv_out.weight, std=0.05)
    ckpt = str(tmp_path / "checkpoint-epoch-0")
    weights.save_checkpoint(ckpt, model.state_dict(),
                            weights.diffusers_config_from_unet(model.config),
                            ema_sd=model.state_dict())
    return ckpt


def _cli_args(work, device, *extra):
    return ["--method", "test", "--data_name", "synthetic", "--data_size", "16",
            "--data_subset", "True", "--data_subset_num", "1", "--batch_size", "4",
            "--sample_num", "3", "--ddpm_schedule", "log", "--ddpm_num_steps", "6",
            "--select_degrade_pixel", "indexing", "--mean_option", "degraded_area",
            "--block_out_channels", "16,32", "--layers_per_block", "1", "--use_wandb", "False",
            "--dir_work", str(work), "--device", device, *extra]


def test_cli_test_method_on_cpu(tmp_path, capsys):
    ckpt = _checkpoint(tmp_path)
    assert port_cli.main(_cli_args(tmp_path / "run", "cpu", "--test_model_path", ckpt)) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test_stats ")]
    stats = json.loads(line[-1].split(" ", 1)[1])
    assert stats["rounds"] >= 1 and stats["unique"] >= stats["target"] == 1
    assert stats["device"] == "cpu" and stats["ranks"] == 1 and stats["ema"]
    assert stats["steps"] == 6 and stats["sample_num"] == 3
    assert stats["images_per_sec"] > 0 and stats["ms_per_step"] > 0
    test_root = os.path.dirname(stats["out_dir"])
    names = {os.path.basename(f) for f in _files(test_root)}
    assert {"sample_page_0.png", "number_of_sample.png", "final_sample.png",
            "neighbor_0.png"} <= names, names


def test_cli_test_method_with_encoder_reuse(tmp_path, capsys, monkeypatch):
    """--method test --encoder_reuse 2: every other reverse step of a round
    replays the encoder cache (a decode-only forward), as the JAX tester's
    make_sample_fn does with the flag."""
    from masked_diffusion_tpu_torch.models.unet import UNet2D

    real, calls = UNet2D.forward, []

    def spy(self, x, t, cached=None, return_cached=False):
        calls.append(cached is not None)
        return real(self, x, t, cached=cached, return_cached=return_cached)

    monkeypatch.setattr(UNet2D, "forward", spy)
    ckpt = _checkpoint(tmp_path)
    assert port_cli.main(_cli_args(tmp_path / "run", "cpu", "--test_model_path", ckpt,
                                   "--encoder_reuse", "2")) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test_stats ")]
    stats = json.loads(line[-1].split(" ", 1)[1])
    assert stats["unique"] >= stats["target"] == 1
    assert calls == [False, True] * (3 * stats["rounds"])


def test_cli_test_method_needs_a_checkpoint_and_refuses_cuda_without_it(tmp_path):
    with pytest.raises(SystemExit, match="--test_model_path is required for --method test"):
        port_cli.main(_cli_args(tmp_path / "run", "cpu"))
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    ckpt = _checkpoint(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(_cli_args(tmp_path / "run", "cuda", "--test_model_path", ckpt))


# ------------------------------------------------------------------ 2 ranks
_WORKER = r"""
import json, os, sys
import numpy as np
import torch
from masked_diffusion_tpu_torch.config import Config
from masked_diffusion_tpu_torch.data.datasets import InMemoryDataset
from masked_diffusion_tpu_torch.models.factory import build_unet
from masked_diffusion_tpu_torch.ops.schedule import build_schedule
from masked_diffusion_tpu_torch.parallel.mesh import init_distributed, make_mesh
from masked_diffusion_tpu_torch.sample.interpolation import make_interpolation_sample_fn
from masked_diffusion_tpu_torch.tester import Tester
from masked_diffusion_tpu_torch.utils.dirs import Dir

work = sys.argv[1]
torch.set_num_threads(1)
device = init_distributed("cpu")
plan = make_mesh(2, 1, device)
torch.manual_seed(3)
model = build_unet(3, 16, 16, block_out_channels=(16, 32), layers_per_block=1)
torch.nn.init.normal_(model.conv_out.weight, std=0.05)
data = np.random.default_rng(0).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
cfg = Config(data_size=16, data_subset_num=3, sample_num=3, ddpm_schedule="log",
             ddpm_num_steps=6, select_degrade_pixel="indexing", mean_option="degraded_area",
             sample_latent_shape="uniform")
# rank 1's tree is never made: a write of its own would fail
dirs = Dir("train", "t", os.path.join(work, f"rank{plan.rank}"), data_name="synthetic",
           method="test", date="d", time="t", make_dirs=plan.rank == 0)
result = Tester(cfg, InMemoryDataset(data, np.zeros(3)), model, device=device,
                plan=plan).run(dirs, max_rounds=3)
icfg = Config(data_size=16, sample_num=3, ddpm_schedule="linear", ddpm_num_steps=6,
              select_degrade_pixel="thresholding", mean_option="degraded_area",
              momentum_adaptive="momentum", interpolation_shift=0.5)
sched = build_schedule("linear", 6, 16, "thresholding")
fn = make_interpolation_sample_fn(model, sched, icfg, sched.timesteps_for_epoch(1, 10, 1), 0.5,
                                  device="cpu", plan=plan)
interp, _ = fn(torch.Generator().manual_seed(2))
np.save(os.path.join(work, f"interp{plan.rank}.npy"), interp.numpy())
with open(os.path.join(work, f"rank{plan.rank}.json"), "w") as f:
    json.dump({"rounds": result["rounds"], "unique": len(result["unique_images"]),
               "history": result["num_unique_history"],
               "checksum": float(np.abs(result["unique_images"]).sum())}, f)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_agree_and_only_rank_0_writes(tmp_path):
    """Both ranks leave the loop in the same round with the same unique
    images; rank 1 writes nothing. The interpolation sampler's gathered
    grid on 2 ranks (3 rows padded to 4) equals one process's: its shared
    field is not folded with the rank."""
    work = str(tmp_path)
    port = str(_free_port())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, work], cwd=ROOT,
        env={**env, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT, "RANK": str(r),
             "LOCAL_RANK": str(r), "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    assert ranks[0] == ranks[1]
    assert 1 <= ranks[0]["rounds"] <= 3 and ranks[0]["history"][-1] == ranks[0]["unique"]
    assert _files(os.path.join(work, "rank0"))
    assert not os.path.exists(os.path.join(work, "rank1"))

    from masked_diffusion_tpu_torch.config import Config
    from masked_diffusion_tpu_torch.ops.schedule import build_schedule
    from masked_diffusion_tpu_torch.sample.interpolation import make_interpolation_sample_fn

    torch.manual_seed(3)
    model = build_unet(3, 16, 16, block_out_channels=(16, 32), layers_per_block=1)
    torch.nn.init.normal_(model.conv_out.weight, std=0.05)
    icfg = Config(data_size=16, sample_num=3, ddpm_schedule="linear", ddpm_num_steps=6,
                  select_degrade_pixel="thresholding", mean_option="degraded_area",
                  momentum_adaptive="momentum", interpolation_shift=0.5)
    sched = build_schedule("linear", 6, 16, "thresholding")
    fn = make_interpolation_sample_fn(model, sched, icfg, sched.timesteps_for_epoch(1, 10, 1),
                                      0.5, device="cpu")
    one, _ = fn(torch.Generator().manual_seed(2))
    for r in range(2):
        got = np.load(os.path.join(work, f"interp{r}.npy"))
        assert got.shape == (3, 16, 16, 3)
        # 2 rows a rank against 3 in one batch: the CPU convolutions sum in
        # another order (measured 2e-5 after 6 steps)
        np.testing.assert_allclose(got, one.numpy(), atol=1e-4, rtol=1e-4)
