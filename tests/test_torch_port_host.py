"""The port's own copies of the JAX package's host modules equal their
originals: the CLI parser and Config, the run-directory tree, image grids,
the data-mean histogram, the datasets with their epoch batching, and the
metrics sink.

The port imports nothing of masked_diffusion_tpu; these copies are what it
uses instead, so they are held to the same values (bitwise where the code
is the same).
"""

import dataclasses
import os

import numpy as np
import pytest

from masked_diffusion_tpu import config as jconfig
from masked_diffusion_tpu.cli import main_train_masked as jcli
from masked_diffusion_tpu.data import datasets as jdata
from masked_diffusion_tpu.data import histogram as jhist
from masked_diffusion_tpu.utils import dirs as jdirs
from masked_diffusion_tpu.utils import grids as jgrids
from masked_diffusion_tpu_torch import config as tconfig
from masked_diffusion_tpu_torch.cli import main_train_masked as tcli
from masked_diffusion_tpu_torch.data import datasets as tdata
from masked_diffusion_tpu_torch.data import histogram as thist
from masked_diffusion_tpu_torch.utils import dirs as tdirs
from masked_diffusion_tpu_torch.utils import grids as tgrids

ARGVS = [
    [],
    ["--method", "mean_shift", "--ddpm_schedule", "log", "--ddpm_num_steps", "4096",
     "--mean_option", "degraded_area", "--block_out_channels", "32,64", "--use_ema", "False",
     "--mixed_precision", "bf16", "--data_subset_label", "3"],
    ["--method", "sample", "--test_model_path", "x", "--interpolation_shift", "0.5",
     "--tinyhead_attention", "true", "--sample_latent_shape", "uniform"],
]


def test_parser_defaults_and_config_equal():
    jp, tp = jcli.build_parser(), tcli.build_parser()
    jdef = {a.dest: a.default for a in jp._actions}
    tdef = {a.dest: a.default for a in tp._actions}
    assert jdef == tdef
    assert [f.name for f in dataclasses.fields(jconfig.Config)] == \
        [f.name for f in dataclasses.fields(tconfig.Config)]
    for argv in ARGVS:
        jc = jcli.config_from_args(jp.parse_args(argv))
        tc = tcli.config_from_args(tp.parse_args(argv))
        assert jc.to_dict() == tc.to_dict(), argv
    assert tcli.str2bool("True") and not tcli.str2bool("no") and tcli.str2bool(True)


def test_config_helpers_equal():
    for opt in (0, "0", 0.5, "degraded_area", "non_degraded_area"):
        assert tconfig.parse_mean_option(opt) == jconfig.parse_mean_option(opt)
    with pytest.raises(ValueError):
        tconfig.parse_mean_option("bogus")
    bad = tconfig.Config(select_degrade_pixel="indexing", sampling_mask_dependency="dependent_t")
    with pytest.raises(ValueError, match="dependent_t"):
        tconfig.validate_sampling_modes(bad)
    with pytest.raises(ValueError, match="dependent_t"):
        jconfig.validate_sampling_modes(bad)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, subs, files in os.walk(root) for f in subs + files)


@pytest.mark.parametrize("task,method", [("train", "mean_shift"), ("train", "base"),
                                         ("sample", "sample")])
def test_dir_builds_the_same_tree(tmp_path, task, method):
    kw = dict(task=task, content="c", dir_dataset="d", data_name="synthetic",
              data_set="train", data_size=16, date="2026", time="01", method=method, title="t")
    jd = jdirs.Dir(dir_work=str(tmp_path / "j"), **kw)
    td = tdirs.Dir(dir_work=str(tmp_path / "t"), **kw)
    assert _tree(tmp_path / "j") == _tree(tmp_path / "t")
    assert sorted(jd.list_dir) == sorted(td.list_dir)


def test_grids_write_identical_bytes(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(5, 8, 8, 3)).astype(np.float32)
    for norm in ("global", "image"):
        gj = jgrids.save_image_grid(imgs, norm, str(tmp_path), f"j_{norm}.png")
        gt = tgrids.save_image_grid(imgs, norm, str(tmp_path), f"t_{norm}.png")
        np.testing.assert_array_equal(gj, gt)
        assert (tmp_path / f"j_{norm}.png").read_bytes() == (tmp_path / f"t_{norm}.png").read_bytes()
    np.testing.assert_array_equal(jgrids.normalize01(imgs), tgrids.normalize01(imgs))


@pytest.mark.parametrize("area", ["image-wise", "channel-wise"])
def test_histogram_equal(area):
    data = np.random.default_rng(1).uniform(-1, 1, size=(40, 4, 4, 3)).astype(np.float32)
    j, t = jhist.compute_mean_histogram(data, 10, area), thist.compute_mean_histogram(data, 10, area)
    assert j[0] == t[0]
    for a, b in zip(j[1], t[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j[2], t[2])
    assert thist.empty_histogram() == jhist.empty_histogram()


@pytest.mark.parametrize("name,size", [("synthetic", 16), ("digits", 16)])
def test_datasets_and_batches_equal(name, size):
    kw = dict(data_subset=True, num_data=40, seed=3)
    jd = jdata.get_dataset("", name, size, **kw)
    td = tdata.get_dataset("", name, size, **kw)
    np.testing.assert_array_equal(jd.data, td.data)
    np.testing.assert_array_equal(jd.labels, td.labels)
    np.testing.assert_array_equal(jd.random, td.random)
    assert td.num_batches(8) == jd.num_batches(8) == 5
    for seed, epoch in ((0, 0), (0, 3), (7, 1)):
        jb = list(jd.epoch_index_batches(np.random.default_rng([seed, epoch]), 8, start=1))
        tb = list(td.epoch_index_batches(np.random.default_rng([seed, epoch]), 8, start=1))
        assert jb[0] is None and tb[0] is None
        for a, b in zip(jb[1:], tb[1:]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jd.epoch_batches(np.random.default_rng([seed, epoch]), 8),
                        td.epoch_batches(np.random.default_rng([seed, epoch]), 8)):
            np.testing.assert_array_equal(a, b)


def test_image_folder_and_resize_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    for cls in ("a", "b"):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            arr = rng.integers(0, 255, size=(20, 30, 3), dtype=np.uint8)
            Image.fromarray(arr).save(tmp_path / cls / f"{i}.png")
    jd = jdata.get_dataset(str(tmp_path), "folder", 12)
    td = tdata.get_dataset(str(tmp_path), "folder", 12)
    np.testing.assert_array_equal(jd.data, td.data)
    np.testing.assert_array_equal(jd.labels, td.labels)


def test_visualizer_writes_the_same_files(tmp_path):
    import json

    from masked_diffusion_tpu.utils import visualizer as jvis
    from masked_diffusion_tpu_torch.utils import visualizer as tvis

    cfg = tconfig.Config(use_wandb=False)
    grid = np.random.default_rng(4).uniform(-0.2, 1.2, size=(12, 12, 3)).astype(np.float32)
    rows = {}
    for name, mod in (("j", jvis), ("t", tvis)):
        vis = mod.Visualizer(cfg, str(tmp_path / name))
        for epoch in (0, 1):
            vis.plot_current_losses(epoch, {"train_loss": 0.25 + epoch, "lr": np.float32(1e-4)})
        vis.display_current_results(1, {"ema_sample_global": grid, "skipped": None})
        vis.finish()
        with open(tmp_path / name / "metrics.jsonl") as f:
            rows[name] = [{k: v for k, v in json.loads(ln).items() if k != "time"} for ln in f]
    assert rows["j"] == rows["t"] and [r["epoch"] for r in rows["t"]] == [0, 1]
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
    png = "ema_sample_global_00001.png"
    assert (tmp_path / "j" / png).read_bytes() == (tmp_path / "t" / png).read_bytes()



# ------------------------------------------------- the legacy path's helpers


@pytest.fixture
def moment_batches():
    """tests/test_transforms_imaging.py's batches."""
    rng = np.random.default_rng(0)
    return (rng.normal(0.3, 1.5, size=(4, 8, 8, 3)).astype(np.float32),
            rng.normal(-0.2, 0.5, size=(4, 8, 8, 3)).astype(np.float32))


def test_transforms_equal(moment_batches):
    from masked_diffusion_tpu.data import transforms as jT
    from masked_diffusion_tpu_torch.data import transforms as tT

    a, b = moment_batches
    for name in ("normalize_mean", "normalize_mean_channel", "normalize", "normalize_channel"):
        np.testing.assert_array_equal(getattr(tT, name)(a, b), getattr(jT, name)(a, b), name)
    for name in ("make_mean_zero", "whiten", "normalize01", "normalize01_global"):
        np.testing.assert_array_equal(getattr(tT, name)(a), getattr(jT, name)(a), name)


def test_imaging_equal(tmp_path):
    import torch

    from masked_diffusion_tpu.utils import imaging as jim
    from masked_diffusion_tpu_torch.utils import imaging as tim

    batch = np.random.default_rng(1).uniform(-1, 1, (4, 8, 8, 3)).astype(np.float32)
    for args in ((batch,), (batch[0],), (batch, False), (batch[:3, ..., :1],)):
        np.testing.assert_array_equal(tim.tensor2im(*args), jim.tensor2im(*args))
    tree = {"a": np.ones((2, 2)), "b": {"c": 3.0 * np.ones((4,))}}
    assert tim.diagnose_network(tree) == jim.diagnose_network(tree) == pytest.approx(2.0)
    assert tim.diagnose_network({}) == jim.diagnose_network({}) == 0.0
    # a module's parameters, and tensors in a list, reduce as the same arrays do
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Linear(4, 2))
    named = {k: v.detach().numpy() for k, v in net.named_parameters()}
    want = jim.diagnose_network(named)
    assert tim.diagnose_network(net) == pytest.approx(want, rel=1e-6)
    assert tim.diagnose_network(list(net.parameters())) == pytest.approx(want, rel=1e-6)
    batches = [np.full((4, 4, 4, 3), i, dtype=np.float32) for i in range(3)]
    for nrow in (None, 2):
        np.testing.assert_array_equal(tim.make_multi_grid(batches, nrow=nrow),
                                      jim.make_multi_grid(batches, nrow=nrow))
    img = jim.tensor2im(batch)
    for size in (None, 20):
        jim.save_image(img, str(tmp_path / "j" / f"{size}.png"), size)
        tim.save_image(img, str(tmp_path / "t" / f"{size}.png"), size)
        assert (tmp_path / "j" / f"{size}.png").read_bytes() == \
            (tmp_path / "t" / f"{size}.png").read_bytes()


def test_saliency_pairs_equal(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    img_dir, mask_dir = tmp_path / "Stimuli", tmp_path / "GT"
    img_dir.mkdir()
    mask_dir.mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 255, (12, 14, 3), dtype=np.uint8)).save(
            img_dir / f"im{i}.png")
        Image.fromarray(rng.integers(0, 255, (12, 14), dtype=np.uint8)).save(
            mask_dir / f"im{i}.png")
    Image.fromarray(np.zeros((12, 12, 3), dtype=np.uint8)).save(img_dir / "orphan.png")
    for limit in (None, 4):
        jd = jdata.load_saliency_pairs(str(img_dir), str(mask_dir), 8, limit)
        td = tdata.load_saliency_pairs(str(img_dir), str(mask_dir), 8, limit)
        assert len(td) == len(jd) == (5 if limit is None else 4)
        np.testing.assert_array_equal(td.images, jd.images)
        np.testing.assert_array_equal(td.masks, jd.masks)
        for (ji, jm), (ti, tm) in zip(jd.epoch_batches(np.random.default_rng(3), 2),
                                      td.epoch_batches(np.random.default_rng(3), 2)):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tm, jm)
    with pytest.raises(FileNotFoundError):
        tdata.load_saliency_pairs(str(img_dir), str(tmp_path), 8)
