"""LSUN LMDB archives in the port against the JAX package.

The port's LMDBReader (masked_diffusion_tpu_torch/data/lmdb_reader.py)
returns the JAX reader's (key, value) list on archives written by the
port's fixture writer (masked_diffusion_tpu_torch/tools/lmdb_write.py):
one leaf page, branch pages, overflow chains, both; both readers refuse a
bad magic and a missing file alike; the writer's archive is byte for byte
tests/test_lmdb.py's. Then get_dataset(..., "lsun", ...) gives arrays and
labels bitwise equal to the JAX package's, with and without data_subset, an
exported-images directory falls through to the image-folder scan in both,
and an unknown split raises the same ValueError. Last, the dataset dump
(save_dataset / load_saved_dataset) written by either package loads in the
other.
"""

import io
import os

import numpy as np
import pytest

from masked_diffusion_tpu.data import datasets as jdata
from masked_diffusion_tpu.data import lmdb_reader as jlmdb
from masked_diffusion_tpu_torch.data import datasets as tdata
from masked_diffusion_tpu_torch.data import lmdb_reader as tlmdb
from masked_diffusion_tpu_torch.tools.lmdb_write import PSIZE, write_lmdb
from tests import test_lmdb


def _items(rng, n, size):
    return {f"k{i:03d}".encode(): rng.bytes(int(size)) for i in range(n)}


# name: (items, use_branch, bigdata_keys)
def _archive(kind, rng):
    if kind == "leaf":
        return {b"a": b"alpha", b"b": b"beta" * 10, b"c": b"\x00\xff" * 7}, False, ()
    if kind == "branch":
        return _items(rng, 40, 20), True, ()
    if kind == "overflow":
        return {b"big": rng.bytes(3 * PSIZE + 123), b"small": b"x"}, False, {b"big"}
    # branch pages over leaves whose values all spill to overflow chains
    return _items(rng, 24, 2 * PSIZE - 7), True, ()


@pytest.mark.parametrize("kind", ["leaf", "branch", "overflow", "branch+overflow"])
def test_reader_equals_the_jax_reader(tmp_path, kind):
    items, use_branch, big = _archive(kind, np.random.default_rng(0))
    env = write_lmdb(str(tmp_path / "env"), items, use_branch=use_branch, bigdata_keys=big)
    with tlmdb.LMDBReader(env) as t, jlmdb.LMDBReader(env) as j:
        got = list(t.items())
        assert got == list(j.items())
        assert len(t) == len(j) == len(items) and t.psize == j.psize == PSIZE
    assert [k for k, _ in got] == sorted(items) and dict(got) == items
    # the data.mdb path itself reads the same as its directory
    with tlmdb.LMDBReader(os.path.join(env, "data.mdb")) as t:
        assert list(t.items()) == got


@pytest.mark.parametrize("case", ["bad magic", "missing file"])
def test_reader_refusals_equal(tmp_path, case):
    env = tmp_path / "env"
    if case == "bad magic":
        env.mkdir()
        (env / "data.mdb").write_bytes(b"\x00" * 8192)
        errors = (tlmdb.LMDBFormatError, jlmdb.LMDBFormatError)
    else:
        errors = (FileNotFoundError, FileNotFoundError)
    for mod, error in zip((tlmdb, jlmdb), errors):
        with pytest.raises(error, match="magic" if case == "bad magic" else "env"):
            mod.LMDBReader(str(env))


@pytest.mark.parametrize("use_branch", [False, True])
def test_writer_is_the_test_suites_writer(tmp_path, use_branch):
    """tools/lmdb_write.py lays out the bytes tests/test_lmdb.py's writer
    does, and the JAX reader reads them."""
    rng = np.random.default_rng(1)
    items = {**_items(rng, 12, 30), b"zz-big": rng.bytes(PSIZE + 5)}
    ours = write_lmdb(str(tmp_path / "ours"), items, use_branch=use_branch)
    theirs = test_lmdb.write_lmdb(str(tmp_path / "theirs"), items, use_branch=use_branch)
    with open(os.path.join(ours, "data.mdb"), "rb") as a, \
            open(os.path.join(theirs, "data.mdb"), "rb") as b:
        assert a.read() == b.read()
    with jlmdb.LMDBReader(ours) as j:
        assert dict(j.items()) == items


def _jpeg(rng, h, w):
    """A smooth image (JPEG keeps it near its source) as JPEG bytes."""
    from PIL import Image

    ys, xs = np.mgrid[0:h, 0:w] / max(h, w)
    phase = rng.uniform(0, 2 * np.pi, size=3)
    img = 127.5 + 100 * np.sin(4 * xs[..., None] + 3 * ys[..., None] + phase)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.fixture(scope="module")
def lsun_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lsun_data")
    rng = np.random.default_rng(2)
    items = {f"{i:040x}".encode(): _jpeg(rng, 30 + i % 3, 40) for i in range(6)}
    write_lmdb(str(root / "lsun" / "church_outdoor_train_lmdb"), items, use_branch=True)
    return str(root)


@pytest.mark.parametrize("subset", [False, True])
def test_lsun_dataset_equals_jax(lsun_root, subset):
    kw = dict(split="church", data_subset=subset, num_data=4, seed=5)
    td = tdata.get_dataset(lsun_root, "lsun", 16, **kw)
    jd = jdata.get_dataset(lsun_root, "lsun", 16, **kw)
    assert td.data.shape == (4 if subset else 6, 16, 16, 3) and td.backend == "pil"
    np.testing.assert_array_equal(td.data, jd.data)
    np.testing.assert_array_equal(td.labels, jd.labels)
    np.testing.assert_array_equal(td.random, jd.random)
    assert td.data.std() > 0.05  # decoded image content


def test_lsun_exported_images_fall_through_to_the_folder_scan(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    os.makedirs(tmp_path / "lsun" / "church")
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (20, 24, 3), dtype=np.uint8)).save(
            tmp_path / "lsun" / "church" / f"{i}.png")
    td = tdata.get_dataset(str(tmp_path), "lsun", 8, split="church")
    jd = jdata.get_dataset(str(tmp_path), "lsun", 8, split="church")
    assert td.data.shape == (3, 8, 8, 3)
    np.testing.assert_array_equal(td.data, jd.data)


def test_unknown_lsun_split_raises_alike(tmp_path):
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match="unknown LSUN split 'kitchenette'"):
            mod.load_lsun(str(tmp_path), "kitchenette", 16)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dataset_dump_reads_in_the_other_package(tmp_path, writer):
    ds = tdata.get_dataset("", "synthetic", 8, data_subset=True, num_data=6, seed=4)
    path = str(tmp_path / "dump" / "dataset.npz")
    (tdata if writer == "port" else jdata).save_dataset(ds, path)
    reader = jdata if writer == "port" else tdata
    back = reader.load_saved_dataset(path)
    for key in ("data", "labels", "random"):
        np.testing.assert_array_equal(getattr(back, key), getattr(ds, key))
    with np.load(path) as z:
        assert sorted(z.files) == ["data", "labels", "random"]
