"""The port's native preprocessing library against the JAX package's.

masked_diffusion_tpu_torch/native is a copy of masked_diffusion_tpu/native:
its preprocess.cc equals the original byte for byte below its header, both
build with g++ (skipped where there is none), and their outputs are bitwise
equal on single, batch, grayscale and float inputs. Under
MDT_NATIVE_PREPROCESS=1 get_dataset on digits and on an image folder equals
the JAX package's bitwise and names the backend 'native'; the outputs equal
the numpy bilinear reference within 1e-5. MDT_DISABLE_NATIVE makes
get_lib() None, as in the original, and the loaders then take PIL.
"""

import os
import shutil

import numpy as np
import pytest

from masked_diffusion_tpu import native as jnative
from masked_diffusion_tpu.data import datasets as jdata
from masked_diffusion_tpu_torch import native as tnative
from masked_diffusion_tpu_torch.data import datasets as tdata

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ to build the library")


def _fresh(monkeypatch, mod):
    monkeypatch.setattr(mod, "_TRIED", False)
    monkeypatch.setattr(mod, "_LIB", None)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both libraries built afresh once, each into a cache directory of its
    own, and loaded for the module's tests."""
    root = tmp_path_factory.mktemp("native")
    with pytest.MonkeyPatch.context() as mp:
        for mod, sub in ((jnative, "jax"), (tnative, "port")):
            mp.setenv("MDT_NATIVE_CACHE", str(root / sub))
            mp.delenv("MDT_DISABLE_NATIVE", raising=False)
            _fresh(mp, mod)
            assert mod.get_lib() is not None
        assert os.listdir(root / "port") and os.listdir(root / "jax")
        assert tnative.lib_path.startswith(str(root / "port"))
        yield root


def test_source_is_the_original_below_its_header():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "masked_diffusion_tpu", "native", "preprocess.cc"), "rb") as f:
        original = f.read()
    with open(os.path.join(root, "masked_diffusion_tpu_torch", "native", "preprocess.cc"),
              "rb") as f:
        copy = f.read()
    header = copy[: len(copy) - len(original)]
    assert copy.endswith(original) and header
    assert all(ln.startswith(b"//") for ln in header.splitlines())
    assert tnative._CXX_FLAGS == jnative._CXX_FLAGS


def _inputs(kind, rng):
    if kind == "single":
        return rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    if kind == "batch":
        return rng.integers(0, 255, (6, 48, 40, 1), dtype=np.uint8)
    if kind == "grayscale":
        return rng.integers(0, 255, (28, 28), dtype=np.uint8)
    return rng.uniform(0, 1, (20, 31, 3)).astype(np.float32)


@needs_gxx
@pytest.mark.parametrize("kind", ["single", "batch", "grayscale", "float"])
@pytest.mark.parametrize("to_pm1", [False, True])
def test_outputs_bitwise_equal_the_jax_library(libs, kind, to_pm1):
    img = _inputs(kind, np.random.default_rng(0))
    fn = "preprocess_batch_native" if kind == "batch" else "resize_center_crop_native"
    t = getattr(tnative, fn)(img, 16, to_pm1=to_pm1)
    j = getattr(jnative, fn)(img, 16, to_pm1=to_pm1)
    assert t.dtype == np.float32 and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


@needs_gxx
def test_outputs_match_the_numpy_bilinear_reference(libs):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (37, 53, 3), dtype=np.uint8)
    out = tnative.resize_center_crop_native(img, 16)
    ref = tdata._bilinear_resize(img.astype(np.float32), 16, 23) / 255.0
    np.testing.assert_allclose(out, ref[:, 3:19], rtol=0, atol=1e-5)
    batch = rng.integers(0, 255, (4, 48, 40, 1), dtype=np.uint8)
    out = tnative.preprocess_batch_native(batch, 16)
    for i in range(4):
        ref = tdata._bilinear_resize(batch[i].astype(np.float32), 19, 16) / 255.0
        np.testing.assert_allclose(out[i], ref[1:17], rtol=0, atol=1e-5)


def _folder(root):
    from PIL import Image

    rng = np.random.default_rng(2)
    for cls in ("a", "b"):
        os.makedirs(os.path.join(root, cls))
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)).save(
                os.path.join(root, cls, f"{i}.png"))
    return root


@needs_gxx
@pytest.mark.parametrize("name", ["digits", "folder"])
def test_native_get_dataset_equals_jax(libs, monkeypatch, tmp_path, name):
    path = _folder(str(tmp_path / "images")) if name == "folder" else ""
    kw = dict(data_subset=True, num_data=24, seed=1)
    monkeypatch.setenv("MDT_NATIVE_PREPROCESS", "1")
    td = tdata.get_dataset(path, name, 12, **kw)
    jd = jdata.get_dataset(path, name, 12, **kw)
    assert td.backend == "native" and tdata.preprocess_backend() == "native"
    np.testing.assert_array_equal(td.data, jd.data)
    np.testing.assert_array_equal(td.labels, jd.labels)
    # the default backend is PIL's antialiased resize: other numbers
    monkeypatch.delenv("MDT_NATIVE_PREPROCESS")
    pil = tdata.get_dataset(path, name, 12, **kw)
    assert pil.backend == "pil" and not np.array_equal(pil.data, td.data)


def test_disable_env_gives_none_as_in_the_original(monkeypatch):
    monkeypatch.setenv("MDT_DISABLE_NATIVE", "1")
    for mod in (tnative, jnative):
        _fresh(monkeypatch, mod)
        assert mod.get_lib() is None and not mod.available()
        assert mod.resize_center_crop_native(np.zeros((8, 8, 3), np.uint8), 4) is None
        assert mod.preprocess_batch_native(np.zeros((2, 8, 8, 3), np.uint8), 4) is None
    # the loaders carry on with PIL, and say so
    monkeypatch.setenv("MDT_NATIVE_PREPROCESS", "1")
    kw = dict(data_subset=True, num_data=8)
    td = tdata.get_dataset("", "digits", 12, **kw)
    assert td.backend == "pil"
    np.testing.assert_array_equal(td.data, jdata.get_dataset("", "digits", 12, **kw).data)
