"""The port's Hugging Face adapter (data/hugging.py) against the JAX
package's, on tests/test_hugging_adapter.py's faked hub: datasets.Dataset.
from_dict stands in for the hub and load_dataset honours the reference's
split-slicing expression (datasetutilsHugging.py:103). Arrays and labels
are bitwise equal, and so are the split slicing, the metfaces name, the
refusal of an unknown name and get_dataset's label_filter refusal."""

import re

import numpy as np
import pytest

datasets = pytest.importorskip("datasets")

from masked_diffusion_tpu.data import datasets as jdata  # noqa: E402
from masked_diffusion_tpu.data import hugging as jhug  # noqa: E402
from masked_diffusion_tpu_torch.data import datasets as tdata  # noqa: E402
from masked_diffusion_tpu_torch.data import hugging as thug  # noqa: E402


@pytest.fixture
def fake_hub(monkeypatch):
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (12, 12), dtype=np.uint8) for _ in range(10)]
    ds = datasets.Dataset.from_dict({"image": imgs, "label": list(range(10))})
    calls = []

    def fake_load_dataset(name, split=None):
        calls.append((name, split))
        m = re.match(r"^(\w+)\[(\d+):(\d+)\]$", split or "")
        if m:
            return ds.select(range(int(m.group(2)), int(m.group(3))))
        return ds

    monkeypatch.setattr(datasets, "load_dataset", fake_load_dataset)
    return calls


@pytest.mark.parametrize("kw", [
    dict(),
    dict(data_subset=True, num_data=4),
    dict(use_augment=True, seed=3),
], ids=["whole", "sliced", "augment"])
def test_adapter_equals_jax(fake_hub, kw):
    t = thug.load_hf_dataset("mnist", 8, "train", **kw)
    j = jhug.load_hf_dataset("mnist", 8, "train", **kw)
    assert fake_hub[0] == fake_hub[1]
    assert fake_hub[0] == ("mnist", "train[0:4]" if kw.get("data_subset") else "train")
    assert t.data.shape == (4 if kw.get("data_subset") else 10, 8, 8, 1)
    for key in ("data", "labels", "random"):
        np.testing.assert_array_equal(getattr(t, key), getattr(j, key))


@pytest.mark.parametrize("path", ["/data/hugging", "hugging_face/x"])
def test_get_dataset_routes_hugging_paths_alike(fake_hub, path):
    assert thug.is_hugging_path(path) and jhug.is_hugging_path(path)
    t = tdata.get_dataset(path, "metfaces", 8, data_subset=True, num_data=3)
    j = jdata.get_dataset(path, "metfaces", 8, data_subset=True, num_data=3)
    assert fake_hub[0] == fake_hub[1] == ("huggan/metfaces", "train[0:3]")
    assert t.backend == "pil"
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert not thug.is_hugging_path("") and not thug.is_hugging_path(None)


def test_unknown_name_and_label_filter_refused_alike(fake_hub):
    assert thug.has_hf_datasets() and jhug.has_hf_datasets()
    for mod in (thug, jhug):
        with pytest.raises(ValueError, match="unsupported huggingface dataset: 'imagenet'"):
            mod.load_hf_dataset("imagenet", 8)
    for mod in (tdata, jdata):
        with pytest.raises(NotImplementedError, match="label_filter"):
            mod.get_dataset("/data_hugging", "mnist", 8, label_filter=3)
    assert not fake_hub  # refused before the hub is asked
