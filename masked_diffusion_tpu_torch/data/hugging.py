"""HuggingFace datasets adapter (utils/datasetutilsHugging.py:51-173).

The reference selects this path when 'hugging' appears in --dir_dataset
(main_train_masked.py:47-49) and supports mnist (with `train[0:N]` split
slicing, :103) and huggan/metfaces (:138), converting through the same
resize+crop+normalize transform chain. Here the adapter is import-gated: the
`datasets` library is optional in the build image, and everything downstream
consumes the same InMemoryDataset contract as the native loaders.

A copy of masked_diffusion_tpu/data/hugging.py; the port imports nothing of
the JAX package. `datasets` is imported inside load_hf_dataset only, so the
port imports where it is not installed. tests/test_torch_port_hugging.py
holds it equal to the original on a faked hub.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from masked_diffusion_tpu_torch.data.datasets import (
    InMemoryDataset,
    normalize_global,
    resize_center_crop,
    whiten,
)


def has_hf_datasets() -> bool:
    try:
        import datasets  # noqa: F401

        return True
    except ImportError:
        return False


_HF_NAMES = {
    "mnist": "mnist",
    "metfaces": "huggan/metfaces",
    "huggan/metfaces": "huggan/metfaces",
}


def load_hf_dataset(
    name: str,
    size: int,
    split: str = "train",
    data_subset: bool = False,
    num_data: int = 0,
    use_augment: bool = False,
    seed: int = 0,
) -> InMemoryDataset:
    """Load an HF dataset into the in-memory contract.

    Split slicing mirrors datasetutilsHugging.py:103 (`train[0:N]`); metfaces
    has only a train split (:138). Raises ImportError when `datasets` is not
    installed — callers gate on has_hf_datasets().
    """
    import datasets as hf

    hf_name = _HF_NAMES.get(name.lower())
    if hf_name is None:
        raise ValueError(f"unsupported huggingface dataset: {name!r}")

    if data_subset and num_data:
        split_expr = f"{split}[0:{num_data}]"
    else:
        split_expr = split
    ds = hf.load_dataset(hf_name, split=split_expr)

    img_key = "image" if "image" in ds.column_names else ds.column_names[0]
    label_key = "label" if "label" in ds.column_names else None

    imgs, labels = [], []
    for row in ds:
        arr = np.asarray(row[img_key])
        if arr.ndim == 2:
            arr = arr[..., None]
        imgs.append(resize_center_crop(arr, size))
        labels.append(int(row[label_key]) if label_key else 0)
    data = np.stack(imgs)

    if use_augment:
        data = np.stack([whiten(im) for im in data])
    else:
        data = normalize_global(data)
    return InMemoryDataset(data.astype(np.float32), np.asarray(labels), seed=seed)


def is_hugging_path(dir_dataset: Optional[str]) -> bool:
    """The reference's dispatch rule (main_train_masked.py:47-49)."""
    return bool(dir_dataset) and "hugging" in str(dir_dataset)
