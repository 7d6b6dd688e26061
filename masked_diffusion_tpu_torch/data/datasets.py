"""In-memory datasets (NHWC numpy) and transforms.

A copy of the parts of masked_diffusion_tpu/data/datasets.py that the CLI's
data path reaches; the port imports nothing of the JAX package.
tests/test_torch_port_host.py, tests/test_torch_port_lmdb.py and
tests/test_torch_port_native.py hold it equal to the original.

The reference's live data path (utils/mydataset.py:235-278) preloads the whole
dataset into RAM tensors and attaches a fixed per-item uniform random vector;
batches then index those tensors. Datasets become numpy arrays once at
startup, epoch iteration is a shuffled gather.

Dataset families (utils/mydataset.py:63-210):
  mnist      : raw IDX files under {path}/MNIST/raw (torchvision layout, also
               accepts .gz).
  cifar10    : python pickles under {path}/CIFAR/cifar-10-batches-py.
  imagefolder: recursive PIL scan — covers celeba_hq / afhqv2 / metfaces /
               stanfordcars / flowers102 directory layouts.
  lsun       : native LMDB archives ({path}/lsun/<class>_lmdb, the
               torchvision-LSUN layout, mydataset.py:132-141) via the
               pure-Python reader in data/lmdb_reader.py; an exported-images
               directory falls back to the ImageFolder scan.
  synthetic  : deterministic procedural images (gaussian blobs); no files.
  digits     : scikit-learn's bundled handwritten-digit set (1797 8x8
               grayscale images, upscaled).
  hugging    : a --dir_dataset containing 'hugging' routes through the
               Hugging Face adapter (data/hugging.py; main_train_masked.py:
               47-49), where the `datasets` package is installed.

Preprocessing backends (preprocess_backend(), recorded on the dataset as
`backend`): 'native', the C++ library of masked_diffusion_tpu_torch/native
(plain bilinear, OpenMP), when MDT_NATIVE_PREPROCESS is truthy or PIL is
missing and the library builds; else 'pil' (antialiased bilinear,
torchvision-matching); else 'numpy' (plain bilinear). The synthetic family
is generated at its final size and records 'numpy'.

save_dataset / load_saved_dataset dump and reload the preloaded arrays as
one .npz with the JAX package's keys, so each package reads the other's.

Transforms mirror utils/mydataset.py:64-83: Resize(short side) + CenterCrop +
ToTensor, then either global Normalize([0.5],[0.5]) ([-1,1]) or per-image
whitening (augment path).
"""

from __future__ import annotations

import glob
import gzip
import os
import pickle
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

try:  # PIL is present in the image; guard anyway
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".ppm", ".tif", ".tiff")


def _native_preprocess_enabled() -> bool:
    """Opt-in flag for the C++ preprocessing path ('0'/'false' disable)."""
    return os.environ.get("MDT_NATIVE_PREPROCESS", "").lower() in ("1", "true", "yes")


def preprocess_backend() -> str:
    """The backend resize_center_crop and _preprocess_uniform_batch take in
    this process: 'native', 'pil' or 'numpy' (the order of their dispatch)."""
    if _native_preprocess_enabled() or not _HAS_PIL:
        from masked_diffusion_tpu_torch import native

        if native.available():
            return "native"
    return "pil" if _HAS_PIL else "numpy"


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Resize the short side to `size` (bilinear) then center-crop to
    size x size — torchvision Resize+CenterCrop semantics. img is HWC uint8
    or float in [0,1].

    Backend order: the native C++ pipeline (masked_diffusion_tpu_torch.
    native, OpenMP, classic pixel-center bilinear — identical algorithm to
    the numpy fallback below) when MDT_NATIVE_PREPROCESS is truthy or PIL is
    missing; else PIL (antialiased bilinear, torchvision-matching); else
    numpy."""
    if _native_preprocess_enabled() or not _HAS_PIL:
        from masked_diffusion_tpu_torch import native

        out = native.resize_center_crop_native(img, size)
        if out is not None:
            return out
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    if (nh, nw) != (h, w):
        if _HAS_PIL:
            arr = img if img.dtype == np.uint8 else (np.clip(img, 0, 1) * 255).astype(np.uint8)
            if arr.shape[-1] == 1:
                pil = Image.fromarray(arr[..., 0], mode="L")
            else:
                pil = Image.fromarray(arr)
            pil = pil.resize((nw, nh), Image.BILINEAR)
            img = np.asarray(pil, dtype=np.float32) / 255.0
            if img.ndim == 2:
                img = img[..., None]
        else:  # numpy bilinear fallback
            img = _bilinear_resize(img.astype(np.float32), nh, nw)
            if img.dtype == np.uint8:
                img = img / 255.0
    else:
        img = img.astype(np.float32)
        if img.max() > 1.5:
            img = img / 255.0
    if img.max() > 1.5:  # resized from uint8 path already scaled; guard raw
        img = img / 255.0
    top = (img.shape[0] - size) // 2
    left = (img.shape[1] - size) // 2
    return img[top : top + size, left : left + size]


def _bilinear_resize(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(nh) + 0.5) * h / nh - 0.5
    xs = (np.arange(nw) + 0.5) * w / nw - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx + c * wy * (1 - wx) + d * wy * wx


def normalize_global(img: np.ndarray) -> np.ndarray:
    """[0,1] -> [-1,1] (Normalize([0.5],[0.5]), mydataset.py:81)."""
    return img * 2.0 - 1.0


def whiten(img: np.ndarray) -> np.ndarray:
    """Per-image zero-mean unit-std (mydataset.py:70)."""
    std = img.std()
    return (img - img.mean()) / (std if std > 0 else 1.0)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def load_mnist_idx(path: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read raw MNIST IDX files from {path}/MNIST/raw (torchvision layout)."""
    raw = os.path.join(path, "MNIST", "raw")
    prefix = "train" if split == "train" else "t10k"
    with _open_maybe_gz(os.path.join(raw, f"{prefix}-images-idx3-ubyte")) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad MNIST magic {magic}")
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols, 1)
    with _open_maybe_gz(os.path.join(raw, f"{prefix}-labels-idx1-ubyte")) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad MNIST magic {magic}")
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    return images, labels.astype(np.int64)


def load_cifar10(path: str, split: str) -> Tuple[np.ndarray, np.ndarray]:
    base = os.path.join(path, "CIFAR", "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = os.path.join(path, "cifar-10-batches-py")
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if split == "train" else ["test_batch"]
    )
    imgs, labels = [], []
    for fn in files:
        with open(os.path.join(base, fn), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        labels.extend(d[b"labels"])
    return np.concatenate(imgs), np.asarray(labels, dtype=np.int64)


def load_image_folder(root: str, limit: Optional[int] = None) -> Tuple[list, np.ndarray]:
    """Recursive scan; class = first-level subdirectory (ImageFolder layout)."""
    if not _HAS_PIL:
        raise RuntimeError("PIL required for image-folder datasets")
    paths = sorted(
        p
        for p in glob.glob(os.path.join(root, "**", "*"), recursive=True)
        if p.lower().endswith(IMG_EXTENSIONS)
    )
    if limit is not None:
        paths = paths[:limit]
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    classes = sorted({os.path.relpath(p, root).split(os.sep)[0] for p in paths})
    cls_idx = {c: i for i, c in enumerate(classes)}
    labels = np.asarray(
        [cls_idx[os.path.relpath(p, root).split(os.sep)[0]] for p in paths], dtype=np.int64
    )
    return paths, labels


# torchvision LSUN's split -> lmdb class mapping as the reference uses it
# (mydataset.py:132-141: church/bedroom/tower -> <class>_train)
_LSUN_CLASSES = {
    "church": "church_outdoor_train",
    "bedroom": "bedroom_train",
    "tower": "tower_train",
}


def load_lsun(
    path: str, split: str, size: int, limit: Optional[int] = None
) -> np.ndarray:
    """Load an LSUN LMDB archive (reference mydataset.py:132-141 semantics:
    split in {church, bedroom, tower} -> <path>/<class>_lmdb/data.mdb) via
    the pure-Python reader in data/lmdb_reader.py. Values are JPEG/WebP
    bytes; decoded + resize/center-cropped like every other image family.
    """
    import io as _io

    from masked_diffusion_tpu_torch.data.lmdb_reader import LMDBReader

    if not _HAS_PIL:
        raise RuntimeError("PIL required for LSUN decoding")
    cls = _LSUN_CLASSES.get(split, split if split.endswith("_train") else None)
    if cls is None:
        raise ValueError(
            f"unknown LSUN split {split!r} (expected church/bedroom/tower or "
            f"an explicit <class>_train name)"
        )
    env_dir = os.path.join(path, f"{cls}_lmdb")
    imgs = []
    with LMDBReader(env_dir) as reader:
        for _key, val in reader.items():
            img = np.asarray(
                Image.open(_io.BytesIO(val)).convert("RGB"), dtype=np.uint8
            )
            imgs.append(resize_center_crop(img, size))
            if limit is not None and len(imgs) >= limit:
                break
    if not imgs:
        raise FileNotFoundError(f"no images in {env_dir}")
    return np.stack(imgs)


def load_digits_dataset(
    label_filter: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """scikit-learn's bundled digits (1797 8x8 grayscale, values 0..16) as
    (N, 8, 8, 1) uint8 + labels."""
    from sklearn.datasets import load_digits

    d = load_digits()
    raw = (d.images / 16.0 * 255.0).astype(np.uint8)[..., None]
    labels = d.target.astype(np.int64)
    if label_filter is not None:
        keep = labels == label_filter
        raw, labels = raw[keep], labels[keep]
    return raw, labels


def make_synthetic(
    n: int, size: int, channels: int = 3, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic procedural images: 2-3 gaussian blobs per image on a
    gradient background (no dataset files needed)."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    data = np.zeros((n, size, size, channels), dtype=np.float32)
    labels = rng.integers(0, 10, size=n)
    for i in range(n):
        img = 0.15 * (xs * rng.uniform(-1, 1) + ys * rng.uniform(-1, 1))[..., None]
        img = np.repeat(img, channels, axis=-1)
        for _ in range(rng.integers(2, 4)):
            cy, cx = rng.uniform(0.2, 0.8, size=2)
            s = rng.uniform(0.05, 0.2)
            blob = np.exp(-(((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s)))
            color = rng.uniform(0.2, 1.0, size=channels).astype(np.float32)
            img += blob[..., None] * color[None, None, :]
        data[i] = np.clip(img, 0.0, 1.0)
    return data, labels


# ---------------------------------------------------------------------------
# dataset container
# ---------------------------------------------------------------------------


class InMemoryDataset:
    """RAM-resident dataset (mydataset.MyDataset semantics): NHWC float32
    data in [-1,1] (or whitened), integer labels, and a fixed per-item random
    vector (mydataset.py:258-261)."""

    def __init__(
        self,
        data: np.ndarray,
        labels: np.ndarray,
        num_timesteps: int = 1,
        seed: int = 0,
    ):
        if data.ndim != 4:
            raise ValueError(f"expect NHWC data, got shape {data.shape}")
        self.data = np.ascontiguousarray(data, dtype=np.float32)
        self.labels = np.asarray(labels)
        rng = np.random.default_rng(seed)
        self.random = rng.uniform(-1.0, 1.0, size=(len(data), num_timesteps)).astype(
            np.float32
        )

    #: the preprocessing backend get_dataset used ('native', 'pil' or
    #: 'numpy'); None for arrays given directly or reloaded from a dump
    backend: Optional[str] = None

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx], self.labels[idx], self.random[idx]

    @property
    def shape(self):
        return self.data.shape

    def epoch_index_batches(
        self,
        rng: np.random.Generator,
        batch_size: int,
        drop_last: bool = True,
        shuffle: bool = True,
        start: int = 0,
    ) -> Iterator:
        """Shuffled per-batch index arrays; the first `start` batches yield
        None (the shuffle is drawn in full, so later batches are the same)."""
        idx = np.arange(len(self))
        if shuffle:
            rng.shuffle(idx)
        n_full = len(self) // batch_size
        for i in range(n_full):
            if i < start:
                yield None
                continue
            yield idx[i * batch_size : (i + 1) * batch_size]
        if not drop_last and len(self) % batch_size:
            yield idx[n_full * batch_size :]

    def epoch_batches(
        self,
        rng: np.random.Generator,
        batch_size: int,
        drop_last: bool = True,
        shuffle: bool = True,
        start: int = 0,
    ) -> Iterator:
        """Shuffled batch iterator (DataLoader(shuffle=True, drop_last=True)
        semantics, main_train_masked.py:92-102), built on epoch_index_batches
        so both consume the same rng stream and see the same membership."""
        for sel in self.epoch_index_batches(
            rng, batch_size, drop_last=drop_last, shuffle=shuffle, start=start
        ):
            yield None if sel is None else self.data[sel]

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        if drop_last:
            return len(self) // batch_size
        return -(-len(self) // batch_size)


def _preprocess_uniform_batch(raw: np.ndarray, size: int) -> np.ndarray:
    """Resize+crop a same-sized uint8 batch to (N, size, size, C) float [0,1].

    Uses the native OpenMP batch pipeline under the same opt-in as the
    per-image path (MDT_NATIVE_PREPROCESS, or PIL missing) — the default
    stays PIL's antialiased, torchvision-matching filter so loader families
    share transform semantics.
    """
    if _native_preprocess_enabled() or not _HAS_PIL:
        from masked_diffusion_tpu_torch import native

        out = native.preprocess_batch_native(np.asarray(raw), size)
        if out is not None:
            return out
    return np.stack([resize_center_crop(im, size) for im in raw])


def save_dataset(dataset: "InMemoryDataset", path: str) -> str:
    """Export the preloaded tensors to one .npz file — the analog of the
    reference's per-run .pt dump (mydataset.save_dataset :213-232)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(
        path, data=dataset.data, labels=dataset.labels, random=dataset.random
    )
    return path


def load_saved_dataset(path: str) -> "InMemoryDataset":
    with np.load(path) as z:
        ds = InMemoryDataset(z["data"], z["labels"])
        if "random" in z:
            ds.random = z["random"]
    return ds


def get_dataset(
    path: str,
    name: str,
    size: int,
    split: str = "train",
    data_subset: bool = False,
    num_data: int = 0,
    use_augment: bool = False,
    seed: int = 0,
    label_filter: Optional[int] = None,
) -> InMemoryDataset:
    """Build an in-memory dataset (mydataset.get_dataset + MyDataset preload).

    label_filter keeps a single class — the reference's mnist label filter
    (utils/datasetutils.py:223-243). A --dir_dataset containing 'hugging'
    routes through the HF adapter (main_train_masked.py:47-49). The
    dataset's `backend` names the preprocessing backend."""
    if "hugging" in str(path):
        if label_filter is not None:
            # the HF adapter slices the split before any filtering could run
            # (datasetutilsHugging.py:103 semantics) — fail loudly instead of
            # silently returning all classes
            raise NotImplementedError(
                "label_filter is not supported on the huggingface adapter path"
            )
        from masked_diffusion_tpu_torch.data.hugging import load_hf_dataset

        ds = load_hf_dataset(
            name, size, split, data_subset, num_data, use_augment, seed
        )
        ds.backend = preprocess_backend()
        return ds
    name_l = name.lower()
    backend = "numpy" if name_l == "synthetic" else preprocess_backend()
    if name_l == "synthetic":
        n = num_data if (data_subset and num_data) else 1024
        raw, labels = make_synthetic(n, size, channels=3, seed=seed)
        imgs = raw  # already [0,1] at final size
    elif name_l == "digits":
        raw, labels = load_digits_dataset(label_filter)
        if data_subset and num_data:
            raw, labels = raw[:num_data], labels[:num_data]
        imgs = _preprocess_uniform_batch(raw, size)
    elif name_l in ("mnist", "cifar10"):
        loader = load_mnist_idx if name_l == "mnist" else load_cifar10
        raw, labels = loader(path, split)
        if label_filter is not None:
            keep = labels == label_filter
            raw, labels = raw[keep], labels[keep]
        if data_subset and num_data:
            raw, labels = raw[:num_data], labels[:num_data]
        imgs = _preprocess_uniform_batch(raw, size)
    elif name_l == "lsun" and os.path.isdir(
        os.path.join(path, name_l, f"{_LSUN_CLASSES.get(split, split)}_lmdb")
    ):
        # native LMDB archives (the torchvision-LSUN layout the reference
        # reads, mydataset.py:132-141); an exported-images directory still
        # falls through to the ImageFolder scan below
        limit = num_data if (data_subset and num_data) else None
        imgs = load_lsun(os.path.join(path, name_l), split, size, limit)
        labels = np.zeros(len(imgs), dtype=np.int64)
    else:
        # ImageFolder-style datasets: celeba_hq/{split}, afhqv2/{split},
        # metfaces, stanfordcars, flowers102, exported lsun images
        # (mydataset.py:118-199)
        candidates = [
            os.path.join(path, name_l, split),
            os.path.join(path, name_l),
            path,
        ]
        root = next((c for c in candidates if os.path.isdir(c)), None)
        if root is None:
            raise FileNotFoundError(f"dataset {name!r} not found under {path!r}")
        limit = num_data if (data_subset and num_data) else None
        paths, labels = load_image_folder(root, limit)
        imgs = np.stack(
            [
                resize_center_crop(
                    np.asarray(Image.open(p).convert("RGB"), dtype=np.uint8), size
                )
                for p in paths
            ]
        )

    if use_augment:
        imgs = np.stack([whiten(im) for im in imgs])
    else:
        imgs = normalize_global(imgs)

    ds = InMemoryDataset(imgs.astype(np.float32), labels, seed=seed)
    ds.backend = backend
    return ds
