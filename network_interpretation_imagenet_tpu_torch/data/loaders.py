"""MNIST / CIFAR loaders (port of ``data/loaders.py`` of the JAX package):
host readers of the standard files (MNIST IDX, CIFAR-10/100 python
pickles) into numpy, and :class:`ArrayLoader`, an epoch iterator with the
reference's split and augmentation. Shuffles and augmentation draw from
numpy's ``RandomState`` in the JAX package's order, so both packages yield
the same batches for the same seed. Validation is the last 5,000 training
images; the "+" datasets flip and pad-4-crop.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import Iterator, Tuple

import numpy as np


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zeros, _dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zeros != 0:
            raise ValueError(f"bad IDX magic in {path}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), np.uint8)
    return data.reshape(shape)


def load_mnist_dir(data_dir: str, train: bool = False):
    """MNIST from the standard IDX files (``t10k-images-idx3-ubyte[.gz]``,
    ...): images f32 [N, 28, 28, 1] in [0, 1] (the reference applies only
    ToTensor) and labels int64 [N]."""
    prefix = "train" if train else "t10k"
    for suffix in ("", ".gz"):
        ip = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{suffix}")
        lp = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{suffix}")
        if os.path.exists(ip) and os.path.exists(lp):
            return ((_read_idx(ip).astype(np.float32) / 255.0)[..., None],
                    _read_idx(lp).astype(np.int64))
    raise FileNotFoundError(f"MNIST IDX files not found under {data_dir}")


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def load_cifar10_dir(data_dir: str, train: bool = False):
    """CIFAR-10 python batches (``cifar-10-batches-py``, or the directory
    itself): images f32 [N, 32, 32, 3] in [0, 1], labels int64 [N]."""
    base = data_dir
    if os.path.isdir(os.path.join(data_dir, "cifar-10-batches-py")):
        base = os.path.join(data_dir, "cifar-10-batches-py")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for n in names:
        d = _unpickle(os.path.join(base, n))
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.asarray(ys, np.int64)


def load_cifar100_dir(data_dir: str, train: bool = False):
    """CIFAR-100 python format (``cifar-100-python`` with ``train`` / ``test``
    and the fine labels)."""
    base = data_dir
    if os.path.isdir(os.path.join(data_dir, "cifar-100-python")):
        base = os.path.join(data_dir, "cifar-100-python")
    d = _unpickle(os.path.join(base, "train" if train else "test"))
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.asarray(d[b"fine_labels"], np.int64)


def _augment(images: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
    """The "+" augmentation: zero-pad 4, random 32x32 crop, random h-flip;
    per image two crop offsets then one flip draw."""
    n, h, w, _ = images.shape
    out = np.empty_like(images)
    padded = np.pad(images, ((0, 0), (4, 4), (4, 4), (0, 0)), mode="constant")
    for i in range(n):
        dy, dx = rng.randint(0, 9, 2)
        img = padded[i, dy:dy + h, dx:dx + w]
        out[i] = img[:, ::-1] if rng.rand() < 0.5 else img
    return out


class ArrayLoader:
    """Epoch iterator over in-memory arrays with optional shuffling,
    augmentation and normalization: ``(x f32 [B, H, W, C], y int64 [B])``."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = False, augment: bool = False, mean=(0.0,), std=(1.0,),
                 seed: int = 0, drop_last: bool = False) -> None:
        self.images, self.labels = images, labels
        self.batch_size = batch_size
        self.shuffle, self.augment = shuffle, augment
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.seed = int(seed)
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last

    def set_epoch(self, epoch: int) -> None:
        """Re-seed from ``(seed, epoch)``, so an epoch's batches depend on
        those two values alone (a resumed run replays the same ones)."""
        self.rng = np.random.RandomState(
            np.random.SeedSequence([self.seed, int(epoch)]).generate_state(1)[0])

    def __len__(self) -> int:
        n = len(self.images)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self.rng.shuffle(idx)
        stop = len(idx) - len(idx) % self.batch_size if self.drop_last else len(idx)
        for i in range(0, stop, self.batch_size):
            sel = idx[i:i + self.batch_size]
            x = self.images[sel]
            if self.augment:
                x = _augment(x, self.rng)
            yield (x - self.mean) / self.std, self.labels[sel]


def get_cifar_loaders(data_dir: str, dataset: str = "cifar10+", batch_size: int = 64,
                      seed: int = 0):
    """(train, val, test) loaders with the reference's split: val is the last
    5,000 training images, train keeps all of them; train shuffles, and
    augments for a "+" dataset."""
    from network_interpretation_imagenet_tpu_torch.config import DATASETS

    spec = DATASETS[dataset]
    loader = load_cifar100_dir if dataset.startswith("cifar100") else load_cifar10_dir
    train_x, train_y = loader(data_dir, train=True)
    test_x, test_y = loader(data_dir, train=False)
    common = dict(mean=spec.mean, std=spec.std, seed=seed)
    return (ArrayLoader(train_x, train_y, batch_size, shuffle=True, augment=spec.augmentation,
                        **common),
            ArrayLoader(train_x[-5000:], train_y[-5000:], batch_size, **common),
            ArrayLoader(test_x, test_y, batch_size, **common))
