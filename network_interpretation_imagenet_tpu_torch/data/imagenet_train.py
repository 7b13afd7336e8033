"""ImageNet training data pipeline (port of ``data/imagenet_train.py`` of
the JAX package: the ``main.py`` the reference advertises but does not ship).

The reference README's headline usage is the stock PyTorch ImageNet
trainer (``/root/reference/README.md:14-24``: ``python main.py -a resnet18
[imagenet-folder with train and val folders]``), whose train transform is
``RandomResizedCrop(224) + RandomHorizontalFlip + Normalize``. ``main.py``
itself is absent from the reference repo (SURVEY.md §2 "referenced but
missing"), so this module re-creates those *semantics*:

* torchvision's ``RandomResizedCrop.get_params`` arithmetic exactly
  (10 area/aspect attempts, then the clamped-ratio center fallback), on
  host PIL where decode already lives;
* per-item determinism that is INDEPENDENT of worker scheduling — the
  augmentation RNG derives from ``(seed, epoch, index)`` via
  ``np.random.SeedSequence``, so ``prefetch`` thread order can never
  change the batch contents (torch's per-worker RNG makes runs depend on
  worker count; here ``--workers 0`` and ``--workers 8`` produce the same
  epoch bit-for-bit);
* batches assemble on the host as one ``[B, H, W, 3]`` f32 array and go to
  the device once per step.

Crops, flips and orders equal the JAX package's exactly: the same numpy
streams drawn in the same order.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from network_interpretation_imagenet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from network_interpretation_imagenet_tpu_torch.data.image_folder import ImageFolderDataset
from network_interpretation_imagenet_tpu_torch.data.prefetch import prefetch


def random_resized_crop_box(
    rng: np.random.Generator,
    width: int,
    height: int,
    scale: Tuple[float, float] = (0.08, 1.0),
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Tuple[int, int, int, int]:
    """(top, left, h, w) with torchvision ``RandomResizedCrop.get_params``
    semantics: 10 attempts at uniform(scale)·area and log-uniform aspect,
    else the deterministic clamped-ratio center crop."""
    area = float(height * width)
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            top = int(rng.integers(0, height - h + 1))
            left = int(rng.integers(0, width - w + 1))
            return top, left, h, w
    # Fallback: largest center crop whose aspect is clamped into `ratio`.
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    return (height - h) // 2, (width - w) // 2, h, w


def pil_train_transform(
    img,
    rng: np.random.Generator,
    crop: int = 224,
    mean=IMAGENET_MEAN,
    std=IMAGENET_STD,
) -> np.ndarray:
    """PIL image → augmented normalized f32 [crop, crop, 3] (stock ImageNet
    train transform: RandomResizedCrop + p=0.5 hflip + ToTensor +
    Normalize)."""
    from PIL import Image

    w, h = img.size
    top, left, ch, cw = random_resized_crop_box(rng, w, h)
    img = img.crop((left, top, left + cw, top + ch)).resize(
        (crop, crop), Image.BILINEAR
    )
    flip = bool(rng.random() < 0.5)
    if flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


class TrainImageFolder(ImageFolderDataset):
    """ImageFolder with the train-time augmentation transform.

    ``dataset[i]`` → (augmented f32 [crop,crop,3], label). Call
    :meth:`set_epoch` before each epoch; item RNG is a pure function of
    ``(seed, epoch, index)`` so results do not depend on how many prefetch
    workers decode them or in what order.
    """

    def __init__(self, data_dir: str, crop: int = 224, seed: int = 0,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        super().__init__(data_dir, crop)
        self.seed = seed
        self.epoch = 0
        self.mean = mean
        self.std = std

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __getitem__(self, index: int):
        from PIL import Image

        path, label = self.items[index]
        rng = np.random.Generator(
            np.random.PCG64(
                np.random.SeedSequence([self.seed, self.epoch, int(index)])
            )
        )
        with Image.open(path) as f:
            img = f.convert("RGB")
        return pil_train_transform(img, rng, self.crop, self.mean, self.std), label


def epoch_batches(
    dataset,
    batch_size: int,
    *,
    epoch: int = 0,
    seed: int = 0,
    shuffle: bool = True,
    workers: int = 4,
    drop_last: bool = False,
    indices: Optional[Sequence[int]] = None,
    process_slice: Optional[Tuple[int, int]] = None,
    skip: int = 0,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(images[B,H,W,C], labels[B])`` batches for one epoch.

    Decode/augment overlaps batch assembly via :func:`prefetch`; the
    shuffle order derives from ``(seed, epoch)`` only. ``indices``
    restricts or strides the epoch.
    ``skip`` drops the first N batches before decode (mid-epoch resume:
    identical stream to skipping decoded batches, near-zero cost).
    Items may be ``(image, label)`` or ``(image, label, extra)`` tuples.

    ``process_slice=(rank, world)`` yields each GLOBAL ``batch_size`` batch's
    contiguous per-rank slice of ``batch_size // world`` items: every rank
    computes the same (seed, epoch) permutation, decodes ONLY its slice, and
    the rank slices concatenate (in rank order) to exactly the single-process
    global batch (the data side of multi-process data parallelism). Implies
    drop_last at global-batch granularity (a partial global batch can't split
    evenly).
    """
    if hasattr(dataset, "set_epoch"):
        dataset.set_epoch(epoch)
    order = np.asarray(
        indices if indices is not None else np.arange(len(dataset)), np.int64
    )
    if shuffle:
        perm_rng = np.random.Generator(
            np.random.PCG64(np.random.SeedSequence([seed, epoch, 0x5EED]))
        )
        order = order[perm_rng.permutation(len(order))]

    if process_slice is not None:
        rank, world = process_slice
        if batch_size % world:
            raise ValueError(
                f"global batch_size {batch_size} must divide evenly across "
                f"{world} processes"
            )
        local = batch_size // world
        n_batches = len(order) // batch_size  # full global batches only
        order = np.concatenate([
            order[i * batch_size + rank * local:
                  i * batch_size + (rank + 1) * local]
            for i in range(n_batches)
        ]) if n_batches else order[:0]
        batch_size = local
        drop_last = True  # len(order) is an exact multiple; keeps intent

    if skip:
        # Mid-epoch resume: drop the first `skip` batches BEFORE decode —
        # the (seed, epoch) permutation is deterministic, so slicing the
        # order here yields exactly the stream islice would produce after
        # decoding (but without paying decode/augment for skipped images).
        # Post-process_slice, batch_size is the per-rank size and `order`
        # the per-rank sequence, so this drops `skip` global batches.
        order = order[int(skip) * batch_size:]

    images, labels = [], []
    for item in prefetch(dataset, num_workers=workers, indices=order.tolist()):
        images.append(np.asarray(item[0], np.float32))
        labels.append(int(item[1]))
        if len(images) == batch_size:
            yield np.stack(images), np.asarray(labels, np.int64)
            images, labels = [], []
    if images and not drop_last:
        yield np.stack(images), np.asarray(labels, np.int64)
