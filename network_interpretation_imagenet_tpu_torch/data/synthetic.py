"""Deterministic synthetic data (port of ``data/synthetic.py`` of the JAX
package): a segmentable image and a separable toy classification batch."""

from __future__ import annotations

import numpy as np


def synthetic_imagenet_image(seed: int = 0, size: int = 224) -> np.ndarray:
    """A textured multi-region image (f32 HWC in [0, 1]) that segments into
    a nontrivial number of superpixels."""
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(yy / (8 + 3 * (seed % 5))) * np.cos(xx / 11.0),
            (yy // (size // 4) + xx // (size // 4)) % 3 / 2.0,
            0.5 + 0.5 * np.cos((yy + xx) / 17.0),
        ],
        axis=-1,
    ).astype(np.float32)
    img += rng.rand(size, size, 3).astype(np.float32) * 0.08
    return np.clip(img, 0.0, 1.0)


def synthetic_classification_batch(seed: int, n: int, size: int, channels: int,
                                   num_classes: int):
    """A separable toy batch (port of ``data/synthetic.py:27``): class k gets
    a bright k-th band of rows. Images f32 [n, size, size, channels] in
    [0, 1], labels int64 [n]."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, n)
    images = rng.rand(n, size, size, channels).astype(np.float32) * 0.3
    stripe = max(1, size // num_classes)
    for i, k in enumerate(labels):
        images[i, k * stripe:(k + 1) * stripe] += 0.7
    return np.clip(images, 0, 1), labels.astype(np.int64)
