"""A deterministic synthetic image (port of ``data/synthetic.py:11``)."""

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
