"""Figures (port of ``saliency/viz.py``): boundary-marked superpixels and
the org-image + heatmap panels of the reference
(``bayesian_active_learning_imagenet.py:358-366``). matplotlib (Agg) is
imported only when a figure is saved."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def mark_boundaries(image: np.ndarray, segments: np.ndarray, color=(1.0, 1.0, 0.0)) -> np.ndarray:
    """Overlay segment boundaries (skimage ``mark_boundaries``); ``image``
    uint8 or float, HWC or HW. Returns float [0, 1] RGB."""
    img = np.asarray(image)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    seg = np.asarray(segments)
    boundary = np.zeros(seg.shape, bool)
    boundary[:-1, :] |= seg[:-1, :] != seg[1:, :]
    boundary[:, :-1] |= seg[:, :-1] != seg[:, 1:]
    out = img.copy()
    out[boundary] = np.asarray(color, np.float32)
    return out


def save_panels(path: str, panels: Sequence[np.ndarray], titles: Sequence[str],
                cmap: str = "jet", size_per_panel: float = 4.0) -> None:
    """Save an n-panel figure (the reference's plt.subplot rows)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(size_per_panel * n, size_per_panel))
    if n == 1:
        axes = [axes]
    for ax, panel, title in zip(axes, panels, titles):
        panel = np.asarray(panel)
        ax.imshow(panel, cmap=cmap if panel.ndim == 2 else None)
        ax.set_title(title)
        ax.axis("off")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
