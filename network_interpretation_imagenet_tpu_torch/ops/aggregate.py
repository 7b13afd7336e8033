"""Label aggregation on the host (port of ``ops/aggregate.py:81`` and ``:124``)."""

from __future__ import annotations

import numpy as np


def summed_superpixel_labels_np(segments, firsts, width, labels) -> np.ndarray:
    """f32[H, W] heatmap: each pixel sums the labels of the windows
    ``[first, first+width)`` that hold its segment. Pass labels already
    zeroed for dead masks, so only surviving masks accumulate. O(K*S + H*W)."""
    segments = np.asarray(segments, np.int64)
    firsts = np.asarray(firsts, np.int64)
    labels = np.asarray(labels, np.float32)
    s = int(segments.max()) + 1
    seg_ids = np.arange(s)
    in_window = (seg_ids[None, :] >= firsts[:, None]) & (
        seg_ids[None, :] < (firsts + int(width))[:, None]
    )
    per_segment = in_window.astype(np.float32).T @ labels
    return per_segment[segments]


def normalize_to_uint8_np(x) -> np.ndarray:
    """Min-max scale to [0, 255] uint8 (the reference's ``img_show`` idiom)."""
    x = np.asarray(x, np.float32)
    x = x - x.min()
    denom = max(float(x.max()), float(np.finfo(np.float32).tiny))
    return (x / denom * 255.0).astype(np.uint8)
