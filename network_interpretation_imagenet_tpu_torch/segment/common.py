"""Relabelling and the segmentation dispatcher (port of ``segment/common.py``;
only the Felzenszwalb branch is ported)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from network_interpretation_imagenet_tpu_torch.config import SegmentConfig


def relabel_sequential(labels: np.ndarray) -> np.ndarray:
    """Relabel to contiguous 0..S-1 in raster-scan first-occurrence order.

    A reversed scatter leaves each id's FIRST flat index in ``first`` (later
    writes win), then the present ids sort by that small [S] array: O(n)
    instead of ``np.unique``'s sort."""
    labels = np.asarray(labels)
    flat = labels.ravel()
    first = np.full(int(flat.max()) + 1, -1, np.int64)
    first[flat[::-1]] = np.arange(flat.size - 1, -1, -1)
    present = np.nonzero(first >= 0)[0]
    order = np.argsort(first[present], kind="stable")
    remap = np.full(first.size, -1, np.int32)
    remap[present[order]] = np.arange(len(present), dtype=np.int32)
    return remap[labels].astype(np.int32)


def segment_image(img_u8: np.ndarray, cfg: SegmentConfig) -> np.ndarray:
    """uint8 [H, W, C] display image (``ops.preprocess.to_display_uint8``) ->
    int32[H, W] contiguous labels."""
    from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import felzenszwalb

    if cfg.method != "felzenszwalb":
        raise ValueError(f"segmentation method {cfg.method!r} is not ported")
    scale = cfg.scale
    if scale is None:
        # Area-adaptive default (see SegmentConfig.scale).
        h, w = np.asarray(img_u8).shape[:2]
        scale = max(1.0, 100.0 * (int(h) * int(w)) / (224.0 * 224.0))
    return felzenszwalb(img_u8, scale=scale, sigma=cfg.sigma, min_size=cfg.min_size)


def segment_image_batch(displays, cfg: SegmentConfig) -> list:
    """Segment N display images; a list of int32[H, W] label maps equal to
    per-image :func:`segment_image` calls. Felzenszwalb's hot path (scipy's
    smoothing and the native kernel) releases the GIL, so the images fan out
    over a thread pool of up to 8 workers."""
    displays = list(displays)
    workers = min(8, len(displays), os.cpu_count() or 1)
    if workers <= 1:
        return [segment_image(d, cfg) for d in displays]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda d: segment_image(d, cfg), displays))
