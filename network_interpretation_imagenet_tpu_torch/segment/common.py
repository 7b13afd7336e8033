"""Relabelling and the segmentation dispatcher (port of ``segment/common.py``):
Felzenszwalb on the host, SLIC's k-means on the device with its
connectivity pass and relabelling on the host."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from network_interpretation_imagenet_tpu_torch.config import SegmentConfig
from network_interpretation_imagenet_tpu_torch.utils import logging as trace


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


def segment_image(img_u8: np.ndarray, cfg: SegmentConfig, device=None) -> np.ndarray:
    """uint8 [H, W, C] display image (``ops.preprocess.to_display_uint8``) ->
    int32[H, W] contiguous labels. SLIC runs on ``device`` (``None``: the
    card); Felzenszwalb is host work. Traced as span ``segment``; for
    Felzenszwalb its attribute ``workspace`` says whether the native kernel
    reused the calling thread's buffers (``"reused"``) or grew them
    (``"grown"``)."""
    from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import (
        felzenszwalb_native,
    )

    with trace.span("segment") as open_span:
        if cfg.method == "slic":
            return slic_postpass_host(slic_batch_device([img_u8], cfg, device).cpu().numpy(),
                                      cfg)[0]
        if cfg.method != "felzenszwalb":
            raise ValueError(f"unknown segmentation method {cfg.method}")
        scale = cfg.scale
        if scale is None:
            # Area-adaptive default (see SegmentConfig.scale).
            h, w = np.asarray(img_u8).shape[:2]
            scale = max(1.0, 100.0 * (int(h) * int(w)) / (224.0 * 224.0))
        (labels,), workspace = felzenszwalb_native(img_u8, [scale], cfg.sigma, [cfg.min_size])
        if open_span is not None:
            open_span.annotate(workspace=workspace)
        return labels


def segment_image_batch(displays, cfg: SegmentConfig, device=None) -> list:
    """Segment N display images; a list of int32[H, W] label maps equal to
    per-image :func:`segment_image` calls. SLIC runs the N k-means as one
    batch on ``device`` (``None``: the card); its displays may be a uint8
    [N, H, W(, C)] tensor already there. Felzenszwalb's native kernel
    releases the GIL, so the images fan out over a thread pool of up to 8
    workers, each with its own workspace."""
    if cfg.method == "slic" and len(displays):
        return slic_postpass_host(slic_batch_device(displays, cfg, device).cpu().numpy(), cfg)
    displays = list(displays)
    workers = min(8, len(displays), os.cpu_count() or 1)
    if workers <= 1:
        return [segment_image(d, cfg) for d in displays]
    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(lambda d: segment_image(d, cfg), displays))


def slic_batch_device(displays, cfg: SegmentConfig, device=None):
    """The device half of SLIC: the batched k-means of N same-shape display
    images, int32 [N, H, W] labels left on ``device`` (``None``: the card)."""
    from network_interpretation_imagenet_tpu_torch.segment.slic import slic_batch

    return slic_batch(displays, n_segments=cfg.n_segments, compactness=cfg.compactness,
                      num_iters=cfg.slic_iters, device=device)


def slic_postpass_host(segs: np.ndarray, cfg: SegmentConfig) -> list:
    """The host half of SLIC: the connectivity pass and the relabelling of
    each image of an [N, H, W] label batch."""
    from network_interpretation_imagenet_tpu_torch.segment.slic import enforce_connectivity

    def post(seg):
        seg = np.asarray(seg, np.int32)
        if cfg.enforce_connectivity:
            seg = enforce_connectivity(seg)
        return relabel_sequential(seg)

    return [post(seg) for seg in np.asarray(segs)]
