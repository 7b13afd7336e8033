"""Bounding boxes, IOU and top-k counts (port of ``ops/metrics.py``). Boxes
are [x, y, w, h] unless noted; corner form is [x0, y0, x1, y1]. The tensor
functions run on their inputs' device; the numpy ones are host code."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def bbox_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """Extent box int32[4] of the True pixels of bool[H, W] (the union of
    all blobs, a max-extent reduction); all zeros for an empty mask.
    :func:`largest_component_bbox` gives the reference's contour box."""
    mask = mask.bool()
    h, w = mask.shape
    any_row, any_col = mask.any(dim=1), mask.any(dim=0)
    rows = torch.arange(h, dtype=torch.int32, device=mask.device)
    cols = torch.arange(w, dtype=torch.int32, device=mask.device)
    big = torch.tensor(10**9, dtype=torch.int32, device=mask.device)
    neg = torch.tensor(-1, dtype=torch.int32, device=mask.device)
    y0, y1 = torch.where(any_row, rows, big).min(), torch.where(any_row, rows, neg).max()
    x0, x1 = torch.where(any_col, cols, big).min(), torch.where(any_col, cols, neg).max()
    box = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1]).to(torch.int32)
    return torch.where(mask.any(), box, torch.zeros_like(box))


def largest_component_bbox(mask: np.ndarray) -> np.ndarray:
    """Bbox [x, y, w, h] of the largest 8-connected component of a bool mask
    (stand-in for the reference's ``cv2.findContours`` + largest
    ``boundingRect``); all zeros for an empty mask."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    lab, n = ndimage.label(mask, structure=np.ones((3, 3), int))
    if n == 0:
        return np.zeros(4, np.int32)
    best = (0, 0, 0, 0)
    best_size = 0
    # find_objects is in label order = raster order of each component's first
    # pixel; strict > keeps the first-found box on area ties.
    for sl in ndimage.find_objects(lab):
        y0, y1 = sl[0].start, sl[0].stop - 1
        x0, x1 = sl[1].start, sl[1].stop - 1
        bw, bh = x1 - x0 + 1, y1 - y0 + 1
        if bw * bh > best_size:
            best = (x0, y0, bw, bh)
            best_size = bw * bh
    return np.array(best, np.int32)


def generate_boundingbox(gray: np.ndarray, threshold: float,
                         ref_compat: bool = False) -> np.ndarray:
    """Threshold a uint8 heatmap (``> threshold``) and box the largest
    component. ``ref_compat=True`` reproduces the reference's ``[x, y, x, y]``
    return value."""
    binary = np.asarray(gray) > threshold
    x, y, w, h = largest_component_bbox(binary)
    if ref_compat:
        return np.array([x, y, x, y], np.int32)
    return np.array([x, y, w, h], np.int32)


def xywh_to_corners(box) -> torch.Tensor:
    """[x, y, w, h] -> [x0, y0, x1, y1]."""
    box = torch.as_tensor(box)
    return torch.stack([box[0], box[1], box[0] + box[2], box[1] + box[3]])


def iou(box_a, box_b) -> torch.Tensor:
    """IOU of two corner boxes with the reference's +1-pixel convention,
    the intersection clamped at 0 for disjoint boxes (f32)."""
    a = torch.as_tensor(box_a, dtype=torch.float32)
    b = torch.as_tensor(box_b, dtype=torch.float32, device=a.device)
    xa, ya = torch.maximum(a[0], b[0]), torch.maximum(a[1], b[1])
    xb, yb = torch.minimum(a[2], b[2]), torch.minimum(a[3], b[3])
    inter = torch.clamp(xb - xa + 1.0, min=0.0) * torch.clamp(yb - ya + 1.0, min=0.0)
    area_a = (a[2] - a[0] + 1.0) * (a[3] - a[1] + 1.0)
    area_b = (b[2] - b[0] + 1.0) * (b[3] - b[1] + 1.0)
    return inter / (area_a + area_b - inter)


def iou_ref_compat(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """The reference's ``generate_IOU`` arithmetic on corner boxes, bit for
    bit: no clamp, so disjoint boxes can give a negative IOU."""
    xa = max(box_a[0], box_b[0])
    ya = max(box_a[1], box_b[1])
    xb = min(box_a[2], box_b[2])
    yb = min(box_a[3], box_b[3])
    inter = (xb - xa + 1) * (yb - ya + 1)
    area_a = (box_a[2] - box_a[0] + 1) * (box_a[3] - box_a[1] + 1)
    area_b = (box_b[2] - box_b[0] + 1) * (box_b[3] - box_b[1] + 1)
    return inter / float(area_a + area_b - inter)


def bbox_intersection(a, b) -> torch.Tensor:
    """Intersection of two [x, y, w, h] boxes (f32); zeros if disjoint."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
    x, y = torch.maximum(a[0], b[0]), torch.maximum(a[1], b[1])
    w = torch.minimum(a[0] + a[2], b[0] + b[2]) - x
    h = torch.minimum(a[1] + a[3], b[1] + b[3]) - y
    box = torch.stack([x, y, w, h])
    return torch.where((w < 0) | (h < 0), torch.zeros_like(box), box)


def topk_correct(logits: torch.Tensor, labels: torch.Tensor,
                 ks: Tuple[int, ...] = (1, 5)) -> Tuple[torch.Tensor, ...]:
    """Per k, the int32 count of samples whose label is among the top-k
    logits. Ties rank the lower index first, as ``lax.top_k`` does (a stable
    descending sort, not ``torch.topk``)."""
    top_idx = torch.sort(logits, dim=1, descending=True, stable=True).indices[:, :max(ks)]
    hit = top_idx == labels.reshape(-1, 1).to(top_idx.dtype)
    return tuple(hit[:, :k].any(dim=1).sum().to(torch.int32) for k in ks)
