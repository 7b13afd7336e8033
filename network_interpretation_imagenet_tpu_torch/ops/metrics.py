"""Bounding box and IOU on the host (port of ``ops/metrics.py:52-137``).
Boxes are [x, y, w, h] unless noted; corner form is [x0, y0, x1, y1]."""

from __future__ import annotations

import numpy as np


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
