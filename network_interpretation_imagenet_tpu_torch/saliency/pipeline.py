"""Per-image random-window saliency and its localization score (port of
``saliency/pipeline.py:48`` and ``:161`` of the JAX package)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.ops import aggregate, masking, metrics
from network_interpretation_imagenet_tpu_torch.saliency.engine import (
    MaskEvalResult,
    SaliencyEngine,
)


@dataclasses.dataclass
class SaliencyOutput:
    """What the reference writes to ./masks + heatmaps, in memory."""

    segments: np.ndarray          # int32[H, W]
    num_segments: int
    eval: MaskEvalResult          # per-mask outcomes
    heatmap: np.ndarray           # f32[H, W] summed-label heatmap
    firsts: Optional[np.ndarray] = None
    width: Optional[int] = None


def random_window_saliency(engine: SaliencyEngine, image, segments: np.ndarray,
                           num_samples: int, window_fraction: float = 0.4,
                           seed: int = 0, target: Optional[int] = None) -> SaliencyOutput:
    """Random contiguous-window masks + summed-label heatmap; only surviving
    masks add heat. Starts come from a CPU ``torch.Generator`` seeded with
    ``seed``, so they are the same on every device."""
    segments = np.asarray(segments, np.int32)
    s = int(segments.max()) + 1
    width = int(window_fraction * s)
    if target is None:
        target, _ = engine.predict_one(image)
    generator = torch.Generator().manual_seed(int(seed))
    firsts = masking.sample_window_starts(generator, num_samples, s, width).numpy()
    result = engine.eval_window_masks(image, segments, firsts, width, target)
    heat = aggregate.summed_superpixel_labels_np(segments, firsts, width, result.survived)
    return SaliencyOutput(segments=segments, num_segments=s, eval=result, heatmap=heat,
                          firsts=firsts, width=width)


def localization_score(heatmap: np.ndarray, gt_bbox_xywh, bbox_threshold: int = 180,
                       ref_compat: bool = False) -> Tuple[float, np.ndarray]:
    """Heatmap -> uint8 -> threshold -> largest-component bbox -> IOU vs gt.

    The reference's ``[x, y, x, y]`` bbox bug is fixed by default;
    ``ref_compat=True`` reproduces the reference arithmetic end to end."""
    gray = aggregate.normalize_to_uint8_np(heatmap)
    pred_xywh = metrics.generate_boundingbox(gray, bbox_threshold, ref_compat=ref_compat)
    if ref_compat:
        pred = np.array([pred_xywh[0], pred_xywh[1], pred_xywh[2] + pred_xywh[0],
                         pred_xywh[3] + pred_xywh[1]])
        gt = np.array([gt_bbox_xywh[0], gt_bbox_xywh[1], gt_bbox_xywh[2] + gt_bbox_xywh[0],
                       gt_bbox_xywh[3] + gt_bbox_xywh[1]])
        return metrics.iou_ref_compat(pred, gt), pred_xywh

    def corners(b):
        b = np.asarray(b, np.float64)
        return np.array([b[0], b[1], b[0] + b[2], b[1] + b[3]])

    pred, gt = corners(pred_xywh), corners(gt_bbox_xywh)
    xa, ya = max(pred[0], gt[0]), max(pred[1], gt[1])
    xb, yb = min(pred[2], gt[2]), min(pred[3], gt[3])
    inter = max(0.0, xb - xa + 1) * max(0.0, yb - ya + 1)
    area_p = (pred[2] - pred[0] + 1) * (pred[3] - pred[1] + 1)
    area_g = (gt[2] - gt[0] + 1) * (gt[3] - gt[1] + 1)
    return float(inter / (area_p + area_g - inter)), pred_xywh
