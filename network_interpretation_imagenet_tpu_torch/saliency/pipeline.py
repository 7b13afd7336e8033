"""Per-image saliency pipelines (port of ``saliency/pipeline.py`` of the JAX
package): random-window and knockout sampling with their summed-label
heatmaps, the minimal-mask threshold search, and the localization score.

The threshold search is the reference's binary search over the heatmap's
distinct levels (``generate_gp_training_data_imagenet.py:396-487``, two
masked forwards per probe); here every level's mask is evaluated in one
batched bank forward and the same decisions replay on the result."""

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
    firsts: Optional[np.ndarray] = None      # window starts (window mode)
    width: Optional[int] = None
    knock_ids: Optional[np.ndarray] = None   # int32[K, M] (knockout mode)
    masks: Optional[np.ndarray] = None       # bool[K, H, W] when materialized


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


def knockout_saliency(engine: SaliencyEngine, image, segments: np.ndarray, num_samples: int,
                      num_knockout: int = 1, seed: int = 0,
                      target: Optional[int] = None) -> SaliencyOutput:
    """Knockout masks (M = ``num_knockout`` segments zeroed per mask) and
    their summed-label heatmap: each pixel a mask keeps adds its survive
    label. The ids come from a CPU ``torch.Generator`` seeded with ``seed``,
    so they are the same on every device. The masks come back as a host
    array, as in the JAX package; the device builds each chunk's masks on
    its own."""
    segments = np.asarray(segments, np.int32)
    s = int(segments.max()) + 1
    if target is None:
        target, _ = engine.predict_one(image)
    knock_ids = masking.sample_knockout_ids(torch.Generator().manual_seed(int(seed)),
                                            num_samples, num_knockout, s).numpy()
    result = engine.eval_knockout_masks(image, segments, knock_ids, target)
    masks = masking.knockout_masks(torch.from_numpy(segments), torch.from_numpy(knock_ids))
    heat = aggregate.summed_label_heatmap(masks, torch.from_numpy(result.survived)).numpy()
    return SaliencyOutput(segments=segments, num_segments=s, eval=result, heatmap=heat,
                          knock_ids=knock_ids, masks=masks.numpy())


def minimal_mask_search(engine: SaliencyEngine, image, heatmap: np.ndarray, target: int,
                        max_levels: Optional[int] = None
                        ) -> Tuple[Optional[float], np.ndarray, np.ndarray]:
    """The summed-label threshold of the minimal prediction-keeping mask: over
    the heatmap's sorted distinct levels (at most ``max_levels``, picked by
    ``linspace``), the level t whose mask ``heat >= t`` keeps the prediction
    while the next level's does not, found by the reference's binary search.
    Returns (threshold or None, keep flag per level, levels)."""
    heat = np.asarray(heatmap)
    levels = np.unique(heat)
    if max_levels is not None and len(levels) > max_levels:
        levels = levels[np.linspace(0, len(levels) - 1, max_levels).astype(int)]
    masks = heat[None, :, :] >= levels[:, None, None]
    keep = engine.eval_mask_bank(image, masks, target).survived

    first, last = 0, len(levels) - 1
    while first <= last:
        mid = (first + last) // 2
        if keep[mid]:
            if mid + 1 >= len(levels) or not keep[mid + 1]:
                return float(levels[mid]), keep, levels
            first = mid + 1
        else:
            last = mid - 1
    return None, keep, levels


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
