"""Saliency-fidelity metrics: deletion/insertion curves and the pointing game
(port of ``saliency/eval_metrics.py`` of the JAX package).

The causal-fidelity protocol (RISE, Petsiuk et al. 2018): delete (or insert)
the most salient pixels first and integrate the target-probability curve;
the pointing game asks whether the heatmap's argmax lands in the gt box. One
curve is one batched forward over its ``steps + 1`` masked images: the masks
are rank-threshold compares against a rank map, built on the engine's device,
and the batch runs through ``SaliencyEngine.predict_logits_device`` (the
folded net, B2 on the card).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# numpy 2 renamed trapz; either one integrates the curves.
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _rank_map(heatmap: np.ndarray) -> np.ndarray:
    """rank2d[y, x] = position of pixel (y, x) in descending-saliency order
    (0 = most salient; ties broken in raster order, deterministically)."""
    flat = np.asarray(heatmap, np.float64).ravel()
    order = np.argsort(-flat, kind="stable")
    rank = np.empty(flat.size, np.int32)
    rank[order] = np.arange(flat.size, dtype=np.int32)
    return rank.reshape(np.asarray(heatmap).shape)


def _cut_counts(image: np.ndarray, steps: int) -> np.ndarray:
    n = image.shape[0] * image.shape[1]
    return np.round(np.linspace(0, n, steps + 1)).astype(np.int32)


def _probs(engine, image: np.ndarray, rank2d: np.ndarray, counts: np.ndarray, target: int,
           modes) -> np.ndarray:
    """Target probabilities f32 [len(modes) * (steps+1)]: one batched forward
    of the rank-threshold masked images, ``modes`` stacked in order."""
    dev = engine.device
    ranks = torch.from_numpy(rank2d).to(dev)[None]
    cuts = torch.from_numpy(counts).to(dev)[:, None, None]
    salient = ranks < cuts   # [steps+1, H, W]
    keep = torch.cat([~salient if m == "deletion" else salient for m in modes])
    imgs = torch.from_numpy(image).to(dev)[None] * keep[..., None].float()
    logits = engine.predict_logits_device(imgs).cpu().numpy()
    z = logits - logits.max(axis=-1, keepdims=True)
    return (np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True))[:, int(target)]


def fidelity_curve(engine, image: np.ndarray, heatmap: np.ndarray, target: int,
                   steps: int = 32, mode: str = "deletion") -> Tuple[np.ndarray, float]:
    """Target-probability curve as the top-k salient pixels are removed
    ("deletion") or revealed onto a zero baseline ("insertion").

    Returns (probs f32[steps+1], auc float). Good saliency: LOW deletion AUC
    and HIGH insertion AUC. The whole curve is one batched forward."""
    if mode not in ("deletion", "insertion"):
        raise ValueError(mode)
    image = np.asarray(image, np.float32)
    probs = _probs(engine, image, _rank_map(np.asarray(heatmap)), _cut_counts(image, steps),
                   target, (mode,))
    return probs.astype(np.float32), float(_trapezoid(probs, dx=1.0 / steps))


def deletion_insertion_auc(engine, image, heatmap, target: int, steps: int = 32) -> dict:
    """Both curves in ONE batched forward of 2·(steps+1) images (shared rank
    map); returns {"deletion_auc", "insertion_auc", curves}."""
    image = np.asarray(image, np.float32)
    probs = _probs(engine, image, _rank_map(np.asarray(heatmap)), _cut_counts(image, steps),
                   target, ("deletion", "insertion"))
    del_probs = probs[: steps + 1].astype(np.float32)
    ins_probs = probs[steps + 1:].astype(np.float32)
    return {
        "deletion_auc": float(_trapezoid(del_probs, dx=1.0 / steps)),
        "insertion_auc": float(_trapezoid(ins_probs, dx=1.0 / steps)),
        "deletion_curve": del_probs,
        "insertion_curve": ins_probs,
    }


def pointing_game(heatmap: np.ndarray, gt_bbox_xywh, tolerance: int = 0) -> bool:
    """True iff the heatmap's argmax falls inside the gt box (± tolerance
    pixels), half-open: x in [bx, bx + bw), which suits both the float boxes
    of ``transform_gt_bbox`` and the inclusive-width integer boxes."""
    heatmap = np.asarray(heatmap)
    y, x = np.unravel_index(int(np.argmax(heatmap)), heatmap.shape)
    bx, by, bw, bh = [float(v) for v in gt_bbox_xywh]
    return (bx - tolerance <= x < bx + bw + tolerance
            and by - tolerance <= y < by + bh + tolerance)
