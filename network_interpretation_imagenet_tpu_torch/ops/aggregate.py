"""Label aggregation: a mask bank and its per-mask labels -> a per-pixel
heatmap (port of ``ops/aggregate.py``). The tensor functions run on their
inputs' device; the ``_np`` ones are the host versions the pipelines use."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def summed_label_heatmap(masks: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """bool[K, H, W] masks, [K] labels -> f32[H, W]: each pixel sums the
    labels of the masks that keep it (the reference's ``plot_summed_heatmap``;
    pixels no mask keeps stay 0)."""
    return torch.einsum("khw,k->hw", masks.float(), labels.float())


def summed_superpixel_labels(segments: torch.Tensor, firsts: torch.Tensor, width,
                             labels: torch.Tensor, s_cap: int = 4096) -> torch.Tensor:
    """The same heatmap from window parameters, without a mask bank: per-segment
    sums [s_cap] gathered through the label map. Pass labels already zeroed
    for dead masks. Raises when a segment id is >= ``s_cap`` (its heat would
    be lost)."""
    s_max = int(segments.max())
    if s_max >= int(s_cap):
        raise ValueError(f"summed_superpixel_labels: segment id {s_max} >= s_cap "
                         f"{int(s_cap)}; pass s_cap >= num_segments (pow-2 bucketed)")
    seg_ids = torch.arange(int(s_cap), dtype=torch.int32, device=segments.device)
    firsts = firsts.to(torch.int32)
    in_window = ((seg_ids[None, :] >= firsts[:, None])
                 & (seg_ids[None, :] < (firsts + width)[:, None]))
    per_segment = torch.einsum("ks,k->s", in_window.float(), labels.float())
    return per_segment[segments.long()]


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


def summed_knockout_labels_np(segments, knock_ids, labels) -> np.ndarray:
    """Host form of ``summed_label_heatmap(knockout_masks(...), labels)``
    without the [K, H, W] bank: a pixel of segment s sums
    ``total - sum of the labels of the masks that knock s out``; an id
    repeated within one mask counts once. O(K*M + H*W)."""
    segments = np.asarray(segments, np.int64)
    knock_ids = np.asarray(knock_ids, np.int64)
    labels = np.asarray(labels, np.float32)
    s = int(segments.max()) + 1
    minus = np.zeros(s, np.float32)
    k, m = knock_ids.shape
    w = np.repeat(labels, m)
    flat = knock_ids.reshape(-1)
    if m > 1:
        first_occurrence = np.ones((k, m), bool)
        sorted_idx = np.argsort(knock_ids, axis=1, kind="stable")
        sorted_ids = np.take_along_axis(knock_ids, sorted_idx, axis=1)
        dup = np.zeros((k, m), bool)
        dup[:, 1:] = sorted_ids[:, 1:] == sorted_ids[:, :-1]
        np.put_along_axis(first_occurrence, sorted_idx, ~dup, axis=1)
        keep = first_occurrence.reshape(-1)
        flat, w = flat[keep], w[keep]
    valid = (flat >= 0) & (flat < s)
    np.add.at(minus, flat[valid], w[valid])
    return (labels.sum() - minus)[segments]


def normalize_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Min-max scale to [0, 255] uint8 (the reference's ``img_show`` idiom)."""
    x = x.float()
    x = x - x.min()
    denom = torch.clamp(x.max(), min=torch.finfo(torch.float32).tiny)
    return (x / denom * 255.0).to(torch.uint8)


def normalize_to_uint8_batch(x: torch.Tensor) -> torch.Tensor:
    """:func:`normalize_to_uint8` of each image of a batch [N, ...] at once."""
    x = x.float()
    flat = x.reshape(x.shape[0], -1)
    shape = (-1,) + (1,) * (x.dim() - 1)
    x = x - flat.min(dim=1).values.reshape(shape)
    denom = torch.clamp(x.reshape(x.shape[0], -1).max(dim=1).values,
                        min=torch.finfo(torch.float32).tiny).reshape(shape)
    return (x / denom * 255.0).to(torch.uint8)


def normalize_to_uint8_np(x) -> np.ndarray:
    """Host form of :func:`normalize_to_uint8`."""
    x = np.asarray(x, np.float32)
    x = x - x.min()
    denom = max(float(x.max()), float(np.finfo(np.float32).tiny))
    return (x / denom * 255.0).astype(np.uint8)


def distinct_sorted_levels(heat: torch.Tensor, k_max: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted distinct values of an integer-valued heatmap, padded to a fixed
    length (the reference's ``sorted(set(dict_pixel.values()))``). Summed
    labels of K masks take at most K+1 values, so ``k_max`` = K + 1 bounds
    them. Returns (f32[k_max] ascending with +inf padding, int32 count)."""
    idx = torch.clamp(heat.reshape(-1).to(torch.int32), 0, k_max - 1).long()
    present = torch.zeros(k_max, dtype=torch.bool, device=heat.device)
    present[idx] = True
    levels = torch.where(present, torch.arange(k_max, dtype=torch.float32, device=heat.device),
                         torch.inf)
    return torch.sort(levels).values, present.sum().to(torch.int32)


def threshold_mask(heat: torch.Tensor, threshold) -> torch.Tensor:
    """Keep-mask of the pixels whose summed label meets ``threshold`` (the
    reference's ``generate_new_mask``)."""
    return heat >= threshold
