"""XRAI region-based attribution (Kapishnikov et al., ICCV 2019): port of
``saliency/xrai.py`` of the JAX package.

Signed integrated gradients averaged over a baseline set (black and white in
the image's own range) run on the weights' device as batched backwards of
the plain module (``gradient._grad_mean``); a multi-scale Felzenszwalb
oversegmentation of the display image and the greedy ranking of its regions
by attribution density are host work (``native/felzenszwalb.cc``:
``felzenszwalb_ladder`` and ``xrai_greedy_rank``, with numpy plain versions).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.saliency.gradient import (
    _grad_mean,
    _image_batch_scaffold,
    image_sharded,
    as_image,
    variables_device,
)
from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import (
    felzenszwalb_ladder,
    xrai_greedy_rank_native,
)

#: Felzenszwalb scales of the oversegmentation ladder (the XRAI paper's),
#: tuned for 224^2; :func:`adaptive_scales` maps them to other sizes.
DEFAULT_SCALES = (50.0, 100.0, 150.0, 250.0, 500.0)

#: The image area DEFAULT_SCALES are calibrated for.
_REF_AREA = 224 * 224


def adaptive_scales(height: int, width: int, base: Sequence[float] = DEFAULT_SCALES):
    """``base`` scales mapped from 224^2 to a ``height x width`` image by the
    area ratio (Felzenszwalb's scale has pixel-count units), floor 1."""
    ratio = (int(height) * int(width)) / float(_REF_AREA)
    return tuple(max(1.0, float(s) * ratio) for s in base)


def _signed_ig(logits_fn, variables, images: torch.Tensor, targets: torch.Tensor, steps: int,
               base: torch.Tensor, step_batch) -> torch.Tensor:
    """images [N, H, W, C], baselines base [N, B, H, W, C] -> f32 [N, H, W]:
    the channel sum of the baseline-mean signed IG."""
    n, nb = int(base.shape[0]), int(base.shape[1])
    alphas = (torch.arange(steps, dtype=torch.float32, device=images.device) + 0.5) / steps
    diff = images[:, None] - base                                      # [N, B, H, W, C]
    path = base[:, :, None] + alphas[None, None, :, None, None, None] * diff[:, :, None]
    avg = _grad_mean(logits_fn, variables, path.reshape(n * nb, steps, *images.shape[1:]),
                     targets.repeat_interleave(nb), step_batch)
    ig = diff * avg.reshape(n, nb, *images.shape[1:])
    return torch.sum(torch.mean(ig, dim=1), dim=-1)


def _default_baselines(images: torch.Tensor) -> torch.Tensor:
    """Black and white in each image's own range: [N, 2, H, W, C]."""
    lo = images.amin(dim=(1, 2, 3))[:, None, None, None].expand_as(images)
    hi = images.amax(dim=(1, 2, 3))[:, None, None, None].expand_as(images)
    return torch.stack([lo, hi], dim=1)


def xrai_attribution(logits_fn: Callable, variables: Any, image, target: int, steps: int = 16,
                     baselines: Optional[Sequence] = None,
                     step_batch: Optional[int] = None) -> torch.Tensor:
    """Signed per-pixel IG attribution averaged over ``baselines`` -> f32[H, W]
    (default black and white in the image's range). Unlike
    ``gradient.integrated_gradients`` the channel sum keeps its sign.
    ``step_batch`` bounds memory by exact accumulation."""
    dev = variables_device(variables)
    img = as_image(image, dev)[None]
    if baselines is None:
        base = _default_baselines(img)
    else:
        base = torch.stack([as_image(b, dev).expand_as(img[0]) for b in baselines])[None]
    tgt = torch.tensor([int(target)], dtype=torch.int64, device=dev)
    return _signed_ig(logits_fn, variables, img, tgt, int(steps), base, step_batch)[0]


def xrai_attribution_batch(logits_fn: Callable, variables: Any, images, targets,
                           steps: int = 16, step_batch: Optional[int] = None, mesh=None,
                           data_axis: str = "data") -> torch.Tensor:
    """N images' signed XRAI attributions (default baselines) -> f32[N, H, W],
    one stacked backward (``step_batch`` bounds it at N*2*chunk images).
    The greedy ranking stays per-image host work. ``mesh`` shards the image
    axis (``gradient.image_sharded``)."""
    dev = variables_device(variables)
    images, targets, seeds, n = _image_batch_scaffold(images, targets, None, dev)
    if n == 0:
        return torch.zeros((0, *images.shape[1:3]), dtype=torch.float32, device=dev)

    def run(imgs, tgts, _):
        return _signed_ig(logits_fn, variables, imgs, tgts, int(steps),
                          _default_baselines(imgs), step_batch)

    return image_sharded(mesh, data_axis, run, images, targets, seeds)


def greedy_region_ranking(attr: np.ndarray, segment_maps: Sequence[np.ndarray],
                          min_area: int = 4, backend: str = "native") -> tuple:
    """Greedy XRAI core: repeatedly claim the segment (of any scale) with the
    highest attribution density over its unclaimed pixels, then take the
    claimed pixels out of every scale's tallies; segments whose unclaimed
    remainder falls below ``min_area`` are skipped. Returns ``(heat f32[H, W],
    num_regions)``: each pixel's claim rank mapped to (0, 1], higher for
    earlier (denser) regions, 0 where never claimed. ``backend="native"``
    runs ``xrai_greedy_rank``; ``"numpy"`` is the plain version (the same
    float64 accumulation order, argmax tie rule and area floor)."""
    if backend not in ("native", "numpy"):
        raise ValueError(f"backend must be native|numpy, got {backend!r}")
    attr = np.asarray(attr, np.float64)
    h, w = attr.shape
    flat_attr = attr.reshape(-1)
    ids, counts = [], []
    for sm in segment_maps:
        sm = np.asarray(sm).reshape(-1)
        if sm.shape != flat_attr.shape:
            raise ValueError(f"segment map shape {sm.shape} != attribution {attr.shape}")
        sm = sm - sm.min()
        ids.append(sm.astype(np.int64))
        counts.append(int(sm.max()) + 1)
    if not ids:
        raise ValueError("need at least one segment map")
    if backend == "native":
        out, n = xrai_greedy_rank_native(flat_attr, np.stack(ids).astype(np.int32), min_area)
        return out.reshape(h, w), n

    offsets = np.cumsum([0] + counts[:-1])
    s_total = int(np.sum(counts))
    num = np.zeros(s_total, np.float64)
    den = np.zeros(s_total, np.float64)
    for m, (sm, c) in enumerate(zip(ids, counts)):
        num[offsets[m]:offsets[m] + c] = np.bincount(sm, weights=flat_attr, minlength=c)
        den[offsets[m]:offsets[m] + c] = np.bincount(sm, minlength=c)
    covered = np.zeros(h * w, bool)
    heat = np.zeros(h * w, np.float64)
    alive = den >= min_area
    rank = 0
    while alive.any():
        gains = np.where(alive, num / np.maximum(den, 1.0), -np.inf)
        best = int(np.argmax(gains))
        m = int(np.searchsorted(offsets, best, side="right")) - 1
        new = (ids[m] == best - offsets[m]) & ~covered
        alive[best] = False
        if not new.any():
            continue
        covered |= new
        rank += 1
        heat[new] = rank
        idx = np.nonzero(new)[0]
        for mm, (sm, c) in enumerate(zip(ids, counts)):
            seg = sm[idx]
            num[offsets[mm]:offsets[mm] + c] -= np.bincount(seg, weights=flat_attr[idx],
                                                            minlength=c)
            den[offsets[mm]:offsets[mm] + c] -= np.bincount(seg, minlength=c)
        alive &= den >= min_area
    out = np.where(heat > 0, (rank - heat + 1) / max(rank, 1), 0.0)
    return out.reshape(h, w).astype(np.float32), rank


@dataclass(frozen=True)
class XraiResult:
    heatmap: np.ndarray      # f32[H, W], rank-valued, higher = denser
    attribution: np.ndarray  # f32[H, W], signed IG (mean over baselines)
    num_regions: int


def xrai_saliency(logits_fn: Callable, variables: Any, image, target: int, display: np.ndarray,
                  steps: int = 16, scales: Optional[Sequence[float]] = None,
                  baselines: Optional[Sequence] = None, min_area: int = 4,
                  segment_backend: str = "native") -> XraiResult:
    """End-to-end XRAI: multi-baseline signed IG on the weights' device, the
    Felzenszwalb ladder of the uint8 display image (``scales=None``:
    :func:`adaptive_scales` for its size), the greedy density ranking."""
    attr = xrai_attribution(logits_fn, variables, image, target, steps=steps,
                            baselines=baselines).cpu().numpy()
    if scales is None:
        scales = adaptive_scales(display.shape[0], display.shape[1])
    seg_maps = felzenszwalb_ladder(display, scales, sigma=0.5, backend=segment_backend)
    heat, n = greedy_region_ranking(attr, seg_maps, min_area=min_area, backend=segment_backend)
    return XraiResult(heatmap=heat, attribution=attr, num_regions=n)
