"""SLIC superpixels: port of ``segment/slic.py`` of the JAX package.

k-means over [colour (CIELAB), scaled y, scaled x] features, as torch ops on
the device: each assignment is one [N, K] distance product, each centre
update one one-hot product. The products run in full f32 (TF32 off), as the
JAX package pins ``Precision.HIGHEST``: the cross terms are O(1e4) while the
distance gaps that decide a boundary are O(1). Labels come out in grid
raster order (centres initialized row-major), so contiguous label windows
are spatially banded regions. The connectivity pass is host work
(``native/felzenszwalb.cc:slic_postpass``).

The JAX package pads K to a power of two with sentinel centres to tame
XLA's compile time; they never win an assignment, so the port has none.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.gp.kernels import full_f32


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0, 1] -> CIELAB (D65), elementwise."""
    srgb = torch.clamp(rgb, 0.0, 1.0)
    lin = torch.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b
    eps = (6.0 / 29.0) ** 3

    def f(t):
        # The cube root in f64, rounded once to f32 (torch has no cbrt).
        return torch.where(t > eps, torch.pow(t.double(), 1.0 / 3.0).float(),
                           t / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)

    fx, fy, fz = f(x / 0.95047), f(y / 1.0), f(z / 1.08883)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


def _grid_shape(h: int, w: int, n_segments: int) -> Tuple[int, int]:
    """Rows x cols of the initial centre grid, aspect-matched to the image."""
    gh = max(1, int(round(np.sqrt(n_segments * h / w))))
    gw = max(1, int(round(n_segments / gh)))
    return gh, gw


def slic_features(imgs: torch.Tensor, n_segments: int, compactness: float, use_lab: bool):
    """f32 [B, H, W, C] images -> (pixel features [B, N, C+2], initial centres
    [B, K, C+2])."""
    b, h, w, c = imgs.shape
    dev = imgs.device
    feat = rgb_to_lab(imgs) if use_lab and c == 3 else imgs * 100.0
    gh, gw = _grid_shape(h, w, n_segments)
    spacing = float(np.sqrt(h * w / (gh * gw)))
    ratio = torch.tensor(compactness, dtype=torch.float32) / spacing
    ys = (torch.arange(gh, dtype=torch.float32, device=dev) + 0.5) * (h / gh)
    xs = (torch.arange(gw, dtype=torch.float32, device=dev) + 0.5) * (w / gw)
    cy0, cx0 = ys.repeat_interleave(gw), xs.repeat(gh)
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    ratio = ratio.to(dev)
    pix = torch.cat([feat.reshape(b, -1, c), (yy.reshape(-1, 1) * ratio).expand(b, -1, 1),
                     (xx.reshape(-1, 1) * ratio).expand(b, -1, 1)], dim=2)
    init_color = feat[:, cy0.long().clamp(0, h - 1), cx0.long().clamp(0, w - 1)]
    k = gh * gw
    centers = torch.cat([init_color, (cy0 * ratio)[None, :, None].expand(b, k, 1),
                         (cx0 * ratio)[None, :, None].expand(b, k, 1)], dim=2)
    return pix, centers


def slic_distances(pix: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Squared feature distances [B, N, K] as the JAX package computes them:
    ||p||^2 + ||c||^2 - 2 p.c."""
    pix_sq = torch.sum(pix * pix, dim=2, keepdim=True)
    cen_sq = torch.sum(centers * centers, dim=2)[:, None, :]
    return pix_sq + cen_sq - 2.0 * torch.bmm(pix, centers.transpose(1, 2))


def _slic_core(imgs: torch.Tensor, n_segments: int, compactness: float, num_iters: int,
               use_lab: bool) -> torch.Tensor:
    b, h, w, _ = imgs.shape
    with full_f32():
        pix, centers = slic_features(imgs, n_segments, compactness, use_lab)
        k = centers.shape[1]
        for _ in range(num_iters):
            labels = torch.argmin(slic_distances(pix, centers), dim=2)
            onehot = torch.nn.functional.one_hot(labels, k).float()       # [B, N, K]
            counts = onehot.sum(dim=1)[:, :, None]
            sums = torch.bmm(onehot.transpose(1, 2), pix)
            centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
        labels = torch.argmin(slic_distances(pix, centers), dim=2)
    return labels.to(torch.int32).reshape(b, h, w)


def _as_batch(images, device) -> Tuple[torch.Tensor, bool]:
    """N uint8 or float images ([H, W] or [H, W, C]) -> f32 [N, H, W, C] on
    ``device`` (uint8 scaled to [0, 1]) and whether LAB applies (C == 3)."""
    if isinstance(images, torch.Tensor):
        imgs = images.to(device)
    else:
        imgs = torch.from_numpy(np.stack([np.asarray(im) for im in images])).to(device)
    if imgs.dim() == 3:
        imgs = imgs[..., None]
    imgs = imgs.float() / 255.0 if imgs.dtype == torch.uint8 else imgs.float()
    return imgs, imgs.shape[3] == 3


def slic(image, n_segments: int = 48, compactness: float = 10.0, num_iters: int = 10,
         use_lab: bool = True, device=None) -> torch.Tensor:
    """Segment one image on ``device`` (``None``: the card); int32[H, W]
    labels on the device, grid raster ordered, not yet relabelled (see
    ``segment.common``). ``image``: uint8 or float [H, W] / [H, W, C]."""
    return slic_batch([image] if not isinstance(image, torch.Tensor) else image[None],
                      n_segments, compactness, num_iters, use_lab, device)[0]


def slic_batch(images, n_segments: int = 48, compactness: float = 10.0, num_iters: int = 10,
               use_lab: bool = True, device=None) -> torch.Tensor:
    """Segment N same-shape images in one batched k-means on ``device``
    (``None``: the card): int32[N, H, W], each equal to :func:`slic`'s."""
    imgs, lab_ok = _as_batch(images, resolve_device(device))
    return _slic_core(imgs, int(n_segments), float(compactness), int(num_iters),
                      bool(use_lab and lab_ok))


def enforce_connectivity(labels: np.ndarray, min_fraction: float = 0.25) -> np.ndarray:
    """Host pass merging disconnected fragments of each SLIC label into an
    adjacent surviving region (``slic_postpass`` of the native segmenter). A
    4-connected fragment survives iff its size is at least max(1,
    ``min_fraction`` x the largest fragment of its label); each dropped
    fragment takes the label of the adjacent surviving region it shares the
    longest boundary with (ties: the smaller label; fragments that touch only
    dropped ones resolve over rounds)."""
    from network_interpretation_imagenet_tpu_torch.segment.felzenszwalb import (
        slic_postpass_native,
    )

    return slic_postpass_native(np.asarray(labels, np.int32), min_fraction)
