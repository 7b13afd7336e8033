"""Bilinear resize with ``jax.image.resize(..., "bilinear")``'s semantics.

JAX samples at half-pixel centres and, when a side shrinks, widens the
triangle kernel by the scale (antialiasing); each side is one weight matrix
[in, out], its columns normalized to sum to 1, applied as a matrix product.
This module builds the same matrices in f32 and applies them the same way.
``F.interpolate(mode="bilinear", align_corners=False)`` is the same map for
a side that grows, within f32 rounding, and for a side that shrinks only with
``antialias=True`` (``tests/test_torch_attribution.py`` pins both). The
weight matrix keeps one case exact that ``F.interpolate`` does not: a
1-pixel side upsamples to an exactly constant row (weight 1), which
Score-CAM's constant-channel test relies on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """f32 [n_in, n_out]: JAX's ``compute_weight_mat`` for the triangle
    kernel with antialiasing (translation 0)."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in) if n_out else 1.0, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None])
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * _EPS32,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """f32 [..., h, w] -> [..., H, W]: the last two axes resized bilinearly
    (a side whose size stays is left as it is). Differentiable."""
    h, w = int(size[0]), int(size[1])
    x = x.float()
    if x.shape[-2] != h:
        x = torch.einsum("...hw,hH->...Hw", x, resize_weights(x.shape[-2], h, x.device))
    if x.shape[-1] != w:
        x = torch.einsum("...hw,wW->...hW", x, resize_weights(x.shape[-1], w, x.device))
    return x
