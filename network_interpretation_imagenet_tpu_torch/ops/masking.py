"""Superpixel window masks (port of ``ops/masking.py`` of the JAX package).

Felzenszwalb label maps are relabelled to contiguous ``0..S-1``, and the
reference's window keeps ``np.unique(segments)[first : first+width]``, so the
window mask at pixel p is ``first <= segments[p] < first + width``: one
broadcast comparison for a whole bank of masks, which clips windows that run
past the last segment by itself.
"""

from __future__ import annotations

import numpy as np
import torch


def window_masks(segments: torch.Tensor, firsts, width) -> torch.Tensor:
    """int32[H, W] labels, int32[K] starts, scalar (or [K]) width ->
    bool[K, H, W] mask bank; True = pixel kept."""
    firsts = torch.as_tensor(firsts, dtype=torch.int32, device=segments.device)
    width = torch.as_tensor(width, dtype=torch.int32, device=segments.device)
    seg = segments[None, :, :]
    lo = firsts[:, None, None]
    hi = (firsts + width)[:, None, None]
    return (seg >= lo) & (seg < hi)


def apply_masks(image: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """f[H, W, C] normalized image x bool[K, H, W] -> f[K, H, W, C].

    The reference multiplies the *normalized* image by the binary mask, so
    masked-out pixels hold 0 in normalized space (not the dataset mean)."""
    return image[None] * masks[:, :, :, None].to(image.dtype)


def sample_window_starts(
    generator: torch.Generator, num: int, total_segments: int, width: int
) -> torch.Tensor:
    """int32[num] starts, uniform over the inclusive ``[1, max(S - width, 1)]``
    (the reference's Python ``randint(1, S - width)``), drawn from
    ``generator`` on its device."""
    hi = max(int(total_segments) - int(width), 1)
    return torch.randint(1, hi + 1, (int(num),), generator=generator,
                         dtype=torch.int32, device=generator.device)


def sample_window_starts_host(seed: int, num: int, total_segments: int, width: int):
    """The same distribution from numpy's ``RandomState(seed)``: the stream
    the JAX package's host sampler draws, number for number."""
    hi = max(int(total_segments) - int(width), 1)
    rng = np.random.RandomState(seed)
    return rng.randint(1, hi + 1, size=num).astype(np.int32)
