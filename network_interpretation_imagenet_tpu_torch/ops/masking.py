"""Superpixel window and knockout masks (port of ``ops/masking.py`` of the
JAX package).

Felzenszwalb label maps are relabelled to contiguous ``0..S-1``, and the
reference's window keeps ``np.unique(segments)[first : first+width]``, so the
window mask at pixel p is ``first <= segments[p] < first + width``: one
broadcast comparison for a whole bank of masks, which clips windows that run
past the last segment by itself. A knockout mask zeros M listed segments and
keeps the rest.
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


def knockout_masks(segments: torch.Tensor, knock_ids) -> torch.Tensor:
    """int32[..., H, W] labels, int32[K, M] ids -> bool[K, H, W]: each mask
    zeros its M segments and keeps every other pixel (an id of -1 knocks
    nothing). ``segments`` of shape [K, H, W] gives each mask its own label
    map. The M comparisons are OR-ed one at a time, so no [K, M, H, W]
    tensor is built."""
    knock_ids = torch.as_tensor(knock_ids, dtype=torch.int32, device=segments.device)
    seg = segments if segments.dim() == 3 else segments[None]
    hit = torch.zeros((knock_ids.shape[0], *segments.shape[-2:]), dtype=torch.bool,
                      device=segments.device)
    for j in range(knock_ids.shape[1]):
        hit |= seg == knock_ids[:, j, None, None]
    return ~hit


def single_mask_from_window(segments: torch.Tensor, first, width) -> torch.Tensor:
    """One window mask, bool[H, W]."""
    return window_masks(segments, [int(first)], width)[0]


def masked_fraction(masks: torch.Tensor) -> torch.Tensor:
    """Fraction of pixels kept per mask: f32[K]."""
    return masks.reshape(masks.shape[0], -1).float().mean(dim=1)


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


def sample_knockout_ids(generator: torch.Generator, num: int, m: int,
                        total_segments: int) -> torch.Tensor:
    """int32[num, m] knockout ids, drawn from ``generator`` on its device:
    per mask, m distinct ids uniform over ``[0, S-1)`` (the reference's
    ``sample(range(uniq[0], uniq[-1]), M)``: the last segment is never
    knocked out). Without replacement: the m smallest of per-mask uniform
    scores, by a stable sort. With fewer than m eligible ids the extra picks
    clamp into the range (duplicates, as knocking out fewer segments)."""
    hi = max(int(total_segments) - 1, 1)
    dev = generator.device
    if m == 1:
        return torch.randint(0, hi, (int(num), 1), generator=generator, dtype=torch.int32,
                             device=dev)
    scores = torch.rand((int(num), max(hi, m)), generator=generator, device=dev)
    scores[:, hi:] = torch.inf
    picked = torch.sort(scores, dim=1, stable=True).indices[:, :m]
    return torch.clamp(picked, max=hi - 1).to(torch.int32)


def sample_knockout_ids_host(seed: int, num: int, m: int, total_segments: int) -> np.ndarray:
    """The JAX package's numpy sampler, number for number: int32[num, m] from
    ``RandomState(seed)``, the same distribution as
    :func:`sample_knockout_ids`."""
    hi = max(int(total_segments) - 1, 1)
    rng = np.random.RandomState(seed)
    if m == 1:
        return rng.randint(0, hi, size=(num, 1)).astype(np.int32)
    m_eff = min(m, hi)  # degenerate images: fewer eligible segments than M
    ids = np.empty((num, m), np.int32)
    scores = rng.rand(num, hi)
    picked = np.argpartition(scores, m_eff - 1, axis=1)[:, :m_eff]
    ids[:, :m_eff] = picked
    if m_eff < m:  # pad with duplicates (same effect as fewer knockouts)
        ids[:, m_eff:] = picked[:, :1]
    return ids
