"""Per-channel normalization and the display image (port of
``ops/preprocess.py:59-85``), on HWC tensors."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """``(x - mean) / std`` per channel on a [0, 1]-scaled HWC image."""
    mean_t = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std_t = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return (img - mean_t) / std_t


def denormalize(img: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """Inverse of :func:`normalize`."""
    mean_t = torch.as_tensor(mean, dtype=img.dtype, device=img.device)
    std_t = torch.as_tensor(std, dtype=img.dtype, device=img.device)
    return img * std_t + mean_t


def to_display_uint8(img: torch.Tensor) -> torch.Tensor:
    """Min-max scale a *normalized* HWC image to uint8 [0, 255]: the image
    the reference feeds to Felzenszwalb."""
    x = img.to(torch.float32)
    x = x - x.min()
    x = x / torch.clamp(x.max(), min=torch.finfo(torch.float32).tiny)
    return (x * 255.0).to(torch.uint8)
