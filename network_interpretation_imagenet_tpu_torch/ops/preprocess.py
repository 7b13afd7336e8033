"""Image preprocessing on HWC tensors (port of ``ops/preprocess.py``):
resize -> center-crop -> normalize, and the display image.

The resizes are ``jax.image.resize(..., "bilinear")``'s, built by
``ops/resize.py`` (antialiased when a side shrinks), not ``F.interpolate``:
the reference's torchvision ``Resize(224) -> CenterCrop(224) -> ToTensor ->
Normalize`` (``bayesian_active_learning_imagenet.py:402-415``) as device
ops, so decode is the only host step.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from network_interpretation_imagenet_tpu_torch.ops.aggregate import (
    normalize_to_uint8 as to_display_uint8,  # the image the reference feeds to Felzenszwalb
)
from network_interpretation_imagenet_tpu_torch.ops.resize import resize_bilinear


def _resize_hwc(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of the two leading (spatial) axes; f32 out."""
    if img.dim() == 2:
        return resize_bilinear(img, hw)
    return resize_bilinear(img.permute(2, 0, 1), hw).permute(1, 2, 0)


def resize_shorter_side(img: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``Resize(size)`` semantics: scale so the *shorter* side
    equals ``size``, preserving aspect ratio (bilinear). The long side is
    ``int(size * long / short)``, truncated as torchvision's
    ``_compute_resized_output_size`` does (500x375 -> 298x224)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    if h <= w:
        new_h, new_w = size, max(1, int(size * w / h))
    else:
        new_h, new_w = max(1, int(size * h / w)), size
    return _resize_hwc(img, (new_h, new_w))


def resize_to(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Exact-size bilinear resize (torchvision ``Resize((h, w))``)."""
    return _resize_hwc(img, (int(hw[0]), int(hw[1])))


def center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    """torchvision ``CenterCrop(size)``: crop offsets ``round((dim-size)/2)``
    per side; pads with zeros when the image is smaller."""
    h, w = int(img.shape[0]), int(img.shape[1])
    if h < size or w < size:
        pad_h, pad_w = max(0, size - h), max(0, size - w)
        padded = img.new_zeros((h + pad_h, w + pad_w) + tuple(img.shape[2:]))
        padded[pad_h // 2:pad_h // 2 + h, pad_w // 2:pad_w // 2 + w] = img
        img, h, w = padded, h + pad_h, w + pad_w
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return img[top:top + size, left:left + size]


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


def standard_eval_pipeline(img_u8: torch.Tensor, size: int, mean: Sequence[float],
                           std: Sequence[float]) -> torch.Tensor:
    """uint8 HWC -> normalized f32 HWC at ``size``^2: the full reference eval
    transform (Resize(shorter=size) -> CenterCrop(size) -> /255 -> Normalize)."""
    img = img_u8.to(torch.float32) / 255.0
    img = resize_shorter_side(img, size)
    img = center_crop(img, size)
    return normalize(img, mean, std)
