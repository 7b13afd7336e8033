"""Host (PIL) eval transform: torchvision's ``Resize(crop) + CenterCrop(crop)
+ ToTensor + Normalize`` arithmetic (port of ``data/transform.py``).

torchvision truncates the resized long side (``int(size * long / short)``)
and center-crops with ``round()``. PIL is imported inside the function, so
importing this module needs no PIL.
"""

from __future__ import annotations

import numpy as np

from network_interpretation_imagenet_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD


def resized_output_size(w: int, h: int, size: int):
    """torchvision Resize(size) output (new_w, new_h): short side == size,
    long side truncated."""
    if w < h:
        return size, int(size * h / w)
    return int(size * w / h), size


def pil_eval_transform(img, crop: int = 224, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                       raw: bool = False) -> np.ndarray:
    """PIL image -> normalized f32 [crop, crop, 3]; ``raw=True`` stops after
    resize + crop and returns uint8 HWC."""
    from PIL import Image

    w, h = img.size
    new_w, new_h = resized_output_size(w, h, crop)
    img = img.resize((new_w, new_h), Image.BILINEAR)
    left = int(round((new_w - crop) / 2.0))
    top = int(round((new_h - crop) / 2.0))
    img = img.crop((left, top, left + crop, top + crop))
    if raw:
        return np.asarray(img, np.uint8)
    arr = np.asarray(img, np.float32) / 255.0  # ToTensor
    return (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
