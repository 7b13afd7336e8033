"""The general traffic generator: a pool of distinct synthetic 224^2 images
made from the seed, each with a ground-truth box, and the closed loop that
hands them to the program for a fixed number of seconds.

A traffic file (``portbench/traffic/<name>.json``) sets the entry (``kind``),
masks per image, pool size and the segmentation settings; nothing here names
one mix."""

from __future__ import annotations

import time
from typing import Iterator, Tuple

import numpy as np
import torch

from portbench.reference import IMAGENET_MEAN, IMAGENET_STD

ELLIPSES = 60


def make_pool(n: int, size: int, seed: int, device, chunk: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` normalized f32 [size, size, 3] images on the host and their int
    [n, 4] ground-truth boxes (x, y, w, h), drawn on ``device`` from one
    generator: coloured ellipses on a gradient and a two-tone box, quantized
    to uint8 as a decoded photo is. The picture is frozen from
    ``chip_smoke.py:475`` (``synthetic_image``, about 35 Felzenszwalb
    segments), made in batches, with the box's place and size drawn per image."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    grid = torch.arange(size, device=device, dtype=torch.float32) / (size - 1.0)
    yy, xx = grid[:, None].expand(size, size), grid[None, :].expand(size, size)
    base = torch.stack([0.2 + 0.5 * xx, 0.3 + 0.4 * yy, 0.6 - 0.3 * xx * yy], dim=-1)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    lo, hi = size * 72 // 224, size * 136 // 224
    images = np.empty((n, size, size, 3), np.float32)
    boxes = np.empty((n, 4), np.int64)
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        img = base.expand(m, size, size, 3).clone()
        shape = torch.rand(m, ELLIPSES, 4, generator=g, device=device)
        colour = torch.rand(m, ELLIPSES, 3, generator=g, device=device)
        cy, cx = shape[..., 0], shape[..., 1]
        ry, rx = shape[..., 2] * 0.08 + 0.02, shape[..., 3] * 0.08 + 0.02
        for e in range(ELLIPSES):
            inside = (((yy - cy[:, e, None, None]) / ry[:, e, None, None]) ** 2
                      + ((xx - cx[:, e, None, None]) / rx[:, e, None, None]) ** 2) < 1
            img = torch.where(inside[..., None], colour[:, e, None, None, :], img)
        wh = torch.randint(lo, hi + 1, (m, 2), generator=g, device=device)
        xy = (torch.rand(m, 2, generator=g, device=device) * (size - wh)).long()
        x0, y0, w, h = xy[:, 0, None, None], xy[:, 1, None, None], wh[:, 0, None, None], wh[:, 1, None, None]
        iy = torch.arange(size, device=device)[None, :, None]
        ix = torch.arange(size, device=device)[None, None, :]
        outer = (iy >= y0) & (iy < y0 + h) & (ix >= x0) & (ix < x0 + w)
        inner = (iy >= y0 + h // 6) & (iy < y0 + h // 2) & (ix >= x0 + w // 4) & (ix < x0 + 3 * w // 4)
        img = torch.where(outer[..., None], torch.tensor([0.9, 0.2, 0.1], device=device), img)
        img = torch.where(inner[..., None], torch.tensor([0.95, 0.85, 0.1], device=device), img)
        img = img + 0.02 * torch.randn(img.shape, generator=g, device=device)
        u8 = (img.clamp(0, 1) * 255).to(torch.uint8)
        images[off:off + m] = ((u8.float() / 255.0 - mean) / std).cpu().numpy()
        boxes[off:off + m] = torch.cat([xy, wh], dim=1).cpu().numpy()
    return images, boxes


class ClosedLoop:
    """One caller handing the pool's images to the program, in order, until
    ``seconds`` have passed since :meth:`items` was first drawn from. Counts
    what it handed over; wraps around (and says so) if the pool runs out."""

    def __init__(self, images: np.ndarray, boxes: np.ndarray, seconds: float) -> None:
        self.images, self.boxes, self.seconds = images, boxes, float(seconds)
        self.handed = 0
        self.wrapped = False
        self.t_first = None

    def items(self) -> Iterator[tuple]:
        n = len(self.images)
        while True:
            now = time.perf_counter()
            if self.t_first is None:
                self.t_first = now
            elif now - self.t_first >= self.seconds:
                return
            i = self.handed % n
            self.wrapped |= self.handed >= n
            self.handed += 1
            yield self.images[i], None, tuple(int(v) for v in self.boxes[i])
