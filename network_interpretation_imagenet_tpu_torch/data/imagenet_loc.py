"""ImageNet-localization validation set with ground-truth boxes (port of
``data/imagenet_loc.py``).

Parses ``LOC_val_solution.csv`` rows ``img_name,"synset x0 y0 x1 y1 ..."``,
maps synsets to labels in sorted order, and carries the FIRST box of each
image through the Resize -> CenterCrop geometry, as the reference
(``dataset.py:22-120``) does. Decode, resize, crop and normalize run on the
host through PIL (``data/transform.py``), imported only when an image is read.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def parse_loc_csv(path: str):
    """LOC_val_solution.csv -> [(img_name, synset, [xywh boxes])]; each
    annotation is groups of ``synset x0 y0 x1 y1``, corners -> xywh."""
    rows = []
    with open(path, newline="") as f:
        for line in f:
            line = line.strip()
            if not line or line.lower().startswith("imageid"):
                continue
            img_name, anno = line.split(",", 1)
            tokens = anno.replace('"', "").split()
            if len(tokens) % 5 != 0 or not tokens:
                continue
            boxes = []
            for i in range(len(tokens) // 5):
                x0, y0, x1, y1 = (float(t) for t in tokens[i * 5 + 1: i * 5 + 5])
                boxes.append([x0, y0, x1 - x0, y1 - y0])
            rows.append((img_name, tokens[0], boxes))
    return rows


def transform_gt_bbox(bbox_xywh: Sequence[float], img_w: float, img_h: float,
                      crop: int = 224) -> np.ndarray:
    """A gt box through Resize(shorter side = crop) + CenterCrop(crop):
    scale by crop / min(w, h), intersect with the centred crop window, shift
    into crop coordinates; [0, 0, 0, 0] if the box falls outside. The box
    frame uses the un-truncated float resize, as the reference's
    ``dataset.py:69-93`` does."""
    r = crop / (img_w if img_w < img_h else img_h)
    x, y, w, h = (v * r for v in bbox_xywh)
    sw, sh = img_w * r, img_h * r
    cx, cy = (sw - crop) / 2.0, (sh - crop) / 2.0
    ix, iy = max(x, cx), max(y, cy)
    iw = min(x + w, cx + crop) - ix
    ih = min(y + h, cy + crop) - iy
    if iw < 0 or ih < 0:
        return np.zeros(4, np.float32)
    return np.asarray([ix - cx, iy - cy, iw, ih], np.float32)


class ImagenetLocalizationDataset:
    """Yields (normalized f32 HWC image, label, gt_bbox), like the
    reference's loader. ``raw_u8=True`` yields the resized and cropped
    uint8 HWC image instead: the sweep's uint8 wire normalizes it on the
    device, and the upload is a quarter of the f32 bytes."""

    def __init__(self, data_dir: str, crop: int = 224, raw_u8: bool = False):
        self.data_dir = data_dir
        self.crop = crop
        self.raw_u8 = raw_u8
        rows = parse_loc_csv(os.path.join(data_dir, "LOC_val_solution.csv"))
        synsets = sorted({synset for _, synset, _ in rows})
        self.synset_to_label = {s: i for i, s in enumerate(synsets)}
        self.items = [(os.path.join(data_dir, synset, img_name + ".JPEG"),
                       self.synset_to_label[synset], boxes)
                      for img_name, synset, boxes in rows]

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        from PIL import Image

        from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform

        path, label, boxes = self.items[index]
        with Image.open(path) as f:
            img = f.convert("RGB")
        img_w, img_h = img.size
        out = pil_eval_transform(img, self.crop, raw=self.raw_u8)
        return out, label, transform_gt_bbox(boxes[0], img_w, img_h, self.crop)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
