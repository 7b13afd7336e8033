"""torchvision-``ImageFolder``-style dataset: class subdirectories, no boxes
(port of ``data/image_folder.py``)."""

from __future__ import annotations

import os

_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


class ImageFolderDataset:
    """Yields (normalized f32 HWC image, label, None), or the resized and
    cropped uint8 HWC image with ``raw_u8=True`` (the sweep's uint8 wire).
    Labels follow torchvision: sorted subdirectory names -> 0..C-1, files
    sorted within each class."""

    def __init__(self, data_dir: str, crop: int = 224, raw_u8: bool = False):
        self.crop = crop
        self.raw_u8 = raw_u8
        classes = sorted(d for d in os.listdir(data_dir)
                         if os.path.isdir(os.path.join(data_dir, d)))
        self.class_to_label = {c: i for i, c in enumerate(classes)}
        self.items = []
        for c in classes:
            cdir = os.path.join(data_dir, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(_EXTS):
                    self.items.append((os.path.join(cdir, fname), self.class_to_label[c]))

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, index: int):
        from PIL import Image

        from network_interpretation_imagenet_tpu_torch.data.transform import pil_eval_transform

        path, label = self.items[index]
        with Image.open(path) as f:
            img = f.convert("RGB")
        return pil_eval_transform(img, self.crop, raw=self.raw_u8), label, None

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
