"""VGG-11/13/16/19 with and without BatchNorm (port of ``models/vgg.py`` of
the JAX package), with torchvision's state-dict keys (``features.{i}``,
``classifier.{0,3,6}``). As in the JAX package there is no adaptive pool:
the last feature map is flattened in torch's (C, H, W) order (7 x 7 x 512
at 224^2) and the first Dense is sized by the input side.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    head_features,
    parts_of,
)

CFGS = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
    "vgg19": (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
              512, "M", 512, 512, 512, 512, "M"),
}


def vgg_names(cfg, batch_norm: bool) -> dict:
    """{flax name: torch name}: ``conv{k}`` / ``bn{k}`` -> ``features.{i}``
    (each conv followed by its BN, where there is one, and a ReLU; each "M"
    one max pool), ``fc{j}`` -> ``classifier.{3 j}``."""
    names, i = {}, 0
    for v in cfg:
        if v == "M":
            i += 1
            continue
        k = sum(n.startswith("conv") for n in names)
        names[f"conv{k}"] = f"features.{i}"
        if batch_norm:
            names[f"bn{k}"] = f"features.{i + 1}"
        i += 3 if batch_norm else 2
    names.update({f"fc{j}": f"classifier.{3 * j}" for j in range(3)})
    return names


class VGG(Classifier):
    def __init__(self, cfg, batch_norm: bool = False, num_classes: int = 1000,
                 in_channels: int = 3, input_size: int = 224) -> None:
        super().__init__()
        layers, inp, side = [], in_channels, input_size
        for v in cfg:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
                side //= 2
                continue
            layers.append(nn.Conv2d(inp, int(v), 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2d(int(v)))
            layers.append(nn.ReLU())
            inp = int(v)
        self.features = nn.Sequential(*layers)
        # torchvision's Dropout slots hold Identity: the JAX model has no
        # dropout, so none is live in training either.
        self.classifier = nn.Sequential(
            nn.Linear(head_features(inp, side, input_size, "VGG"), 4096), nn.ReLU(), nn.Identity(),
            nn.Linear(4096, 4096), nn.ReLU(), nn.Identity(), nn.Linear(4096, num_classes))
        self._names = vgg_names(cfg, batch_norm)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.features(x), 1))

    def flax_paths(self) -> list:
        return list(self._names)

    def torch_name(self, path) -> str:
        parts = parts_of(path)
        return ".".join((self._names[parts[0]],) + parts[1:])


def create_vgg(arch: str, num_classes: int = 1000, in_channels: int = 3,
               input_size: int = 224) -> VGG:
    batch_norm = arch.endswith("_bn")
    return VGG(CFGS[arch[:-3] if batch_norm else arch], batch_norm, num_classes,
               in_channels, input_size)
