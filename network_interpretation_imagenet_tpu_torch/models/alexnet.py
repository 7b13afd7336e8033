"""AlexNet (port of ``models/alexnet.py`` of the JAX package) with
torchvision's state-dict keys (convs ``features.{0,3,6,8,10}``, linears
``classifier.{1,4,6}``). As in the JAX package there is no adaptive pool:
the last feature map (6 x 6 x 256 at 224^2) is flattened in torch's
(C, H, W) order and the first Dense is sized by the input side.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    Dropout,
    conv_side,
    head_features,
    parts_of,
)

_NAMES = {**{f"conv{i}": f"features.{j}" for i, j in enumerate((0, 3, 6, 8, 10))},
          **{f"fc{i}": f"classifier.{j}" for i, j in enumerate((1, 4, 6))}}


def torch_name(path) -> str:
    parts = parts_of(path)
    return ".".join((_NAMES[parts[0]],) + parts[1:])


class AlexNet(Classifier):
    def __init__(self, num_classes: int = 1000, in_channels: int = 3,
                 input_size: int = 224) -> None:
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(in_channels, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(), nn.MaxPool2d(3, 2))
        side = conv_side(conv_side(conv_side(conv_side(input_size, 11, 4, 2), 3, 2), 3, 2), 3, 2)
        self.classifier = nn.Sequential(
            Dropout(0.5), nn.Linear(head_features(256, side, input_size, "AlexNet"), 4096),
            nn.ReLU(), Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(),
            nn.Linear(4096, num_classes))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(torch.flatten(self.features(x), 1))

    def flax_paths(self) -> list:
        return list(_NAMES)

    def torch_name(self, path) -> str:
        return torch_name(path)
