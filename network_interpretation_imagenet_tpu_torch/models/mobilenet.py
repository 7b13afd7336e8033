"""MobileNetV2 (port of ``models/mobilenet.py`` of the JAX package) with
torchvision's state-dict keys: ``features.0`` and ``features.18`` are
ConvBNReLU6 (children ``0`` conv, ``1`` BN), ``features.{1..17}`` inverted
residuals whose ``conv`` Sequential holds the pointwise expansion (where
the expansion is not 1), the depthwise 3x3, the linear projection and its
BN; the head ``classifier.1`` reads the global mean.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    global_mean_pool,
    torch_name_by_index,
)

# torchvision inverted_residual_setting: (expansion t, channels c, repeats n, first stride s)
SETTINGS = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
            (6, 160, 3, 2), (6, 320, 1, 1))


class ConvBNReLU6(nn.Sequential):
    def __init__(self, inp: int, out: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1) -> None:
        super().__init__(nn.Conv2d(inp, out, kernel, stride, (kernel - 1) // 2, groups=groups,
                                   bias=False),
                         nn.BatchNorm2d(out), nn.ReLU6())


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int, expand_ratio: int) -> None:
        super().__init__()
        hidden = int(round(inp * expand_ratio))
        self.use_res = stride == 1 and inp == oup
        layers = [ConvBNReLU6(inp, hidden, 1)] if expand_ratio != 1 else []
        layers += [ConvBNReLU6(hidden, hidden, 3, stride, groups=hidden),
                   nn.Conv2d(hidden, oup, 1, bias=False), nn.BatchNorm2d(oup)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv(x) if self.use_res else self.conv(x)


class MobileNetV2(Classifier):
    def __init__(self, num_classes: int = 1000, in_channels: int = 3) -> None:
        super().__init__()
        layers, c_in = [ConvBNReLU6(in_channels, 32, 3, 2)], 32
        for t, c, n, s in SETTINGS:
            for b in range(n):
                layers.append(InvertedResidual(c_in, c, s if b == 0 else 1, t))
                c_in = c
        layers.append(ConvBNReLU6(c_in, 1280, 1))
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(1280, num_classes))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(global_mean_pool(self.features(x)))

    def flax_paths(self) -> list:
        paths = []
        for i, layer in enumerate(self.features):
            p = f"features_{i}"
            paths.append(p)
            if isinstance(layer, ConvBNReLU6):
                paths += [f"{p}/0", f"{p}/1"]
                continue
            for j, sub in enumerate(layer.conv):
                paths.append(f"{p}/conv_{j}")
                if isinstance(sub, ConvBNReLU6):
                    paths += [f"{p}/conv_{j}/0", f"{p}/conv_{j}/1"]
        return paths + ["classifier_1"]

    def torch_name(self, path) -> str:
        return torch_name_by_index(path)
