"""MNASNet 0.5 / 0.75 / 1.0 / 1.3 (port of ``models/mnasnet.py`` of the JAX
package) with torchvision's state-dict keys: the stem ``layers.{0..7}``
(conv, BN, ReLU, depthwise 3x3, BN, ReLU, 1x1 projection, BN), six MBConv
stacks ``layers.{8..13}.{b}.layers.{0..7}``, the tail ``layers.{14,15}``
and ``classifier.1``. Depths are torchvision's alpha-scaled ones.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    global_mean_pool,
    torch_name_by_index,
)

_BASE_DEPTHS = (32, 16, 24, 40, 80, 96, 192, 320)
# layers.8..13: (kernel, stride, expansion, repeats)
STACKS = ((3, 2, 3, 3), (5, 2, 3, 3), (5, 2, 6, 3), (3, 1, 6, 2), (5, 2, 6, 4), (3, 1, 6, 1))


def _round_to_8(val: float) -> int:
    new_val = max(8, int(val + 8 / 2) // 8 * 8)
    return new_val if new_val >= 0.9 * val else new_val + 8


def get_depths(alpha: float) -> list:
    return [_round_to_8(d * alpha) for d in _BASE_DEPTHS]


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int, expansion: int) -> None:
        super().__init__()
        mid = in_ch * expansion
        self.residual = in_ch == out_ch and stride == 1
        self.layers = nn.Sequential(
            nn.Conv2d(in_ch, mid, 1, bias=False), nn.BatchNorm2d(mid), nn.ReLU(),
            nn.Conv2d(mid, mid, kernel, stride, kernel // 2, groups=mid, bias=False),
            nn.BatchNorm2d(mid), nn.ReLU(),
            nn.Conv2d(mid, out_ch, 1, bias=False), nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.layers(x) if self.residual else self.layers(x)


class MNASNet(Classifier):
    def __init__(self, alpha: float = 1.0, num_classes: int = 1000, in_channels: int = 3) -> None:
        super().__init__()
        d = get_depths(alpha)
        layers = [nn.Conv2d(in_channels, d[0], 3, 2, 1, bias=False), nn.BatchNorm2d(d[0]),
                  nn.ReLU(), nn.Conv2d(d[0], d[0], 3, 1, 1, groups=d[0], bias=False),
                  nn.BatchNorm2d(d[0]), nn.ReLU(), nn.Conv2d(d[0], d[1], 1, bias=False),
                  nn.BatchNorm2d(d[1])]
        c_in = d[1]
        for (k, s, e, r), c_out in zip(STACKS, d[2:]):
            units = []
            for b in range(r):
                units.append(InvertedResidual(c_in, c_out, k, s if b == 0 else 1, e))
                c_in = c_out
            layers.append(nn.Sequential(*units))
        layers += [nn.Conv2d(c_in, 1280, 1, bias=False), nn.BatchNorm2d(1280), nn.ReLU()]
        self.layers = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(0.2), nn.Linear(1280, num_classes))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.classifier(global_mean_pool(self.layers(x)))

    def flax_paths(self) -> list:
        paths = [f"layers_{i}" for i in (0, 1, 3, 4, 6, 7)]
        for li, (_, _, _, r) in enumerate(STACKS, start=8):
            for b in range(r):
                p = f"layers_{li}_{b}"
                paths += [p] + [f"{p}/layers_{i}" for i in (0, 1, 3, 4, 6, 7)]
        return paths + ["layers_14", "layers_15", "classifier_1"]

    def torch_name(self, path) -> str:
        return torch_name_by_index(path)
