"""SqueezeNet 1.0 / 1.1 (port of ``models/squeezenet.py`` of the JAX
package) with torchvision's state-dict keys: the stem ``features.0`` (no
padding), Fire modules at ``features.{3,4,5,7,8,9,10,12}`` (1.0) or
``features.{3,4,6,7,9,10,11,12}`` (1.1), ceil-mode 3x3/2 max pools between,
and the head ``classifier.1``, a 1x1 conv -> ReLU -> global mean.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    global_mean_pool,
    max_pool_ceil,
    parts_of,
)

# "P" is a 3x3/2 ceil-mode max pool; a tuple is Fire(squeeze, expand1x1, expand3x3).
PLANS = {
    "1_0": ("P", (16, 64, 64), (16, 64, 64), (32, 128, 128), "P", (32, 128, 128),
            (48, 192, 192), (48, 192, 192), (64, 256, 256), "P", (64, 256, 256)),
    "1_1": ("P", (16, 64, 64), (16, 64, 64), "P", (32, 128, 128), (32, 128, 128), "P",
            (48, 192, 192), (48, 192, 192), (64, 256, 256), (64, 256, 256)),
}


def squeezenet_names(version: str) -> dict:
    """{flax name: torch name}: ``conv0`` -> ``features.0``, ``fire{j}`` ->
    the Fire's ``features`` index, ``Dropout_0`` / ``classifier`` ->
    ``classifier.0`` / ``classifier.1``."""
    names, i = {"conv0": "features.0"}, 2
    for step in PLANS[version]:
        if step != "P":
            names[f"fire{len(names) - 1}"] = f"features.{i}"
        i += 1
    names.update({"Dropout_0": "classifier.0", "classifier": "classifier.1"})
    return names


class Fire(nn.Module):
    def __init__(self, inp: int, squeeze: int, expand1x1: int, expand3x3: int) -> None:
        super().__init__()
        self.squeeze = nn.Conv2d(inp, squeeze, 1)
        self.expand1x1 = nn.Conv2d(squeeze, expand1x1, 1)
        self.expand3x3 = nn.Conv2d(squeeze, expand3x3, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.squeeze(x))
        return torch.cat([torch.relu(self.expand1x1(x)), torch.relu(self.expand3x3(x))], dim=1)


class _CeilPool(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_ceil(x, 3, 2)


class SqueezeNet(Classifier):
    def __init__(self, version: str = "1_1", num_classes: int = 1000,
                 in_channels: int = 3) -> None:
        super().__init__()
        stem = (nn.Conv2d(in_channels, 96, 7, 2) if version == "1_0"
                else nn.Conv2d(in_channels, 64, 3, 2))
        layers, inp = [stem, nn.ReLU()], stem.out_channels
        for step in PLANS[version]:
            if step == "P":
                layers.append(_CeilPool())
            else:
                layers.append(Fire(inp, *step))
                inp = step[1] + step[2]
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Dropout(), nn.Conv2d(inp, num_classes, 1))
        self._names = squeezenet_names(version)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return global_mean_pool(torch.relu(self.classifier(self.features(x))))

    def flax_paths(self) -> list:
        paths = []
        for name in self._names:
            paths.append(name)
            if name.startswith("fire"):
                paths += [f"{name}/squeeze", f"{name}/expand1x1", f"{name}/expand3x3"]
        return paths

    def torch_name(self, path) -> str:
        parts = parts_of(path)
        return ".".join((self._names[parts[0]],) + parts[1:])
