"""DenseNet-BC (port of ``models/densenet.py`` of the JAX package, the
reference's ``models/densenet.py``) and torchvision's DenseNet-121/169/201.

Dense layers are BN -> ReLU -> 1x1 (bn_size * k) -> BN -> ReLU -> 3x3 (k),
concatenated onto their input (a single 3x3 where ``bn_size <= 0``);
transitions BN -> ReLU -> 1x1 -> 2x2 average pool; the head BN -> ReLU ->
``avgpool_size`` average pool (7 for ImageNet, 8 otherwise) -> flatten in
the JAX package's (H, W, C) order -> Dense. The reference's stem is one 3x3
conv; torchvision's (``imagenet_stem``) a 7x7/2 conv and a 3x3/2 max pool.
State-dict keys are torchvision's current ones (``features.conv0``,
``features.denseblock1.denselayer1.norm1``, ``features.transition1.conv``,
``features.norm5``, ``classifier``); ``utils.convert`` maps the reference
era's dotted ``norm.1`` / ``conv.1`` onto them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    avg_pool,
    conv_side,
    flatten_hwc,
    parts_of,
    head_features,
)


def torch_name(path) -> str:
    """``denseblock2_layer3/norm1`` -> ``features.denseblock2.denselayer3.norm1``;
    ``classifier`` stays; every other top-level module is under ``features``."""
    parts = list(parts_of(path))
    if parts[0] == "classifier":
        return ".".join(parts)
    if parts[0].startswith("denseblock"):
        block, layer = parts[0].split("_layer")
        parts[0] = f"{block}.denselayer{layer}"
    return "features." + ".".join(parts)


class DenseLayer(nn.Module):
    def __init__(self, inp: int, growth_rate: int, bn_size: int) -> None:
        super().__init__()
        self.norm1 = nn.BatchNorm2d(inp)
        if bn_size > 0:
            self.conv1 = nn.Conv2d(inp, bn_size * growth_rate, 1, bias=False)
            self.norm2 = nn.BatchNorm2d(bn_size * growth_rate)
            self.conv2 = nn.Conv2d(bn_size * growth_rate, growth_rate, 3, padding=1, bias=False)
        else:
            self.conv1 = nn.Conv2d(inp, growth_rate, 3, padding=1, bias=False)
        self.bottleneck = bn_size > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1(torch.relu(self.norm1(x)))
        if self.bottleneck:
            y = self.conv2(torch.relu(self.norm2(y)))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, inp: int, out: int) -> None:
        super().__init__()
        self.norm = nn.BatchNorm2d(inp)
        self.conv = nn.Conv2d(inp, out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return avg_pool(self.conv(torch.relu(self.norm(x))), 2)


class DenseNet(Classifier):
    def __init__(self, growth_rate: int = 12, block_config: Sequence[int] = (16, 16, 16),
                 compression: float = 0.5, num_init_features: int = 24, bn_size: int = 4,
                 avgpool_size: int = 8, num_classes: int = 10, imagenet_stem: bool = False,
                 in_channels: int = 3, input_size: int = 32) -> None:
        super().__init__()
        self.block_config = tuple(int(n) for n in block_config)
        self.avgpool_size = int(avgpool_size)
        self.imagenet_stem = bool(imagenet_stem)
        self.features = nn.Module()
        f = self.features
        if imagenet_stem:
            f.conv0 = nn.Conv2d(in_channels, num_init_features, 7, 2, 3, bias=False)
            side = conv_side(conv_side(input_size, 7, 2, 3), 3, 2, 1)
        else:
            f.conv0 = nn.Conv2d(in_channels, num_init_features, 3, 1, 1, bias=False)
            side = input_size
        f.norm0 = nn.BatchNorm2d(num_init_features)
        num = num_init_features
        for i, n_layers in enumerate(self.block_config, start=1):
            block = nn.Module()
            for j in range(1, n_layers + 1):
                block.add_module(f"denselayer{j}", DenseLayer(num, growth_rate, bn_size))
                num += growth_rate
            f.add_module(f"denseblock{i}", block)
            if i != len(self.block_config):
                out = int(num * compression)
                f.add_module(f"transition{i}", Transition(num, out))
                num, side = out, conv_side(side, 2, 2)
        f.norm5 = nn.BatchNorm2d(num)
        side = conv_side(side, self.avgpool_size, self.avgpool_size)
        self.classifier = nn.Linear(head_features(num, side, input_size, "this DenseNet"),
                                    num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        f = self.features
        x = torch.relu(f.norm0(f.conv0(x)))
        if self.imagenet_stem:
            x = torch.nn.functional.max_pool2d(x, 3, 2, padding=1)
        for i, n_layers in enumerate(self.block_config, start=1):
            block = getattr(f, f"denseblock{i}")
            for j in range(1, n_layers + 1):
                x = getattr(block, f"denselayer{j}")(x)
            if i != len(self.block_config):
                x = getattr(f, f"transition{i}")(x)
        x = avg_pool(torch.relu(f.norm5(x)), self.avgpool_size)
        return self.classifier(flatten_hwc(x))

    def flax_paths(self) -> list:
        paths = ["conv0", "norm0"]
        for i, n_layers in enumerate(self.block_config, start=1):
            for j in range(1, n_layers + 1):
                p = f"denseblock{i}_layer{j}"
                layer = getattr(getattr(self.features, f"denseblock{i}"), f"denselayer{j}")
                paths += [p, f"{p}/norm1", f"{p}/conv1"]
                if layer.bottleneck:
                    paths += [f"{p}/norm2", f"{p}/conv2"]
            if i != len(self.block_config):
                paths += [f"transition{i}", f"transition{i}/norm", f"transition{i}/conv"]
        return paths + ["norm5", "classifier"]

    def torch_name(self, path) -> str:
        return torch_name(path)


TV_CONFIGS = {
    "densenet121": (6, 12, 24, 16),
    "densenet169": (6, 12, 32, 32),
    "densenet201": (6, 12, 48, 32),
}


def create_densenet_torchvision(arch: str, num_classes: int = 1000, in_channels: int = 3,
                                input_size: int = 224) -> DenseNet:
    """torchvision DenseNet-121/169/201: growth 32, 64 initial features,
    the 7x7 stem, a 7x7 final pool."""
    return DenseNet(growth_rate=32, block_config=TV_CONFIGS[arch], compression=0.5,
                    num_init_features=64, bn_size=4, avgpool_size=7, num_classes=num_classes,
                    imagenet_stem=True, in_channels=in_channels, input_size=input_size)


def create_densenet(data: str = "cifar10", depth: int = 100, growth_rate: int = 12,
                    num_classes: int = 10, num_init_features: int = 24,
                    compression: float = 0.5, bn_size: int = 4, in_channels: int = 3,
                    input_size: int = 32) -> DenseNet:
    """The reference's ``createModel`` (``models/densenet.py:102-120``):
    depth 3N+4, N / 2 layers per block with bottlenecks."""
    if (depth - 4) % 3:
        raise ValueError(f"depth should be 3N+4, got {depth}")
    n = (depth - 4) // 3
    if bn_size > 0:
        n //= 2
    return DenseNet(growth_rate=growth_rate, block_config=(n, n, n), compression=compression,
                    num_init_features=num_init_features, bn_size=bn_size,
                    avgpool_size=7 if data == "imagenet" else 8, num_classes=num_classes,
                    in_channels=in_channels, input_size=input_size)
