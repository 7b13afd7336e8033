"""GoogLeNet (port of ``models/googlenet.py`` of the JAX package) with
torchvision's module and state-dict names: ``BasicConv2d`` (conv, BN eps
1e-3, ReLU), ceil-mode max pools, four-branch blocks whose "5x5" branch is
torchvision's 3x3, and ``transform_input`` on as in the JAX package's
``create_model``. The train-only ``aux1`` / ``aux2`` heads are built so
that torchvision checkpoints load as they are; inference never runs them.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    BasicConv2d,
    Classifier,
    global_mean_pool,
    max_pool_ceil,
    torch_name_by_index,
    transform_input,
)


class _CeilPool(nn.Module):
    def __init__(self, window: int, stride: int, padding: int = 0) -> None:
        super().__init__()
        self.args = (window, stride, padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_ceil(x, *self.args)


class Inception(nn.Module):
    def __init__(self, inp, ch1x1, ch3x3red, ch3x3, ch5x5red, ch5x5, pool_proj) -> None:
        super().__init__()
        self.branch1 = BasicConv2d(inp, ch1x1, 1)
        self.branch2 = nn.Sequential(BasicConv2d(inp, ch3x3red, 1),
                                     BasicConv2d(ch3x3red, ch3x3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(inp, ch5x5red, 1),
                                     BasicConv2d(ch5x5red, ch5x5, 3, padding=1))
        self.branch4 = nn.Sequential(_CeilPool(3, 1, 1), BasicConv2d(inp, pool_proj, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x), self.branch4(x)],
                         dim=1)


class InceptionAux(nn.Module):
    """torchvision's train-only auxiliary head (loaded, never run)."""

    def __init__(self, inp: int, num_classes: int) -> None:
        super().__init__()
        self.conv = BasicConv2d(inp, 128, 1)
        self.fc1 = nn.Linear(2048, 1024)
        self.fc2 = nn.Linear(1024, num_classes)


# name, then Inception(in, 1x1, 3x3 reduce, 3x3, "5x5" reduce, "5x5", pool proj) or a pool
_PLAN = (("inception3a", (192, 64, 96, 128, 16, 32, 32)),
         ("inception3b", (256, 128, 128, 192, 32, 96, 64)), ("maxpool3", (3, 2)),
         ("inception4a", (480, 192, 96, 208, 16, 48, 64)),
         ("inception4b", (512, 160, 112, 224, 24, 64, 64)),
         ("inception4c", (512, 128, 128, 256, 24, 64, 64)),
         ("inception4d", (512, 112, 144, 288, 32, 64, 64)),
         ("inception4e", (528, 256, 160, 320, 32, 128, 128)), ("maxpool4", (2, 2)),
         ("inception5a", (832, 256, 160, 320, 32, 128, 128)),
         ("inception5b", (832, 384, 192, 384, 48, 128, 128)))


class GoogLeNet(Classifier):
    optional_prefixes = ("aux1.", "aux2.")

    def __init__(self, num_classes: int = 1000, transform_input: bool = False,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.transform_input = bool(transform_input)
        self.conv1 = BasicConv2d(in_channels, 64, 7, 2, 3)
        self.maxpool1 = _CeilPool(3, 2)
        self.conv2 = BasicConv2d(64, 64, 1)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        self.maxpool2 = _CeilPool(3, 2)
        for name, args in _PLAN:
            self.add_module(name, _CeilPool(*args) if name.startswith("maxpool")
                            else Inception(*args))
        self.aux1 = InceptionAux(512, num_classes)
        self.aux2 = InceptionAux(528, num_classes)
        self.fc = nn.Linear(1024, num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = transform_input(x)
        x = self.maxpool2(self.conv3(self.conv2(self.maxpool1(self.conv1(x)))))
        for name, _ in _PLAN:
            x = getattr(self, name)(x)
        return self.fc(global_mean_pool(x))

    def flax_paths(self) -> list:
        paths = []
        for name in ("conv1", "conv2", "conv3") + tuple(n for n, _ in _PLAN):
            if name.startswith("maxpool"):
                continue
            paths.append(name)
            if name.startswith("conv"):
                paths += [f"{name}/conv", f"{name}/bn"]
                continue
            for branch in ("branch1", "branch2_0", "branch2_1", "branch3_0", "branch3_1",
                           "branch4_1"):
                paths += [f"{name}/{branch}", f"{name}/{branch}/conv", f"{name}/{branch}/bn"]
        return paths + ["fc"]

    def torch_name(self, path) -> str:
        return torch_name_by_index(path)
