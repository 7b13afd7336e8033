"""Inception-v3 (port of ``models/inception.py`` of the JAX package) with
torchvision's module and state-dict names (``Conv2d_1a_3x3`` ...
``Mixed_7c``, each ``BasicConv2d`` a ``conv`` / ``bn`` pair with BN eps
1e-3). Every pool is VALID except the branches' 3x3/1/pad-1 average pools
(zeros counted, as in both libraries). ``transform_input`` is torchvision's
re-normalization for its published weights, on as in the JAX package's
``create_model``. The train-only ``AuxLogits`` head is built so that
torchvision checkpoints load as they are; inference never runs it, and the
JAX package has no parameters for it (``optional_prefixes``). The 13
pools of a forward (:data:`POOLS`) go through ``ops/pool_nhwc.py``: its
kernel on the card (and its gradient where autograd records the net), the
library's pools on the CPU.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    BasicConv2d,
    Classifier,
    Dropout,
    global_mean_pool,
    parts_of,
    transform_input,
)
from network_interpretation_imagenet_tpu_torch.ops.pool_nhwc import pool_nhwc


def torch_name(path) -> str:
    """flax names are torchvision's: ``Mixed_5b/branch1x1/conv`` -> ``Mixed_5b.branch1x1.conv``."""
    return ".".join(parts_of(path))


def _avg3(x):
    return pool_nhwc(x, "avg")


def _max3s2(x):
    return pool_nhwc(x, "max")


# The pools of one forward at 299^2, in order: (where, reduce, input side,
# channels); "avg" is 3x3/1/pad 1 with zeros counted, "max" 3x3/2 VALID.
POOLS = (("Conv2d_2b_3x3", "max", 147, 64), ("Conv2d_4a_3x3", "max", 71, 192),
         ("Mixed_5b", "avg", 35, 192), ("Mixed_5c", "avg", 35, 256),
         ("Mixed_5d", "avg", 35, 288), ("Mixed_6a", "max", 35, 288),
         ("Mixed_6b", "avg", 17, 768), ("Mixed_6c", "avg", 17, 768),
         ("Mixed_6d", "avg", 17, 768), ("Mixed_6e", "avg", 17, 768),
         ("Mixed_7a", "max", 17, 768), ("Mixed_7b", "avg", 8, 1280),
         ("Mixed_7c", "avg", 8, 2048))


class _Block(nn.Module):
    """An inception block: ``convs`` are (name, in, out, kernel, stride,
    padding) in torchvision's order, ``forward`` the block's own graph."""

    def __init__(self, convs) -> None:
        super().__init__()
        for name, inp, out, k, s, p in convs:
            self.add_module(name, BasicConv2d(inp, out, k, s, p))


class InceptionA(_Block):
    def __init__(self, inp: int, pool_features: int) -> None:
        super().__init__([("branch1x1", inp, 64, 1, 1, 0), ("branch5x5_1", inp, 48, 1, 1, 0),
                          ("branch5x5_2", 48, 64, 5, 1, 2), ("branch3x3dbl_1", inp, 64, 1, 1, 0),
                          ("branch3x3dbl_2", 64, 96, 3, 1, 1), ("branch3x3dbl_3", 96, 96, 3, 1, 1),
                          ("branch_pool", inp, pool_features, 1, 1, 0)])

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionB(_Block):
    def __init__(self, inp: int) -> None:
        super().__init__([("branch3x3", inp, 384, 3, 2, 0), ("branch3x3dbl_1", inp, 64, 1, 1, 0),
                          ("branch3x3dbl_2", 64, 96, 3, 1, 1), ("branch3x3dbl_3", 96, 96, 3, 2, 0)])

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max3s2(x)], dim=1)


class InceptionC(_Block):
    def __init__(self, inp: int, c7: int) -> None:
        k17, k71, p17, p71 = (1, 7), (7, 1), (0, 3), (3, 0)
        super().__init__([("branch1x1", inp, 192, 1, 1, 0), ("branch7x7_1", inp, c7, 1, 1, 0),
                          ("branch7x7_2", c7, c7, k17, 1, p17),
                          ("branch7x7_3", c7, 192, k71, 1, p71),
                          ("branch7x7dbl_1", inp, c7, 1, 1, 0),
                          ("branch7x7dbl_2", c7, c7, k71, 1, p71),
                          ("branch7x7dbl_3", c7, c7, k17, 1, p17),
                          ("branch7x7dbl_4", c7, c7, k71, 1, p71),
                          ("branch7x7dbl_5", c7, 192, k17, 1, p17),
                          ("branch_pool", inp, 192, 1, 1, 0)])

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionD(_Block):
    def __init__(self, inp: int) -> None:
        super().__init__([("branch3x3_1", inp, 192, 1, 1, 0), ("branch3x3_2", 192, 320, 3, 2, 0),
                          ("branch7x7x3_1", inp, 192, 1, 1, 0),
                          ("branch7x7x3_2", 192, 192, (1, 7), 1, (0, 3)),
                          ("branch7x7x3_3", 192, 192, (7, 1), 1, (3, 0)),
                          ("branch7x7x3_4", 192, 192, 3, 2, 0)])

    def forward(self, x):
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([self.branch3x3_2(self.branch3x3_1(x)), b7, _max3s2(x)], dim=1)


class InceptionE(_Block):
    def __init__(self, inp: int) -> None:
        super().__init__([("branch1x1", inp, 320, 1, 1, 0), ("branch3x3_1", inp, 384, 1, 1, 0),
                          ("branch3x3_2a", 384, 384, (1, 3), 1, (0, 1)),
                          ("branch3x3_2b", 384, 384, (3, 1), 1, (1, 0)),
                          ("branch3x3dbl_1", inp, 448, 1, 1, 0),
                          ("branch3x3dbl_2", 448, 384, 3, 1, 1),
                          ("branch3x3dbl_3a", 384, 384, (1, 3), 1, (0, 1)),
                          ("branch3x3dbl_3b", 384, 384, (3, 1), 1, (1, 0)),
                          ("branch_pool", inp, 192, 1, 1, 0)])

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], dim=1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg3(x))], dim=1)


class InceptionAux(nn.Module):
    """torchvision's train-only auxiliary head (loaded, never run)."""

    def __init__(self, inp: int, num_classes: int) -> None:
        super().__init__()
        self.conv0 = BasicConv2d(inp, 128, 1)
        self.conv1 = BasicConv2d(128, 768, 5)
        self.fc = nn.Linear(768, num_classes)


_STEM = (("Conv2d_1a_3x3", 32, 3, 2, 0), ("Conv2d_2a_3x3", 32, 3, 1, 0),
         ("Conv2d_2b_3x3", 64, 3, 1, 1), ("Conv2d_3b_1x1", 80, 1, 1, 0),
         ("Conv2d_4a_3x3", 192, 3, 1, 0))
_MIXED = ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c", "Mixed_6d",
          "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c")


class InceptionV3(Classifier):
    optional_prefixes = ("AuxLogits.",)

    def __init__(self, num_classes: int = 1000, transform_input: bool = False,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.transform_input = bool(transform_input)
        inp = in_channels
        for name, out, k, s, p in _STEM:
            self.add_module(name, BasicConv2d(inp, out, k, s, p))
            inp = out
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.AuxLogits = InceptionAux(768, num_classes)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.dropout = Dropout(0.5)
        self.fc = nn.Linear(2048, num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        if self.transform_input:
            x = transform_input(x)
        for i, (name, *_) in enumerate(_STEM):
            x = getattr(self, name)(x)
            if i in (2, 4):
                x = _max3s2(x)
        for name in _MIXED:
            x = getattr(self, name)(x)
        return self.fc(self.dropout(global_mean_pool(x)))

    def flax_paths(self) -> list:
        paths = []
        for name in [n for n, *_ in _STEM] + list(_MIXED):
            paths.append(name)
            for sub, m in getattr(self, name).named_modules():
                if sub:
                    paths.append(f"{name}/{sub.replace('.', '/')}")
        return paths + ["fc"]

    def torch_name(self, path) -> str:
        return torch_name(path)
