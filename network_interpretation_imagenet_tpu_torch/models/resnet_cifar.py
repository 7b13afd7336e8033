"""The CIFAR ResNet-6N+2 (port of ``models/resnet_cifar.py`` of the JAX
package, the reference's ``models/resnet.py``) with stochastic depth.

Each block's residual branch reads the block input before the shortcut
downsamples it (its first conv carries the stride); the shortcut is the
parameter-free ``DownsampleB``: an average pool of the stride, then the
channels padded with zeros. Eval mode adds the whole branch, unscaled, for
every death rate. In training a block with death rate d > 0 follows JAX
``resnet_cifar.py:54-104``: its branch is scaled by ``1 / (1 - d)``, one
uniform draw u decides ``alive = u >= d``, a live block returns
``relu(shortcut + branch)`` and a dead one the shortcut itself, without the
ReLU. The branch is computed, and its BatchNorm statistics updated, dead or
alive (the reference's torch code skips a dead branch; the JAX package, which
the port is held to, does not). :func:`death_rates_for` is the reference's
schedule. State-dict keys are the reference's (``conv1``, ``bn1``,
``layer{1..3}.{b}.{conv1,bn1,conv2,bn2}``, ``fc``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    Drawing,
    avg_pool,
    conv_side,
    flatten_hwc,
    head_features,
)
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import torch_name


class DownsampleB(nn.Module):
    """Average pool of ``stride``, then zero channels up to ``out_channels``."""

    def __init__(self, out_channels: int, stride: int) -> None:
        super().__init__()
        self.out_channels, self.stride = int(out_channels), int(stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = avg_pool(x, self.stride)
        reps = self.out_channels // x.shape[1]
        return torch.cat([x] + [torch.zeros_like(x)] * (reps - 1), dim=1) if reps > 1 else x


class CifarBlock(Drawing):
    def __init__(self, inplanes: int, planes: int, stride: int, downsample: bool,
                 death_rate: float = 0.0) -> None:
        super().__init__()
        self.death_rate = float(death_rate)
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = DownsampleB(planes, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        shortcut = x if self.downsample is None else self.downsample(x)
        if not (self.training and self.death_rate > 0):
            return torch.relu(shortcut + r)
        alive = self.source().alive(self.draw_name, self.death_rate, x.device)
        return torch.where(alive, torch.relu(shortcut + r / (1.0 - self.death_rate)), shortcut)


class ResNetCifar(Classifier):
    def __init__(self, depth: int = 56, num_classes: int = 10, in_channels: int = 3,
                 input_size: int = 32, death_rates=None) -> None:
        super().__init__()
        if (depth - 2) % 6:
            raise ValueError(f"depth should be 6N+2, got {depth}")
        self.depth = int(depth)
        self.n = (depth - 2) // 6
        self.death_rates = death_rates
        rates = list(death_rates) if death_rates is not None else [0.0] * (3 * self.n)
        self.conv1 = nn.Conv2d(in_channels, 16, 3, 1, 1, bias=False)
        self.bn1 = BatchNorm2d(16)
        inplanes = 16
        for stage, planes in enumerate((16, 32, 64)):
            blocks = []
            for b in range(self.n):
                s = 2 if stage > 0 and b == 0 else 1
                blocks.append(CifarBlock(inplanes, planes, s, s != 1 or inplanes != planes,
                                         rates[stage * self.n + b]))
                inplanes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        # The head reads the final 8x8 average pool flattened (H, W, C): 64
        # features at 32^2 (JAX sizes its Dense from the input it is built on).
        side = conv_side(conv_side(conv_side(input_size, 3, 2, 1), 3, 2, 1), 8, 8)
        self.fc = nn.Linear(head_features(64, side, input_size, "the CIFAR ResNet"), num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(flatten_hwc(avg_pool(x, 8)))

    def flax_paths(self) -> list:
        paths = ["conv1", "bn1"]
        for s in range(1, 4):
            for b, block in enumerate(getattr(self, f"layer{s}")):
                p = f"layer{s}_{b}"
                paths += [p, f"{p}/conv1", f"{p}/bn1", f"{p}/conv2", f"{p}/bn2"]
                if block.downsample is not None:
                    paths.append(f"{p}/downsample")
        return paths + ["fc"]

    def torch_name(self, path) -> str:
        return torch_name(path)


def death_rates_for(depth: int, death_mode: str = "none",
                    death_rate: float = 0.5) -> Optional[list]:
    """The reference's ``createModel`` schedule (``models/resnet.py:149-162``),
    with its ``nblocks = (depth - 2) // 2``."""
    nblocks = (depth - 2) // 2
    if death_mode == "uniform":
        return [death_rate] * nblocks
    if death_mode == "linear":
        return [float(i + 1) * death_rate / float(nblocks) for i in range(nblocks)]
    return None
