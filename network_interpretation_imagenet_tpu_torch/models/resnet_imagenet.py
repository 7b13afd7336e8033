"""ImageNet ResNet, Bottleneck family (ResNet-50/101/152).

Port of ``models/resnet_imagenet.py`` of the JAX package: torchvision's v1.5
architecture (post-activation, stride on the 3x3) with torchvision's
``state_dict`` key names. :class:`ResNet` holds the parameters and its
``forward`` is the plain eval-mode network. :class:`FoldedResNet` is the
inference plan the engine runs: BatchNorm folded into every convolution once
when it is built, activations kept NHWC in memory (channels_last), the stem
and the first (projection) block of each stage as plain torch ops, and each
stage's remaining stride-1 identity blocks as one ``bottleneck_chain`` call.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import fold_bn, max_pool_same
from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
    bottleneck_chain,
    bottleneck_chain_plain,
)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        out = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                          nn.BatchNorm2d(out))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-compatible Bottleneck ResNet; ``forward`` takes NHWC."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000) -> None:
        super().__init__()
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes = 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            planes = 64 * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                ds = stride != 1 or inplanes != planes * Bottleneck.expansion
                blocks.append(Bottleneck(inplanes, planes, stride, ds))
                inplanes = planes * Bottleneck.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = nn.Linear(inplanes, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC [B, H, W, 3] -> [B, num_classes] logits (BatchNorm in eval
        mode when the module is)."""
        x = x.permute(0, 3, 1, 2)
        x = max_pool_same(torch.relu(self.bn1(self.conv1(x))), 3, 2)
        for stage in range(len(self.stage_sizes)):
            x = getattr(self, f"layer{stage + 1}")(x)
        return self.fc(x.mean(dim=(2, 3)))

    def init_state_dict(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """A seeded random ``state_dict`` with torchvision's init: convs
        Kaiming-normal (fan_out, ReLU), BatchNorm weight 1 / bias 0 / running
        statistics 0 and 1, ``fc`` uniform in ``+-1/sqrt(fan_in)``."""
        sd = {}
        for name, t in self.state_dict().items():
            if name.endswith("num_batches_tracked"):
                sd[name] = torch.zeros_like(t)
            elif t.dim() == 4:
                fan_out = t.shape[0] * t.shape[2] * t.shape[3]
                sd[name] = torch.randn(t.shape, generator=generator) * math.sqrt(2.0 / fan_out)
            elif name.startswith("fc."):
                bound = 1.0 / math.sqrt(self.fc.in_features)
                sd[name] = (torch.rand(t.shape, generator=generator) * 2 - 1) * bound
            elif name.endswith(("weight", "running_var")):
                sd[name] = torch.ones_like(t)
            else:
                sd[name] = torch.zeros_like(t)
        return sd


_CONFIGS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
}


def create_resnet(arch: str, num_classes: int = 1000) -> ResNet:
    return ResNet(_CONFIGS[arch], num_classes=num_classes)


def _array(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class FoldedResNet:
    """The inference plan of a Bottleneck ResNet, built once from a
    ``state_dict``: BatchNorm folded (``fold_bn``) and every weight cast to
    ``dtype`` on ``device``. Calling it maps NHWC ``dtype`` images to f32
    logits; ``plain=True`` runs the chains through their plain version (the
    comparison the card makes)."""

    def __init__(self, state_dict, stage_sizes: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16, device="cpu") -> None:
        self.dtype = dtype
        self.device = torch.device(device)

        def folded(conv: str, bn: str):
            w = np.transpose(_array(state_dict[conv + ".weight"]), (2, 3, 1, 0))  # HWIO
            return fold_bn(w, *(_array(state_dict[f"{bn}.{k}"])
                                 for k in ("weight", "bias", "running_mean", "running_var")))

        def torch_conv(conv: str, bn: str, stride: int, padding: int):
            w, b = folded(conv, bn)
            w = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
            return (w.to(self.device, dtype).contiguous(memory_format=torch.channels_last),
                    torch.from_numpy(b).to(self.device, dtype), stride, padding)

        def matrix(w: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(w)).to(self.device, dtype)

        def bias(b: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(b).to(self.device, torch.float32)

        self.stem = torch_conv("conv1", "bn1", 2, 3)
        self.stages = []
        for s, num_blocks in enumerate(stage_sizes, start=1):
            stride = 1 if s == 1 else 2
            p = f"layer{s}.0"
            first = (torch_conv(f"{p}.conv1", f"{p}.bn1", 1, 0),
                     torch_conv(f"{p}.conv2", f"{p}.bn2", stride, 1),
                     torch_conv(f"{p}.conv3", f"{p}.bn3", 1, 0))
            ds = (torch_conv(f"{p}.downsample.0", f"{p}.downsample.1", stride, 0)
                  if f"{p}.downsample.0.weight" in state_dict else None)
            chain = []
            for b in range(1, num_blocks):
                q = f"layer{s}.{b}"
                w1, b1 = folded(f"{q}.conv1", f"{q}.bn1")
                w3, b3 = folded(f"{q}.conv2", f"{q}.bn2")
                w2, b2 = folded(f"{q}.conv3", f"{q}.bn3")
                chain += [matrix(w1[0, 0]), bias(b1), matrix(w3), bias(b3),
                          matrix(w2[0, 0]), bias(b2)]
            self.stages.append((first, ds, chain))
        self.fc_w = torch.from_numpy(_array(state_dict["fc.weight"]).T.copy()).to(self.device)
        self.fc_b = torch.from_numpy(_array(state_dict["fc.bias"])).to(self.device)

    @staticmethod
    def _conv(x, op, relu: bool):
        w, b, stride, padding = op
        y = F.conv2d(x, w, b, stride, padding)
        return torch.relu(y) if relu else y

    def __call__(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        chain_fn = bottleneck_chain_plain if plain else bottleneck_chain
        y = x.permute(0, 3, 1, 2)  # NHWC memory, NCHW view: channels_last
        y = max_pool_same(self._conv(y, self.stem, True), 3, 2)
        for (c1, c2, c3), ds, chain in self.stages:
            out = self._conv(self._conv(self._conv(y, c1, True), c2, True), c3, False)
            y = torch.relu(out + (y if ds is None else self._conv(y, ds, False)))
            if chain:
                if not y.is_contiguous(memory_format=torch.channels_last):
                    raise RuntimeError("activations left channels_last before a chain")
                y = chain_fn(y.permute(0, 2, 3, 1), chain).permute(0, 3, 1, 2)
        return torch.matmul(y.float().mean(dim=(2, 3)), self.fc_w) + self.fc_b
