"""Shared model pieces (port of ``models/common.py`` of the JAX package):
pools with the JAX package's semantics, ``ConvBNRelu``, the seeded random
init every classifier shares, and inference BatchNorm folding.

Every function here takes NCHW tensors (in any memory format: the port keeps
activations NHWC in memory as channels_last views).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """torch ``MaxPool2d(window, stride, padding=1)`` for the ResNet stem
    (NCHW tensor, any memory format)."""
    return F.max_pool2d(x, window, stride, padding=1)


def max_pool_ceil(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """torch ``MaxPool2d(window, stride, padding, ceil_mode=True)``: the
    output side is ceil((H + 2p - k) / s) + 1. The JAX package pads the
    right and bottom with -inf up to that size instead; for stride <= window
    no window starts in that padding, so the two agree."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)


def avg_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """flax ``nn.avg_pool(x, (w, w), strides=(w, w))`` (VALID)."""
    return F.avg_pool2d(x, window, window)


def global_mean_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W: NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten an NCHW map in the JAX package's NHWC order (H, W, C), as its
    ``x.reshape((B, -1))`` does."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class ConvBNRelu(nn.Sequential):
    """Conv -> BN -> ReLU, children ``0`` and ``1`` (the reference's ``conv``
    helper, whose state-dict keys are ``conv{i}.0.*`` / ``conv{i}.1.*``)."""

    def __init__(self, inp: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True) -> None:
        super().__init__(nn.Conv2d(inp, features, kernel, stride, padding, bias=bias),
                         nn.BatchNorm2d(features), nn.ReLU())


def init_state_dict(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A seeded random ``state_dict`` with torchvision's init, drawn in
    ``state_dict`` order: conv weights Kaiming-normal (fan_out, ReLU), conv
    biases 0, Linear weight and bias uniform in ``+-1/sqrt(fan_in)``,
    BatchNorm weight 1 / bias 0 / running statistics 0 and 1."""
    linear = {name for name, m in module.named_modules() if isinstance(m, nn.Linear)}
    sd = {}
    for name, t in module.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        if leaf == "num_batches_tracked":
            sd[name] = torch.zeros_like(t)
        elif owner in linear:
            bound = 1.0 / math.sqrt(max(module.get_submodule(owner).in_features, 1))
            sd[name] = (torch.rand(t.shape, generator=generator) * 2 - 1) * bound
        elif t.dim() == 4:
            fan_out = t.shape[0] * t.shape[2] * t.shape[3]
            sd[name] = torch.randn(t.shape, generator=generator) * math.sqrt(2.0 / fan_out)
        elif leaf in ("weight", "running_var"):
            sd[name] = torch.ones_like(t)
        else:
            sd[name] = torch.zeros_like(t)
    return sd


class Classifier(nn.Module):
    """Base of the port's classifiers: ``forward`` takes NHWC [B, H, W, C]
    and returns [B, classes] logits; ``flax_paths()`` lists the JAX model's
    module paths (``"layer1_0/conv1"``: every module ``capture_intermediates``
    records) and ``torch_name(path)`` names the submodule that computes each
    one. ``optional_prefixes`` are the state-dict prefixes that may be
    missing from a checkpoint (train-only heads the JAX package has no
    parameters for)."""

    optional_prefixes: tuple = ()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_nchw(x.permute(0, 3, 1, 2))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def flax_paths(self) -> list:
        raise NotImplementedError

    def torch_name(self, path) -> str:
        raise NotImplementedError

    def init_state_dict(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        return init_state_dict(self, generator)


def fold_bn(w, gamma, beta, mean, var, eps=1e-5):
    """Fold inference BatchNorm into the preceding conv (output channels on
    the last axis, as in HWIO): returns f32 ``(w * s, beta - mean * s)`` with
    ``s = gamma / sqrt(var + eps)``."""
    w = np.asarray(w, np.float32)
    scale = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps
    )
    b = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * scale
    return (w * scale).astype(np.float32), b.astype(np.float32)


def parts_of(path) -> tuple:
    """A flax module path, ``"a/b"`` or ``("a", "b")``, as a tuple."""
    return tuple(path.split("/")) if isinstance(path, str) else tuple(path)


def split_index(segment: str) -> str:
    """A flax name that flattens torch Sequential indices with ``_``
    (``stage2_0``, ``layers_8_0``, ``branch2_3``) back to torch's dotted
    form (``stage2.0``, ``layers.8.0``, ``branch2.3``)."""
    m = re.match(r"^(.*?)((?:_\d+)+)$", segment)
    return segment if m is None or not m.group(1) else \
        m.group(1) + m.group(2).replace("_", ".")


def conv_side(size: int, kernel: int, stride: int = 1, padding: int = 0) -> int:
    """Output side of a conv or floor-mode pool."""
    return (size + 2 * padding - kernel) // stride + 1


def head_features(channels: int, side: int, input_size: int, what: str) -> int:
    """The flattened feature count ``channels * side^2`` a head reads; raises
    where the input is too small to leave a map (the JAX package's Dense
    then has a fan-in of 0, which its initializer divides by)."""
    if side <= 0:
        raise ValueError(f"a {input_size}x{input_size} input is too small for {what}: "
                         "no feature map is left at its head")
    return channels * side * side


def torch_name_by_index(path) -> str:
    """torch name of a flax path whose names flatten Sequential indices
    (GoogLeNet, MobileNetV2, ShuffleNetV2, MNASNet): each segment through
    :func:`split_index` (``features_3/conv_1/0`` -> ``features.3.conv.1.0``)."""
    return ".".join(split_index(p) for p in parts_of(path))


def transform_input(x: torch.Tensor) -> torch.Tensor:
    """torchvision's ``_transform_input`` of Inception-v3 and GoogLeNet (NCHW):
    ImageNet mean/std normalization -> the +-1 range their published weights
    were trained on."""
    return torch.cat([x[:, 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
                      x[:, 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
                      x[:, 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5], dim=1)


class BasicConv2d(nn.Module):
    """torchvision ``BasicConv2d`` of Inception-v3 and GoogLeNet: conv (no
    bias) -> BN (eps 1e-3) -> ReLU, children ``conv`` and ``bn``."""

    def __init__(self, inp: int, out: int, kernel, stride: int = 1, padding=0) -> None:
        super().__init__()
        self.conv = nn.Conv2d(inp, out, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(out, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))
