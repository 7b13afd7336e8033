"""ImageNet ResNets: BasicBlock (ResNet-18/34) and Bottleneck (ResNet-50/101/152,
ResNeXt-50 32x4d / 101 32x8d, Wide-ResNet-50-2 / 101-2).

Port of ``models/resnet_imagenet.py`` of the JAX package: torchvision's v1.5
architecture (post-activation, stride on the 3x3) with torchvision's
``state_dict`` key names and its ``groups`` / ``width_per_group`` arguments.
:class:`ResNet` holds the parameters and its
``forward`` is the plain eval-mode network. :class:`FoldedResNet` is the
inference plan the engine runs: BatchNorm folded into every convolution once
when it is built, activations kept NHWC in memory (channels_last). In a
Bottleneck net the stem and the first (projection) block of each stage are
eager blocks, and each stage's remaining stride-1 identity blocks are one
``bottleneck_chain`` call (a Wide-ResNet's too: its chains have P = 2*planes
and C = 2*P). A BasicBlock net has no bottleneck, and no TPU kernel covers
its blocks either: all of them are eager. Neither does a ResNeXt net's
grouped 3x3 fit B2's dense GEMM (nor the TPU kernel's), so all of its
blocks are eager too, the 3x3 a grouped convolution. On the card an eager
block runs each convolution in cuDNN without a bias, then its bias, the
residual (after the block's last convolution) and ReLU as one in-place
pass, E1 (``ops/epilogue_nhwc.py``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    BatchNorm2d,
    Classifier,
    fold_bn,
    max_pool_same,
    parts_of,
)
from network_interpretation_imagenet_tpu_torch.ops.bottleneck_chain import (
    bottleneck_chain,
    bottleneck_chain_plain,
)
from network_interpretation_imagenet_tpu_torch.ops.epilogue_nhwc import (
    epilogue_nhwc,
    epilogue_nhwc_plain,
)
from network_interpretation_imagenet_tpu_torch.utils import logging as trace


_RENAME = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}


def torch_name(path) -> str:
    """A flax module path of a ResNet (ImageNet or CIFAR) -> its torch name:
    ``layer{s}_{b}`` -> ``layer{s}.{b}``, ``downsample_conv`` /
    ``downsample_bn`` -> ``downsample.0`` / ``downsample.1``."""
    return ".".join(p.replace("_", ".") if p.startswith("layer") and "_" in p
                    else _RENAME.get(p, p) for p in parts_of(path))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, planes, 1, stride, bias=False),
                          BatchNorm2d(planes))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1, base_width: int = 64) -> None:
        super().__init__()
        out = planes * self.expansion
        # torchvision: width = planes * base_width / 64 * groups
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = (
            nn.Sequential(nn.Conv2d(inplanes, out, 1, stride, bias=False),
                          BatchNorm2d(out))
            if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + identity)


class ResNet(Classifier):
    """torchvision-compatible ResNet over ``block`` (:class:`BasicBlock` or
    :class:`Bottleneck`, the latter with ``groups`` and ``base_width``);
    ``forward`` takes NHWC."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 block: type = Bottleneck, groups: int = 1, base_width: int = 64,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.stage_sizes = tuple(int(n) for n in stage_sizes)
        bkw = dict(groups=groups, base_width=base_width) if block is Bottleneck else {}
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64)
        inplanes = 64
        for stage, num_blocks in enumerate(self.stage_sizes):
            planes = 64 * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                ds = stride != 1 or inplanes != planes * block.expansion
                blocks.append(block(inplanes, planes, stride, ds, **bkw))
                inplanes = planes * block.expansion
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

    def flax_paths(self) -> list:
        """``conv1``, ``bn1``, ``layer1_0``, ``layer1_0/conv1``, ...,
        ``layer1_0/downsample_bn``, ..., ``fc``."""
        paths = ["conv1", "bn1"]
        for s, n in enumerate(self.stage_sizes, start=1):
            for b in range(n):
                block = getattr(self, f"layer{s}")[b]
                p = f"layer{s}_{b}"
                paths.append(p)
                for c in range(1, (3 if isinstance(block, Bottleneck) else 2) + 1):
                    paths += [f"{p}/conv{c}", f"{p}/bn{c}"]
                if block.downsample is not None:
                    paths += [f"{p}/downsample_conv", f"{p}/downsample_bn"]
        return paths + ["fc"]

    def torch_name(self, path) -> str:
        return torch_name(path)


# Stage sizes of the Bottleneck nets (whose dense stages B2 runs) and of the BasicBlock nets.
_CONFIGS = {
    "resnet50": (3, 4, 6, 3),
    "resnet101": (3, 4, 23, 3),
    "resnet152": (3, 8, 36, 3),
    # grouped / wide variants (torchvision resnet.py factory arguments)
    "resnext50_32x4d": (3, 4, 6, 3),
    "resnext101_32x8d": (3, 4, 23, 3),
    "wide_resnet50_2": (3, 4, 6, 3),
    "wide_resnet101_2": (3, 4, 23, 3),
}
_BASIC_CONFIGS = {
    "resnet18": (2, 2, 2, 2),
    "resnet34": (3, 4, 6, 3),
}
# (groups, base_width) per arch; default (1, 64).
_GROUPS = {
    "resnext50_32x4d": (32, 4),
    "resnext101_32x8d": (32, 8),
    "wide_resnet50_2": (1, 128),
    "wide_resnet101_2": (1, 128),
}
ARCHS = tuple(_BASIC_CONFIGS) + tuple(_CONFIGS)


def create_resnet(arch: str, num_classes: int = 1000, in_channels: int = 3) -> ResNet:
    if arch in _BASIC_CONFIGS:
        return ResNet(_BASIC_CONFIGS[arch], num_classes=num_classes, block=BasicBlock,
                      in_channels=in_channels)
    groups, base_width = _GROUPS.get(arch, (1, 64))
    return ResNet(_CONFIGS[arch], num_classes=num_classes, groups=groups, base_width=base_width,
                  in_channels=in_channels)


def _array(t) -> np.ndarray:
    return t.detach().cpu().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class FoldedResNet:
    """The inference plan of a ResNet, built once from a ``state_dict``:
    BatchNorm folded (``fold_bn``) and every weight cast to ``dtype`` on
    ``device``. The block type follows the keys: a net without ``conv3`` is a
    BasicBlock net, and one whose 3x3 weight has fewer input channels than
    output channels is grouped (ResNeXt); both run every block eagerly.
    An eager convolution keeps its bias apart from its weight, in f32. On
    the card it runs without one, and E1 then adds the bias (and, after a
    block's last convolution, the residual) and applies ReLU in one pass.
    There a projection runs bias-free too: its bias is added to its block's
    last bias when the plan is built, and no pass follows it. On the CPU the
    library adds a bias inside the convolution, before its one rounding, so
    there every convolution takes its own bias in ``dtype``, and torch ops
    add the residual and apply ReLU. Calling it maps NHWC ``dtype`` images
    to f32 logits; ``plain=True`` runs the chains and the epilogues through
    their plain versions, on any device (the comparison the card makes).

    A call is traced as span ``plan.forward`` (a child of the caller's
    span, with its request id), as ``ModulePlan``'s is, with attributes
    ``batch`` (the images) and, once the net has run, the rise over the
    call of two process-wide counters (``trace.counted_call``, so forwards
    that run at once in other threads add theirs): ``grouped_convs`` (the
    grouped convolutions launched, ``FoldedResNet.grouped_launches``, which
    ``_conv`` raises: 33 for ResNeXt-101, 0 for a dense net) and
    ``epilogues`` (E1's launches, ``epilogue_nhwc.launches``: 100 for
    ResNeXt-101 and 13 for ResNet-101 on the card, 0 on the CPU)."""

    grouped_launches = 0

    def __init__(self, state_dict, stage_sizes: Sequence[int],
                 dtype: torch.dtype = torch.bfloat16, device="cpu") -> None:
        self.dtype = dtype
        self.device = torch.device(device)

        def folded(conv: str, bn: str):
            w = np.transpose(_array(state_dict[conv + ".weight"]), (2, 3, 1, 0))  # HWIO
            return fold_bn(w, *(_array(state_dict[f"{bn}.{k}"])
                                 for k in ("weight", "bias", "running_mean", "running_var")))

        def matrix(w: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(w)).to(self.device, dtype)

        def bias(b: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(b).to(self.device, torch.float32)

        def torch_conv(conv: str, bn: str, stride: int, padding: int):
            """(OIHW weight, f32 bias, stride, padding, groups) of an eager
            convolution."""
            w, b = folded(conv, bn)
            w = torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
            # A block's 3x3 keeps its width, so its OIHW weight is [w, w / groups].
            groups = int(w.shape[0]) // int(w.shape[1]) if conv.endswith("conv2") else 1
            return (w.to(self.device, dtype).contiguous(memory_format=torch.channels_last),
                    bias(b), stride, padding, groups)

        basic = "layer1.0.conv3.weight" not in state_dict
        first_3x3 = state_dict["layer1.0.conv2.weight"].shape
        grouped = not basic and int(first_3x3[1]) != int(first_3x3[0])

        def torch_block(p: str, stride: int):
            """(convs, projection, last bias) of eager block ``p``: the
            projection None for an identity block; the last bias, f32, the
            last convolution's plus the projection's."""
            if basic:
                convs = (torch_conv(f"{p}.conv1", f"{p}.bn1", stride, 1),
                         torch_conv(f"{p}.conv2", f"{p}.bn2", 1, 1))
            else:
                convs = (torch_conv(f"{p}.conv1", f"{p}.bn1", 1, 0),
                         torch_conv(f"{p}.conv2", f"{p}.bn2", stride, 1),
                         torch_conv(f"{p}.conv3", f"{p}.bn3", 1, 0))
            if f"{p}.downsample.0.weight" not in state_dict:
                return convs, None, convs[-1][1]
            ds = torch_conv(f"{p}.downsample.0", f"{p}.downsample.1", stride, 0)
            return convs, ds, convs[-1][1] + ds[1]

        self.stem = torch_conv("conv1", "bn1", 2, 3)
        # Per stage: the eager blocks (all of a BasicBlock or a ResNeXt
        # net's, the first of a dense Bottleneck net's), then the B2 chain of
        # the rest.
        self.stages = []
        for s, num_blocks in enumerate(stage_sizes, start=1):
            stride = 1 if s == 1 else 2
            n_torch = num_blocks if basic or grouped else 1
            blocks = [torch_block(f"layer{s}.{b}", stride if b == 0 else 1)
                      for b in range(n_torch)]
            chain = []
            for b in range(n_torch, num_blocks):
                q = f"layer{s}.{b}"
                w1, b1 = folded(f"{q}.conv1", f"{q}.bn1")
                w3, b3 = folded(f"{q}.conv2", f"{q}.bn2")
                w2, b2 = folded(f"{q}.conv3", f"{q}.bn3")
                chain += [matrix(w1[0, 0]), bias(b1), matrix(w3), bias(b3),
                          matrix(w2[0, 0]), bias(b2)]
            self.stages.append((blocks, chain))
        self.fc_w = torch.from_numpy(_array(state_dict["fc.weight"]).T.copy()).to(self.device)
        self.fc_b = torch.from_numpy(_array(state_dict["fc.bias"])).to(self.device)

    @staticmethod
    def _conv(x, op, epilogue, residual=None, bias=None):
        """Convolution ``op`` of ``x``, then its bias (``bias`` where given,
        else its own), ``residual`` where given, and ReLU: through
        ``epilogue``, in one pass in place on the bias-free output, or, with
        ``epilogue`` None (the CPU's route), by the convolution itself in
        ``x``'s dtype and then torch ops."""
        w, b, stride, padding, groups = op
        fused = epilogue is None
        y = F.conv2d(x, w, b.to(x.dtype) if fused else None, stride, padding, groups=groups)
        if groups > 1:
            FoldedResNet.grouped_launches += 1
        if fused:
            return torch.relu(y if residual is None else y + residual)
        return epilogue(y, b if bias is None else bias, residual)

    @staticmethod
    def _block(y, block, epilogue):
        """Eager block ``(convs, projection, last bias)`` on ``y``; the last
        convolution's epilogue adds the identity or the projection, which
        takes its bias inside the convolution on the CPU's route and none on
        an epilogue's (the last bias holds it)."""
        convs, ds, last_bias = block
        out = y
        for op in convs[:-1]:
            out = FoldedResNet._conv(out, op, epilogue)
        identity = y
        if ds is not None:
            w, b, stride, padding, _ = ds
            identity = F.conv2d(y, w, b.to(y.dtype) if epilogue is None else None, stride, padding)
        return FoldedResNet._conv(out, convs[-1], epilogue, identity, last_bias)

    @staticmethod
    def _epilogue(device: torch.device, plain: bool):
        """The epilogue route of a forward on ``device``: the plain twin for
        ``plain``, None (the convolutions' own bias) on the CPU, else E1."""
        if plain:
            return epilogue_nhwc_plain
        return None if device.type == "cpu" else epilogue_nhwc

    def __call__(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        return trace.counted_call("plan.forward", _FOLDED_COUNTERS, self._forward, x, plain,
                                  batch=x.shape[0])

    def _forward(self, x: torch.Tensor, plain: bool) -> torch.Tensor:
        chain_fn = bottleneck_chain_plain if plain else bottleneck_chain
        epilogue = self._epilogue(x.device, plain)
        y = x.permute(0, 3, 1, 2)  # NHWC memory, NCHW view: channels_last
        y = max_pool_same(self._conv(y, self.stem, epilogue), 3, 2)
        for blocks, chain in self.stages:
            for block in blocks:
                y = self._block(y, block, epilogue)
            if chain:
                if not y.is_contiguous(memory_format=torch.channels_last):
                    raise RuntimeError("activations left channels_last before a chain")
                y = chain_fn(y.permute(0, 2, 3, 1), chain).permute(0, 3, 1, 2)
        return torch.matmul(y.float().mean(dim=(2, 3)), self.fc_w) + self.fc_b


_FOLDED_COUNTERS = {"grouped_convs": lambda: FoldedResNet.grouped_launches,
                    "epilogues": lambda: epilogue_nhwc.launches}
