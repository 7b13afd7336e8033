"""torchvision's Bottleneck ResNet (v1.5: stride on the 3x3), the family of
a config that names no ``net``: ResNet-50/101/152 and the Wide-ResNets by
the config's ``stage_sizes`` and ``base_width``, under torchvision's key
names (the port's ``models/resnet_imagenet.py`` loads them).

What every module of ``portbench/nets/`` gives, here for this family:
``state_shapes(cfg)``, ``HEAD``, ``residual_bn_keys(cfg)``, ``Plain`` and
``forward_flops(cfg)``. It imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Sequence, Set, Tuple

import torch
import torch.nn.functional as F

from portbench import costs, reference as ref

HEAD = ("fc.weight", "fc.bias")   # the head's weight [classes, features] and bias


def block_specs(stage_sizes: Sequence[int], base_width: int) -> List[Tuple[str, int, int, int, int, bool]]:
    """(prefix, inplanes, width, out, stride, downsample) of every block."""
    specs, inplanes = [], 64
    for s, n in enumerate(stage_sizes):
        planes = 64 * 2 ** s
        width, out = int(planes * (base_width / 64.0)), planes * 4
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            specs.append((f"layer{s + 1}.{b}", inplanes, width, out, stride,
                          stride != 1 or inplanes != out))
            inplanes = out
    return specs


def state_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every tensor of the config's state dict under torchvision's key
    names, in the order of the one draw of ``reference.make_weights``."""
    shapes: Dict[str, tuple] = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{k}"] = (c,)

    bn("bn1", 64)
    for p, cin, width, out, _, ds in block_specs(cfg["stage_sizes"], cfg["base_width"]):
        shapes[f"{p}.conv1.weight"] = (width, cin, 1, 1)
        bn(f"{p}.bn1", width)
        shapes[f"{p}.conv2.weight"] = (width, width, 3, 3)
        bn(f"{p}.bn2", width)
        shapes[f"{p}.conv3.weight"] = (out, width, 1, 1)
        bn(f"{p}.bn3", out)
        if ds:
            shapes[f"{p}.downsample.0.weight"] = (out, cin, 1, 1)
            bn(f"{p}.downsample.1", out)
    final = block_specs(cfg["stage_sizes"], cfg["base_width"])[-1][3]
    shapes[HEAD[0]] = (cfg["num_classes"], final)
    shapes[HEAD[1]] = (cfg["num_classes"],)
    return shapes


def residual_bn_keys(cfg: dict) -> Set[str]:
    """The scale of each block's last BatchNorm, ``bn3``."""
    return {f"{p}.bn3.weight" for p, *_ in block_specs(cfg["stage_sizes"], cfg["base_width"])}


class Plain(ref.PlainNet):
    """The f32 forward: stem, max-pool, the bottlenecks, mean, head."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quantize: str = "none"):
        super().__init__(cfg, state, quantize)
        self.specs = block_specs(cfg["stage_sizes"], cfg["base_width"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.q
        x = F.max_pool2d(torch.relu(self.conv_bn(x, "conv1", "bn1", 2, 3)), 3, 2, 1)
        for p, _, _, _, stride, ds in self.specs:
            y = torch.relu(self.conv_bn(x, f"{p}.conv1", f"{p}.bn1"))
            y = torch.relu(self.conv_bn(y, f"{p}.conv2", f"{p}.bn2", stride, 1))
            y = self.conv_bn(y, f"{p}.conv3", f"{p}.bn3")
            if ds:
                x = self.conv_bn(x, f"{p}.downsample.0", f"{p}.downsample.1", stride)
            x = q(torch.relu(y + x))
        return self.linear(q(x.mean(dim=(2, 3))), *HEAD)


def forward_flops(cfg: dict) -> float:
    """Multiply-add operations (2 per MAC) of one image's forward through the
    config's convolutions and head; BatchNorm, ReLU, pooling and residual adds
    are not counted."""
    size = cfg["resolution"]
    h = costs.conv_out(size, 7, 2, 3)
    flops = 2.0 * 64 * 3 * 49 * h * h              # stem
    h = costs.conv_out(h, 3, 2, 1)                # max-pool
    inplanes = 64
    for s, n in enumerate(cfg["stage_sizes"]):
        planes = 64 * 2 ** s
        width, out = int(planes * cfg["base_width"] / 64.0), planes * 4
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            ho = costs.conv_out(h, 3, stride, 1)
            flops += 2.0 * inplanes * width * h * h        # 1x1 reduce
            flops += 2.0 * width * width * 9 * ho * ho    # 3x3
            flops += 2.0 * width * out * ho * ho           # 1x1 expand
            if stride != 1 or inplanes != out:
                flops += 2.0 * inplanes * out * ho * ho    # projection
            h, inplanes = ho, out
    return flops + 2.0 * inplanes * cfg["num_classes"]
