"""ResNeXt (Xie, Girshick, Dollar, Tu, He 2017, "Aggregated Residual
Transformations for Deep Neural Networks", arXiv 1611.05431), with the
widths and key names of torchvision's ``resnext50_32x4d`` /
``resnext101_32x8d``, which the port's ``models/resnet_imagenet.py`` loads.
The config gives ``stage_sizes``, ``groups`` (the cardinality) and
``width_per_group`` (the channels of one group in the first stage).
Written from the paper's Table 1 and its Fig. 3(c), the form with one
grouped convolution:

- the stem: a 7x7/2 convolution with BatchNorm and ReLU, then a 3x3/2 max
  pool over a padding of 1;
- four stages of bottleneck blocks: a 1x1 reduction to the block's width,
  a grouped 3x3 (``groups`` groups of ``width / groups`` channels), a 1x1
  expansion to four times the stage's planes, each convolution bias-free
  with BatchNorm, ReLU after the first two and after the residual add; the
  first block of each stage projects the shortcut with a 1x1 convolution
  and BatchNorm. A block's width is ``planes * width_per_group / 64 *
  groups`` (torchvision's), so ResNeXt-101 32x8d's are 256, 512, 1,024,
  2,048 for planes 64, 128, 256, 512, equal to its blocks' outputs;
- the global mean and the head ``fc``.

Departure from the paper: torchvision's v1.5 layout puts a stage's stride
on the grouped 3x3, where the paper's Table 1 (after ResNet's) strides the
first 1x1; the port and torchvision's weights follow v1.5.

What every module of ``portbench/nets/`` gives, here for this family:
``state_shapes(cfg)``, ``HEAD``, ``residual_bn_keys(cfg)``, ``Plain`` and
``forward_flops(cfg)``; and, for the grouped convolutions alone, their
operations and bytes (``grouped_costs(cfg, batch)``) and their least time
on the card (``grouped_bound_ms(cfg, batch)``). The block layout and the
dense keys are the dense family's (``portbench/nets/bottleneck_resnet.py``).
It imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import torch
import torch.nn.functional as F

from portbench import costs, reference as ref
from portbench.nets import bottleneck_resnet

HEAD = bottleneck_resnet.HEAD   # the head's weight [classes, features] and bias


def block_specs(cfg: dict) -> List[Tuple[str, int, int, int, int, bool]]:
    """(prefix, inplanes, width, out, stride, downsample) of every block: the
    dense family's, whose width ``planes * base_width / 64`` is torchvision's
    ResNeXt width ``planes * width_per_group / 64 * groups`` at ``base_width
    = width_per_group * groups`` (``planes * width_per_group`` is a multiple
    of 64 in every published ResNeXt)."""
    return bottleneck_resnet.block_specs(cfg["stage_sizes"],
                                         cfg["width_per_group"] * cfg["groups"])


def state_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every tensor of the config's state dict under torchvision's key
    names, in its order: the dense family's, each block's ``conv2`` grouped,
    ``[width, width / groups, 3, 3]``."""
    shapes = bottleneck_resnet.state_shapes(
        dict(cfg, base_width=cfg["width_per_group"] * cfg["groups"]))
    for p, _, width, *_ in block_specs(cfg):
        shapes[f"{p}.conv2.weight"] = (width, width // cfg["groups"], 3, 3)
    return shapes


def residual_bn_keys(cfg: dict) -> Set[str]:
    """The scale of each block's last BatchNorm, ``bn3``, as in the dense
    ResNets."""
    return {f"{p}.bn3.weight" for p, *_ in block_specs(cfg)}


class Plain(ref.PlainNet):
    """The f32 forward: stem, max pool, the bottlenecks with their grouped
    3x3, mean, head."""

    def __init__(self, cfg: dict, state: Dict[str, torch.Tensor], quantize: str = "none"):
        super().__init__(cfg, state, quantize)
        self.specs = block_specs(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, groups = self.q, self.cfg["groups"]
        x = F.max_pool2d(torch.relu(self.conv_bn(x, "conv1", "bn1", 2, 3)), 3, 2, 1)
        for p, _, _, _, stride, ds in self.specs:
            y = torch.relu(self.conv_bn(x, f"{p}.conv1", f"{p}.bn1"))
            y = torch.relu(self.conv_bn(y, f"{p}.conv2", f"{p}.bn2", stride, 1, groups=groups))
            y = self.conv_bn(y, f"{p}.conv3", f"{p}.bn3")
            if ds:
                x = self.conv_bn(x, f"{p}.downsample.0", f"{p}.downsample.1", stride)
            x = q(torch.relu(y + x))
        return self.linear(q(x.mean(dim=(2, 3))), *HEAD)


def _sides(cfg: dict):
    """Per block, its spec with the side of its input and of its output."""
    h = costs.conv_out(costs.conv_out(cfg["resolution"], 7, 2, 3), 3, 2, 1)   # stem, max pool
    for spec in block_specs(cfg):
        ho = costs.conv_out(h, 3, spec[4], 1)
        yield spec, h, ho
        h = ho


def forward_flops(cfg: dict) -> float:
    """Multiply-add operations (2 per MAC) of one image's forward through the
    config's convolutions and head; BatchNorm, ReLU, pooling and residual
    adds are not counted."""
    h = costs.conv_out(cfg["resolution"], 7, 2, 3)
    flops = 2.0 * 64 * 3 * 49 * h * h              # stem
    for (_, cin, width, out, _, ds), hi, ho in _sides(cfg):
        flops += 2.0 * cin * width * hi * hi                            # 1x1 reduce
        flops += 2.0 * width * (width // cfg["groups"]) * 9 * ho * ho   # grouped 3x3
        flops += 2.0 * width * out * ho * ho                            # 1x1 expand
        if ds:
            flops += 2.0 * cin * out * ho * ho                          # projection
    return flops + 2.0 * out * cfg["num_classes"]


def grouped_costs(cfg: dict, batch: int) -> List[Tuple[float, float]]:
    """(operations, bytes) of each block's grouped 3x3 on ``batch`` images:
    2 operations per multiply-add; the input read once, the output written
    once, the folded weight and bias read once, all in the config's dtype
    (the port's folded plan keeps its biases in it too)."""
    item = costs.ITEMSIZE[cfg["dtype"]]
    out = []
    for (_, _, width, _, _, _), hi, ho in _sides(cfg):
        per_group = width // cfg["groups"]
        flops = 2.0 * batch * ho * ho * width * per_group * 9
        nbytes = item * (batch * hi * hi * width + batch * ho * ho * width
                         + width * per_group * 9 + width)
        out.append((flops, float(nbytes)))
    return out


def grouped_bound_ms(cfg: dict, batch: int) -> float:
    """The least time of one forward's grouped convolutions on the card at
    ``batch``: per convolution the larger of its operations at the peak of
    the config's dtype and its bytes at HBM's rate, summed."""
    peak = costs.PEAK_FLOPS[cfg["dtype"]]
    return sum(costs.chain_bound_ms(f, b, peak) for f, b in grouped_costs(cfg, batch))
