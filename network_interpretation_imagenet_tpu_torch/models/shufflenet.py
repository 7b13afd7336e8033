"""ShuffleNetV2 x0.5 / x1.0 / x1.5 / x2.0 (port of ``models/shufflenet.py``
of the JAX package) with torchvision's state-dict keys (``conv1.{0,1}``,
``stage{2,3,4}.{b}.branch{1,2}.{i}``, ``conv5.{0,1}``, ``fc``). A unit of
stride 2 runs both branches on its input; a unit of stride 1 splits the
channels in halves and runs ``branch2`` on the second; both then shuffle
the concatenation's channels in two groups.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    global_mean_pool,
    torch_name_by_index,
)

STAGE_OUT = {
    "shufflenet_v2_x0_5": (24, 48, 96, 192, 1024),
    "shufflenet_v2_x1_0": (24, 116, 232, 464, 1024),
    "shufflenet_v2_x1_5": (24, 176, 352, 704, 1024),
    "shufflenet_v2_x2_0": (24, 244, 488, 976, 2048),
}
REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.reshape(b, groups, c // groups, h, w).transpose(1, 2).reshape(b, c, h, w)


def _dw(c: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(c, c, 3, stride, 1, groups=c, bias=False)


class InvertedResidual(nn.Module):
    def __init__(self, inp: int, oup: int, stride: int) -> None:
        super().__init__()
        bf = oup // 2
        self.stride = stride
        if stride > 1:
            self.branch1 = nn.Sequential(_dw(inp, stride), nn.BatchNorm2d(inp),
                                         nn.Conv2d(inp, bf, 1, bias=False), nn.BatchNorm2d(bf),
                                         nn.ReLU())
        else:
            self.branch1 = nn.Sequential()
        self.branch2 = nn.Sequential(
            nn.Conv2d(inp if stride > 1 else bf, bf, 1, bias=False), nn.BatchNorm2d(bf),
            nn.ReLU(), _dw(bf, stride), nn.BatchNorm2d(bf), nn.Conv2d(bf, bf, 1, bias=False),
            nn.BatchNorm2d(bf), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], dim=1)
        else:
            out = torch.cat([self.branch1(x), self.branch2(x)], dim=1)
        return channel_shuffle(out, 2)


class ShuffleNetV2(Classifier):
    def __init__(self, stage_out=STAGE_OUT["shufflenet_v2_x1_0"], num_classes: int = 1000,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.conv1 = nn.Sequential(nn.Conv2d(in_channels, stage_out[0], 3, 2, 1, bias=False),
                                   nn.BatchNorm2d(stage_out[0]), nn.ReLU())
        c_in = stage_out[0]
        for si, (repeats, c_out) in enumerate(zip(REPEATS, stage_out[1:4]), start=2):
            units = []
            for b in range(repeats):
                units.append(InvertedResidual(c_in, c_out, 2 if b == 0 else 1))
                c_in = c_out
            setattr(self, f"stage{si}", nn.Sequential(*units))
        self.conv5 = nn.Sequential(nn.Conv2d(c_in, stage_out[4], 1, bias=False),
                                   nn.BatchNorm2d(stage_out[4]), nn.ReLU())
        self.fc = nn.Linear(stage_out[4], num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x = F.max_pool2d(self.conv1(x), 3, 2, 1)
        x = self.stage4(self.stage3(self.stage2(x)))
        return self.fc(global_mean_pool(self.conv5(x)))

    def flax_paths(self) -> list:
        paths = ["conv1_0", "conv1_1"]
        for si in (2, 3, 4):
            for b, unit in enumerate(getattr(self, f"stage{si}")):
                p = f"stage{si}_{b}"
                paths.append(p)
                if unit.stride > 1:
                    paths += [f"{p}/branch1_{i}" for i in (0, 1, 2, 3)]
                paths += [f"{p}/branch2_{i}" for i in (0, 1, 3, 4, 5, 6)]
        return paths + ["conv5_0", "conv5_1", "fc"]

    def torch_name(self, path) -> str:
        return torch_name_by_index(path)
