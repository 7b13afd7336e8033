"""The MNIST CNN (port of ``models/mnist_cnn.py`` of the JAX package): the
reference's ``Classification_Net``, six 3x3 convs (strides 1, 1, 2, 1, 2, 1;
the first five Conv -> BN -> ReLU, the sixth a bare conv), a global mean
pool and one dense head. The state-dict keys are the reference's
(``conv{1..5}.{0,1}.*``, ``conv6.*``, ``fc1.*``), so its checkpoint loads as
it is. The JAX module also returns the three feature maps; the logits are
what every caller reads, and all that ``forward`` returns here.
"""

from __future__ import annotations

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.models.common import (
    Classifier,
    ConvBNRelu,
    global_mean_pool,
    parts_of,
)

_FLAX_CHILD = {"Conv_0": "0", "BatchNorm_0": "1"}


def torch_name(path) -> str:
    """``conv1/Conv_0`` -> ``conv1.0``, ``conv1/BatchNorm_0`` -> ``conv1.1``."""
    return ".".join(_FLAX_CHILD.get(p, p) for p in parts_of(path))


class MnistCNN(Classifier):
    def __init__(self, num_classes: int = 10, in_channels: int = 1) -> None:
        super().__init__()
        widths = (32, 32, 64, 64, 128)
        strides = (1, 1, 2, 1, 2)
        inp = in_channels
        for i, (w, s) in enumerate(zip(widths, strides), start=1):
            setattr(self, f"conv{i}", ConvBNRelu(inp, w, stride=s))
            inp = w
        self.conv6 = nn.Conv2d(128, 128, 3, padding=1)
        self.fc1 = nn.Linear(128, num_classes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 6):
            x = getattr(self, f"conv{i}")(x)
        return self.fc1(global_mean_pool(self.conv6(x)))

    def flax_paths(self) -> list:
        paths = []
        for i in range(1, 6):
            paths += [f"conv{i}", f"conv{i}/Conv_0", f"conv{i}/BatchNorm_0"]
        return paths + ["conv6", "fc1"]

    def torch_name(self, path) -> str:
        return torch_name(path)
