"""Model registry: ``create_model(arch, dataset, num_classes, dtype)``.

Port of ``models/__init__.py`` of the JAX package for the ImageNet ResNets
(18/34/50/101/152). The bundle carries the module (f32 parameters, torchvision keys)
and the compute dtype the engine defaults to; ``init(seed)`` makes a seeded
random ``state_dict``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from network_interpretation_imagenet_tpu_torch.config import DATASETS
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import (  # noqa: F401
    ARCHS,
    BasicBlock,
    Bottleneck,
    FoldedResNet,
    ResNet,
    create_resnet,
)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    module: ResNet
    input_size: int
    input_channels: int
    num_classes: int
    dtype: torch.dtype = torch.float32

    def init(self, seed: int) -> Dict[str, torch.Tensor]:
        """Seeded random weights (the module's own parameters stay as they are)."""
        return self.module.init_state_dict(torch.Generator().manual_seed(int(seed)))


def create_model(arch: str, dataset: str = "imagenet", num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32) -> ModelBundle:
    """``resnet18`` / ``34`` / ``50`` / ``101`` / ``152`` for ``dataset``'s input size."""
    spec = DATASETS[dataset]
    nc = num_classes if num_classes is not None else spec.num_classes
    if arch not in ARCHS:
        raise ValueError(f"unknown arch: {arch}")
    return ModelBundle(name=arch, module=create_resnet(arch, num_classes=nc),
                       input_size=spec.image_size, input_channels=spec.channels,
                       num_classes=nc, dtype=dtype)
