"""Model registry: ``create_model(arch, dataset, num_classes, dtype)``.

Port of ``models/__init__.py`` of the JAX package for the ImageNet ResNets
(18/34/50/101/152). The bundle carries the module (f32 parameters, torchvision keys)
and the compute dtype the engine defaults to; ``init(seed)`` makes a seeded
random ``state_dict``.

A bundle has two forwards over a ``state_dict`` (the port's ``variables``):
:meth:`ModelBundle.logits`, the plain eval-mode module through
``torch.func.functional_call`` (differentiable: the gradient methods and the
CAMs' captures run it), and ``SaliencyEngine.folded_logits``, the engine's
folded inference plan with B2 on the card (no gradient: every masked forward
runs it).
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

    def logits(self, variables, images: torch.Tensor) -> torch.Tensor:
        """Pure eval-mode forward of the plain module, NHWC [B, H, W, C] ->
        [B, num_classes] logits, differentiable in ``images`` (the JAX
        package's ``ModelBundle.logits(variables, images)``). ``variables``'
        tensors move to the images' device (no copy where they already are).
        f32, except on the card for a bf16 bundle: there it runs under bf16
        autocast, as the JAX CLIs' flax model computes in bf16 over f32
        parameters."""
        dev = images.device
        state = {k: v.to(dev) for k, v in variables.items()}
        self.module.eval()
        x = images.float()
        if dev.type == "cuda" and self.dtype == torch.bfloat16:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                return torch.func.functional_call(self.module, state, (x,))
        return torch.func.functional_call(self.module, state, (x,))


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
