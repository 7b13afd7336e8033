"""Model registry: ``create_model(arch, dataset, ...)`` over every classifier
family of the JAX package's ``models/__init__.py``: the ImageNet ResNets
(18/34/50/101/152, ResNeXt-50 32x4d / 101 32x8d, Wide-ResNet-50-2 / 101-2),
the torchvision zoo (VGG-11/13/16/19 with and without BN, AlexNet,
SqueezeNet 1.0/1.1, DenseNet-121/169/201, Inception-v3, GoogLeNet,
MobileNetV2, ShuffleNetV2, MNASNet), the reference's CIFAR ResNet-6N+2
(``resnet`` + depth) and DenseNet-BC (``densenet`` + depth), and the MNIST
CNN. The bundle carries the module (f32 parameters, torchvision's or the
reference's keys) and the compute dtype the engine defaults to;
``init(seed)`` makes a seeded random ``state_dict``.

A bundle has two forwards over a ``state_dict`` (the port's ``variables``):
:meth:`ModelBundle.logits`, the plain eval-mode module through
``torch.func.functional_call`` (differentiable: the gradient methods and the
CAMs' captures run it), and the engine's inference plan
(:func:`inference_plan`; ``SaliencyEngine.folded_logits``), which every
masked forward runs: :class:`FoldedResNet` with B2 on the card for the
ImageNet ResNets, the eval-mode module in the compute dtype
(:class:`ModulePlan`) for every other arch, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from network_interpretation_imagenet_tpu_torch.config import DATASETS
from network_interpretation_imagenet_tpu_torch.models.densenet import (  # noqa: F401
    TV_CONFIGS,
    DenseLayer,
    DenseNet,
    create_densenet,
    create_densenet_torchvision,
)
from network_interpretation_imagenet_tpu_torch.models.mnist_cnn import MnistCNN  # noqa: F401
from network_interpretation_imagenet_tpu_torch.models.resnet_cifar import (  # noqa: F401
    ResNetCifar,
    death_rates_for,
)
from network_interpretation_imagenet_tpu_torch.models.resnet_imagenet import (  # noqa: F401
    ARCHS,
    BasicBlock,
    Bottleneck,
    FoldedResNet,
    ResNet,
    create_resnet,
)
from network_interpretation_imagenet_tpu_torch.models.shufflenet import STAGE_OUT
from network_interpretation_imagenet_tpu_torch.models.vgg import CFGS, create_vgg
from network_interpretation_imagenet_tpu_torch.ops.pool_nhwc import pool_nhwc
from network_interpretation_imagenet_tpu_torch.utils import logging as trace

# Every arch name create_model takes (the JAX package's names).
ALL_ARCHS = (ARCHS + tuple(CFGS) + tuple(f"{a}_bn" for a in CFGS)
             + ("alexnet", "squeezenet1_0", "squeezenet1_1", "inception_v3", "googlenet",
                "mobilenet_v2") + tuple(STAGE_OUT)
             + ("mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3", "mnist_cnn", "resnet")
             + tuple(TV_CONFIGS) + ("densenet",))


def load_weights(module: nn.Module, state_dict) -> nn.Module:
    """Load ``state_dict`` into ``module`` strictly, except that keys under
    the module's ``optional_prefixes`` (train-only heads) may be missing."""
    missing, unexpected = module.load_state_dict(state_dict, strict=False)
    optional = getattr(module, "optional_prefixes", ())
    missing = [k for k in missing if not k.startswith(optional)]
    if missing or unexpected:
        raise KeyError(f"state dict does not fit {type(module).__name__}: missing {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}, unexpected {unexpected[:5]}")
    return module


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    name: str
    module: nn.Module
    input_size: int
    input_channels: int
    num_classes: int
    dtype: torch.dtype = torch.float32
    # create_model's arguments (dataset, depth, ...), from which a serving
    # artifact rebuilds the module; None for a bundle built by hand.
    create_args: Optional[dict] = dataclasses.field(default=None, compare=False, hash=False)

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


class ModulePlan:
    """The inference plan of every arch but the ImageNet ResNets: a copy of
    the eval-mode module with ``state_dict`` loaded, every parameter and
    buffer in ``dtype`` on ``device`` (convolution weights channels_last, as
    the activations are). Calling it maps NHWC ``dtype`` images to f32
    logits. Its one hand-written kernel is Inception-v3's pools
    (``ops/pool_nhwc.py``), on the card; every other op is PyTorch's.

    A call is traced as span ``plan.forward`` (a child of the caller's
    span, with its request id), with attributes ``batch`` (the images) and,
    once the net has run, the rise over the call of two process-wide
    counters (``trace.counted_call``, so forwards that run at once in other
    threads add theirs): ``pool_launches`` (the pool kernel's launches,
    ``pool_nhwc.launches``: 13 for Inception-v3 on the card, 0 on the CPU)
    and ``concat_bytes`` (the bytes the dense layers' concatenations wrote,
    ``DenseLayer.concat_bytes``: 9,466,806,272 for DenseNet-201 at 256
    images of 224^2 in bf16, 0 for a net without dense layers)."""

    def __init__(self, module: nn.Module, state_dict, dtype: torch.dtype = torch.bfloat16,
                 device="cpu") -> None:
        self.dtype = dtype
        self.device = torch.device(device)
        net = load_weights(copy.deepcopy(module), state_dict).eval().requires_grad_(False)
        self.net = net.to(self.device, dtype).to(memory_format=torch.channels_last)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return trace.counted_call("plan.forward", _PLAN_COUNTERS, self._forward, x,
                                  batch=x.shape[0])

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x).float()


_PLAN_COUNTERS = {"pool_launches": lambda: pool_nhwc.launches,
                  "concat_bytes": lambda: DenseLayer.concat_bytes}


def inference_plan(bundle: ModelBundle, state_dict, dtype: torch.dtype, device):
    """The engine's plan: B2's folded net for an ImageNet ResNet, the module
    itself otherwise."""
    if isinstance(bundle.module, ResNet):
        return FoldedResNet(state_dict, bundle.module.stage_sizes, dtype, device)
    return ModulePlan(bundle.module, state_dict, dtype, device)


def create_model(arch: str, dataset: str = "imagenet", num_classes: Optional[int] = None,
                 dtype: torch.dtype = torch.float32, depth: Optional[int] = None,
                 death_mode: str = "none", death_rate: float = 0.5, growth_rate: int = 12,
                 bn_size: int = 4, compression: float = 0.5) -> ModelBundle:
    """Any arch of :data:`ALL_ARCHS` for ``dataset``'s input size and
    channels, with the JAX package's defaults: depth 56 for ``resnet`` and
    100 for ``densenet``, ``transform_input`` for ``inception_v3`` and
    ``googlenet``, and Inception-v3's native 299^2 input."""
    spec = DATASETS[dataset]
    nc = num_classes if num_classes is not None else spec.num_classes
    ch = spec.channels
    size = 299 if arch == "inception_v3" else spec.image_size
    if arch in ARCHS:
        module: nn.Module = create_resnet(arch, num_classes=nc, in_channels=ch)
    elif arch.startswith("vgg") and arch.removesuffix("_bn") in CFGS:
        module = create_vgg(arch, num_classes=nc, in_channels=ch, input_size=size)
    elif arch == "alexnet":
        from network_interpretation_imagenet_tpu_torch.models.alexnet import AlexNet

        module = AlexNet(num_classes=nc, in_channels=ch, input_size=size)
    elif arch in ("squeezenet1_0", "squeezenet1_1"):
        from network_interpretation_imagenet_tpu_torch.models.squeezenet import SqueezeNet

        module = SqueezeNet(arch[len("squeezenet"):], num_classes=nc, in_channels=ch)
    elif arch == "inception_v3":
        from network_interpretation_imagenet_tpu_torch.models.inception import InceptionV3

        module = InceptionV3(num_classes=nc, transform_input=True, in_channels=ch)
    elif arch == "googlenet":
        from network_interpretation_imagenet_tpu_torch.models.googlenet import GoogLeNet

        module = GoogLeNet(num_classes=nc, transform_input=True, in_channels=ch)
    elif arch == "mobilenet_v2":
        from network_interpretation_imagenet_tpu_torch.models.mobilenet import MobileNetV2

        module = MobileNetV2(num_classes=nc, in_channels=ch)
    elif arch in STAGE_OUT:
        from network_interpretation_imagenet_tpu_torch.models.shufflenet import ShuffleNetV2

        module = ShuffleNetV2(STAGE_OUT[arch], num_classes=nc, in_channels=ch)
    elif arch in ("mnasnet0_5", "mnasnet0_75", "mnasnet1_0", "mnasnet1_3"):
        from network_interpretation_imagenet_tpu_torch.models.mnasnet import MNASNet

        alpha = float(arch[len("mnasnet"):].replace("_", "."))
        module = MNASNet(alpha, num_classes=nc, in_channels=ch)
    elif arch == "mnist_cnn":
        module = MnistCNN(num_classes=nc, in_channels=ch)
    elif arch == "resnet":  # the reference's CIFAR ResNet-6N+2
        d = depth or 56
        module = ResNetCifar(d, num_classes=nc, in_channels=ch, input_size=size,
                             death_rates=death_rates_for(d, death_mode, death_rate))
    elif arch in TV_CONFIGS:
        module = create_densenet_torchvision(arch, num_classes=nc, in_channels=ch,
                                             input_size=size)
    elif arch == "densenet":  # the reference's DenseNet-BC
        module = create_densenet(data=dataset, depth=depth or 100, growth_rate=growth_rate,
                                 num_classes=nc, bn_size=bn_size, compression=compression,
                                 in_channels=ch, input_size=size)
    else:
        raise ValueError(f"unknown arch: {arch}")
    create_args = {"dataset": dataset, "depth": depth, "death_mode": death_mode,
                   "death_rate": death_rate, "growth_rate": growth_rate, "bn_size": bn_size,
                   "compression": compression}
    return ModelBundle(name=arch, module=module, input_size=size, input_channels=ch,
                       num_classes=nc, dtype=dtype, create_args=create_args)
