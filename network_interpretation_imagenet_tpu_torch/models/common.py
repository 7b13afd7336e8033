"""Shared model pieces (port of ``models/common.py`` of the JAX package):
pools with the JAX package's semantics, flax's training BatchNorm (on one
rank's rows of a global batch too), dropout and the draws of a train-mode
forward, ``ConvBNRelu``, the seeded random init every classifier shares,
and inference BatchNorm folding.

Every function here takes NCHW tensors (in any memory format: the port keeps
activations NHWC in memory as channels_last views).
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its state-dict keys, eval mode and momentum 0.1,
    which is flax's 0.9) whose training forward updates the running variance
    with the *biased* batch variance, as flax's ``BatchNorm`` does
    (``models/common.py:25`` of the JAX package); torch's uses the unbiased
    one, n / (n - 1) larger. The output is normalized by the batch
    statistics in both.

    Within :func:`global_batch_stats` the batch is one rank's rows of a
    global batch, and the statistics are the global batch's: ``reduce``
    sums ``[sum x, sum x^2, n]`` over the ranks (differentiably), and the
    variance is flax's ``E[x^2] - E[x]^2`` clipped at 0
    (``use_fast_variance``), reduced in at least f32."""

    reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        self.num_batches_tracked.add_(1)
        m = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        if self.reduce is not None:
            return self._global_forward(x, m)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_forward(self, x: torch.Tensor, m: float) -> torch.Tensor:
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        sums = self.reduce(torch.cat([xs.sum(dim=(0, 2, 3)), (xs * xs).sum(dim=(0, 2, 3)),
                                      xs.new_full((1,), x.numel() // c)]))
        mean = sums[:c] / sums[-1]
        var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1.0 - m).add_(var.detach(), alpha=m)
        scale = torch.rsqrt(var + self.eps) * self.weight
        return ((xs - mean[:, None, None]) * scale[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, reduce: Callable[[torch.Tensor], torch.Tensor]):
    """Within the block, every :class:`BatchNorm2d` of ``module`` in training
    mode normalizes by the statistics of the global batch whose rows the
    ranks hold: ``reduce(t)`` returns ``t`` summed over those ranks, with a
    backward that sums the gradients likewise (a differentiable all-reduce
    over the data axis). The JAX step is one program over the global batch,
    so its BatchNorm sees every row; a per-rank BatchNorm would not."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    for m in layers:
        m.reduce = reduce
    try:
        yield
    finally:
        for m in layers:
            m.reduce = None


class Draws:
    """The random draws of one train-mode forward: dropout's keep masks and
    stochastic depth's alive flags, each drawn as the JAX package draws it
    (``uniform < 1 - rate``, ``uniform >= death_rate``) from ``generator``
    (on the activations' device; torch's default generator where None),
    unless ``injected`` holds the decision under the drawing module's name
    (a test feeds the JAX package's draws in).

    ``rows=(index, count)`` marks a forward of one rank's rows, slice
    ``index`` of ``count`` equal slices of a global batch: a keep mask is
    drawn (or injected) at the global batch's shape and this rank's rows are
    taken, so that every rank, its generator seeded alike, draws the same
    numbers and stays in step with the others, as the JAX step's one draw
    over the global batch. The alive flags are 0-d and the same on every rank."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 injected: Optional[Mapping[str, torch.Tensor]] = None,
                 rows: Optional[Tuple[int, int]] = None) -> None:
        self.generator = generator
        self.injected = dict(injected or {})
        self.rows = rows

    def _uniform(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, device=device)

    def keep(self, name: str, shape, rate: float, device) -> torch.Tensor:
        """Dropout's bool keep mask of ``shape`` (this rank's rows)."""
        index, count = self.rows or (0, 1)
        n = int(shape[0])
        if name in self.injected:
            mask = self.injected[name].to(device=device, dtype=torch.bool)
        else:
            mask = self._uniform((n * count, *shape[1:]), device) < 1.0 - rate
        return mask[index * n:(index + 1) * n] if count > 1 else mask

    def alive(self, name: str, death_rate: float, device) -> torch.Tensor:
        """Stochastic depth's 0-d bool: the residual branch is added."""
        if name in self.injected:
            return torch.as_tensor(self.injected[name], dtype=torch.bool, device=device)
        return self._uniform((), device) >= death_rate


class Drawing(nn.Module):
    """A layer that draws in training mode; :func:`drawing` routes its draws."""

    draws: Optional[Draws] = None
    draw_name: str = ""

    def source(self) -> Draws:
        return self.draws if self.draws is not None else Draws()


@contextlib.contextmanager
def drawing(module: nn.Module, draws: Draws):
    """Within the block, every :class:`Drawing` layer of ``module`` draws from
    ``draws`` under its own module name (``classifier.0``, ``layer1.2``)."""
    layers = [(name, m) for name, m in module.named_modules() if isinstance(m, Drawing)]
    for name, m in layers:
        m.draws, m.draw_name = draws, name
    try:
        yield
    finally:
        for _, m in layers:
            m.draws = None


class Dropout(Drawing):
    """flax ``nn.Dropout`` (JAX ``models/alexnet.py:51-53``,
    ``squeezenet.py:82``, ``inception.py:224``, ``densenet.py:53``): in
    training mode each element is kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``, else zeroed; the identity in eval mode."""

    def __init__(self, rate: float = 0.5) -> None:
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = self.source().keep(self.draw_name, x.shape, self.rate, x.device)
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                    device=x.device))


class ConvBNRelu(nn.Sequential):
    """Conv -> BN -> ReLU, children ``0`` and ``1`` (the reference's ``conv``
    helper, whose state-dict keys are ``conv{i}.0.*`` / ``conv{i}.1.*``)."""

    def __init__(self, inp: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, bias: bool = True) -> None:
        super().__init__(nn.Conv2d(inp, features, kernel, stride, padding, bias=bias),
                         BatchNorm2d(features), nn.ReLU())


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
        self.bn = BatchNorm2d(out, eps=0.001)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))
