"""Running-statistics meters (port of ``utils/meters.py``): ``AverageMeter``,
the meter the reference duplicates in five files
(``bayesian_active_learning_imagenet.py:98-113`` et al.), and the
gradient / update checker ``WeightsCheck``."""

from __future__ import annotations

from torch import nn


class AverageMeter:
    """Tracks current value, running sum, count and average."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class WeightsCheck:
    """Warns when a conv-like parameter (``min_ndim`` or more axes) has no or
    an all-zero gradient, or has not changed since the last check (port of
    ``utils/meters.py:WeightsCheck``, the reference's ``utils.WeightsCheck``,
    ``utils.py:69-87``). Reads a module's parameters and their ``.grad``."""

    def __init__(self, module: nn.Module, min_ndim: int = 4) -> None:
        self.min_ndim = min_ndim
        self.means = {name: float(p.detach().float().mean()) for name, p in self._iter(module)}

    def _iter(self, module: nn.Module):
        for name, p in module.named_parameters():
            if p.dim() >= self.min_ndim:
                yield name, p

    def check(self, module: nn.Module, grads: bool = True) -> list:
        """Warning strings (none: healthy). ``grads=False`` skips the gradient
        check (a module checked between steps, its ``.grad`` cleared)."""
        warnings = []
        if grads:
            for name, p in self._iter(module):
                if p.grad is None or float(p.grad.abs().max()) == 0.0:
                    warnings.append(f"param {name} has zero grad")
        for name, p in self._iter(module):
            mean = float(p.detach().float().mean())
            if name in self.means and mean == self.means[name]:
                warnings.append(f"param {name} has not been updated")
            self.means[name] = mean
        return warnings
