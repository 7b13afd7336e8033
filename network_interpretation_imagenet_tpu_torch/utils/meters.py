"""Running-statistics meter (port of ``utils/meters.py``'s ``AverageMeter``:
the meter the reference duplicates in five files,
``bayesian_active_learning_imagenet.py:98-113`` et al.)."""

from __future__ import annotations


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
