"""Shared model pieces: the stem max-pool and inference BatchNorm folding."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """torch ``MaxPool2d(window, stride, padding=1)`` for the ResNet stem
    (NCHW tensor, any memory format)."""
    return F.max_pool2d(x, window, stride, padding=1)


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
