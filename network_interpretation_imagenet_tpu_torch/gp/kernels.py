"""GP kernels (port of ``gp/kernels.py`` of the JAX package).

``k(a, b) = s² · exp(-½ ‖a-b‖²/ℓ²)``, the sklearn/gpytorch convention, plus
the 1-D gram matrix of a coordinate vector and the Jaccard-distance RBF over
mask keep-areas. Every function takes leading batch dimensions where its
docstring says so, and computes its matrix products in full f32
(:func:`full_f32`), whatever the process-wide TF32 setting is.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def full_f32():
    """f32 matrix products in full f32 on the card while the block runs
    (cuBLAS otherwise may take TF32 when the process allows it). The JAX
    package pins HIGHEST precision here for the same reason: a TF32 gram
    matrix loses positive-definiteness and NaNs the Cholesky downstream."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def full_f32_fn(fn):
    """Decorator form of :func:`full_f32`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with full_f32():
            return fn(*args, **kwargs)

    return wrapper


@full_f32_fn
def sq_dists(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances [..., N, M] between [..., N, D] and [..., M, D]."""
    a = torch.sum(x1 * x1, dim=-1)[..., :, None]
    b = torch.sum(x2 * x2, dim=-1)[..., None, :]
    cross = torch.matmul(x1, x2.transpose(-1, -2))
    return torch.clamp(a + b - 2.0 * cross, min=0.0)


def rbf_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscale, outputscale=1.0) -> torch.Tensor:
    """Squared-exponential kernel; a ``lengthscale`` of shape [L, 1, 1]
    gives L gram matrices at once."""
    d2 = sq_dists(x1 / lengthscale, x2 / lengthscale)
    return outputscale * torch.exp(-0.5 * d2)


def rbf_kernel_1d(grid: torch.Tensor, lengthscale, outputscale=1.0) -> torch.Tensor:
    """RBF gram matrix of a 1-D coordinate vector (one factor of a separable
    2-D RBF on a grid)."""
    d = grid[:, None] - grid[None, :]
    return outputscale * torch.exp(-0.5 * (d / lengthscale) ** 2)


@full_f32_fn
def jaccard_rbf_kernel(masks1: torch.Tensor, masks2: torch.Tensor, lengthscale,
                       outputscale=1.0) -> torch.Tensor:
    """RBF with the Jaccard distance between mask keep-areas in place of the
    Euclidean one. ``masks1`` bool[N, H, W], ``masks2`` bool[M, H, W]."""
    f1 = masks1.reshape(masks1.shape[0], -1).float()
    f2 = masks2.reshape(masks2.shape[0], -1).float()
    inter = f1 @ f2.T
    area1 = torch.sum(f1, dim=1)[:, None]
    area2 = torch.sum(f2, dim=1)[None, :]
    union = area1 + area2 - inter
    jaccard_dist = 1.0 - inter / torch.clamp(union, min=1.0)
    return outputscale * torch.exp(-0.5 * jaccard_dist / (lengthscale ** 2))
