"""Exact GP regression (port of ``gp/exact.py`` of the JAX package).

The BO surrogate: sklearn-compatible semantics (``normalize_y``, noise
``alpha`` on the diagonal), with sklearn's restart-based hyperparameter
search replaced by a marginal-likelihood sweep over a lengthscale grid, one
batched Cholesky over ``[L, N, N]``. The fused BO loop instead carries the
inverse Cholesky factor per lengthscale and borders it once per observation
(``incremental_*``): a few batched matvecs, no linear-algebra solver.

Every function computes in true f32 (``kernels.full_f32``), as the JAX
package pins HIGHEST precision: the near-singular large-lengthscale regime
(K ≈ all-ones + 1e-5·I) depends on it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from network_interpretation_imagenet_tpu_torch.gp.kernels import full_f32_fn, rbf_kernel

_LOG_2PI = math.log(2.0 * math.pi)


class GPParams(NamedTuple):
    lengthscale: torch.Tensor   # scalar, or [L, 1, 1] for a batch of L fits
    outputscale: torch.Tensor   # scalar (signal variance)
    noise: torch.Tensor         # scalar or [N] observation noise variance


class GPFit(NamedTuple):
    """Posterior state after conditioning on (x, y)."""

    params: GPParams
    x: torch.Tensor        # [N, D]
    chol: torch.Tensor     # [N, N] lower Cholesky factor of K + noise·I
    alpha: torch.Tensor    # [N] (K + noise·I)^-1 (y - y_mean) / y_std
    y_mean: torch.Tensor   # scalar normalization (sklearn normalize_y)
    y_std: torch.Tensor


def nanargmax(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """First index of the largest non-NaN value (``jnp.nanargmax``)."""
    return torch.argmax(torch.where(torch.isnan(v), -torch.inf, v), dim=dim)


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where K is not positive definite (as
    ``jnp.linalg.cholesky`` gives it). ``cholesky_ex`` does not wait for the
    device to report the failure."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where((info > 0)[..., None, None], torch.nan, chol)


@full_f32_fn
def _train_matrices(params: GPParams, x: torch.Tensor, y: torch.Tensor, normalize_y: bool):
    if normalize_y:
        y_mean = torch.mean(y)
        y_std_raw = torch.std(y, correction=0)
        y_std = torch.where(y_std_raw > 0, y_std_raw, torch.ones_like(y_std_raw))
    else:
        y_mean = torch.zeros((), dtype=y.dtype, device=y.device)
        y_std = torch.ones((), dtype=y.dtype, device=y.device)
    yn = (y - y_mean) / y_std
    k = rbf_kernel(x, x, params.lengthscale, params.outputscale)
    noise = torch.as_tensor(params.noise, dtype=k.dtype, device=k.device)
    k = k + torch.diag_embed(noise.expand(x.shape[0]))
    chol = _cholesky(k)
    ynb = yn.expand(chol.shape[:-1])
    alpha = torch.cholesky_solve(ynb[..., None], chol)[..., 0]
    return chol, alpha, ynb, y_mean, y_std


def fit(params: GPParams, x: torch.Tensor, y: torch.Tensor, normalize_y: bool = True) -> GPFit:
    chol, alpha, _, y_mean, y_std = _train_matrices(params, x, y, normalize_y)
    return GPFit(params, x, chol, alpha, y_mean, y_std)


@full_f32_fn
def log_marginal_likelihood(params: GPParams, x: torch.Tensor, y: torch.Tensor,
                            normalize_y: bool = True) -> torch.Tensor:
    """Scalar, or [L] for a lengthscale of shape [L, 1, 1]."""
    chol, alpha, yn, _, _ = _train_matrices(params, x, y, normalize_y)
    n = x.shape[0]
    return (-0.5 * torch.sum(yn * alpha, dim=-1)
            - torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
            - 0.5 * n * _LOG_2PI)


@full_f32_fn
def predict(fit_state: GPFit, x_test: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and *std* at test points (sklearn ``return_std=True``
    convention, de-normalized)."""
    p = fit_state.params
    k_star = rbf_kernel(x_test, fit_state.x, p.lengthscale, p.outputscale)
    mean_n = k_star @ fit_state.alpha
    v = torch.linalg.solve_triangular(fit_state.chol, k_star.T, upper=False)
    var_n = torch.clamp(p.outputscale - torch.sum(v * v, dim=0), min=0.0)
    return mean_n * fit_state.y_std + fit_state.y_mean, torch.sqrt(var_n) * fit_state.y_std


def fit_lengthscale_sweep(x: torch.Tensor, y: torch.Tensor, lengthscale_grid: torch.Tensor,
                          noise: float = 1e-5, outputscale: float = 1.0,
                          normalize_y: bool = True) -> GPFit:
    """Pick the MLL-argmax lengthscale of a grid (one batched Cholesky), then
    condition on it. Replaces sklearn's 10-restart L-BFGS search."""
    def scalar(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    mlls = log_marginal_likelihood(
        GPParams(lengthscale_grid[:, None, None], scalar(outputscale), scalar(noise)),
        x, y, normalize_y)
    best = nanargmax(mlls, dim=0)
    params = GPParams(lengthscale_grid.index_select(0, best.view(1))[0], scalar(outputscale),
                      scalar(noise))
    return fit(params, x, y, normalize_y)


# ---------------------------------------------------------------------------
# Incremental (carried inverse-Cholesky) exact GP: the fused BO loop's GP
# ---------------------------------------------------------------------------
#
# The loop refits every iteration. The kernel matrix depends only on the
# observed x, so the loop carries L⁻¹ and log|K| per lengthscale and borders
# them once per new observation: for L' = [[L, 0], [l₂₁ᵀ, l₂₂]],
# l₂₁ = L⁻¹b, l₂₂ = √(1 + noise − ‖l₂₁‖²) and the inverse gains one row,
# [−l₂₁ᵀL⁻¹/l₂₂, 1/l₂₂]. Slots not yet active are identity rows of L⁻¹ with
# yn = 0, so they add nothing to the MLL and the k* columns are masked to 0.
# The slot index is a Python int: the loop knows its observation count.


class IncrementalGPState(NamedTuple):
    """Carried inverse-Cholesky state over a fixed-size observation buffer,
    with any leading batch dimensions (lengthscales, images)."""

    linv: torch.Tensor     # [..., M, M] lower-triangular inverse Cholesky factor
    logdet: torch.Tensor   # [...] log|valid block of K + noise·I|


def incremental_init(max_obs: int, batch_shape=(), device=None) -> IncrementalGPState:
    eye = torch.eye(max_obs, device=device)
    return IncrementalGPState(eye.expand(*batch_shape, max_obs, max_obs).clone(),
                              torch.zeros(batch_shape, device=device))


@full_f32_fn
def incremental_add(state: IncrementalGPState, xs: torch.Tensor, slot: int,
                    x_new: torch.Tensor, lengthscale: torch.Tensor,
                    noise: float) -> IncrementalGPState:
    """Activate buffer slot ``slot`` (``xs`` already holds ``x_new`` there):
    border the factorization with the RBF couplings to the slots before it
    and diagonal 1 + noise (outputscale 1). ``xs`` [..., M], ``x_new`` and
    ``lengthscale`` broadcast against the state's batch shape. The Schur
    complement is clamped at 1e-12, like a tiny Cholesky pivot."""
    m = xs.shape[-1]
    idx = torch.arange(m, device=xs.device)
    prior = (idx < slot).to(xs.dtype)
    e_i = (idx == slot).to(xs.dtype)
    b = torch.exp(-0.5 * ((x_new[..., None] - xs) / lengthscale[..., None]) ** 2) * prior
    l21 = (state.linv @ b[..., None])[..., 0]
    schur = (1.0 + noise) - torch.sum(l21 * l21, dim=-1)
    l22 = torch.sqrt(torch.clamp(schur, min=1e-12))
    new_row = (e_i - (l21[..., None, :] @ state.linv)[..., 0, :]) / l22[..., None]
    linv = state.linv + e_i[:, None] * (new_row - e_i)[..., None, :]
    return IncrementalGPState(linv, state.logdet + 2.0 * torch.log(l22))


@full_f32_fn
def incremental_mll(state: IncrementalGPState, yn: torch.Tensor, n_valid,
                    u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Log marginal likelihood of the valid block (``yn`` zero on padded
    slots). ``u``, the whitened targets ``linv @ yn``, may come from the
    caller, who shares it with :func:`incremental_predict`."""
    if u is None:
        u = (state.linv @ yn[..., None])[..., 0]
    return -0.5 * torch.sum(u * u, dim=-1) - 0.5 * state.logdet - 0.5 * n_valid * _LOG_2PI


@full_f32_fn
def incremental_predict(state: IncrementalGPState, xs: torch.Tensor, valid: torch.Tensor,
                        yn: torch.Tensor, x_test: torch.Tensor, lengthscale: torch.Tensor,
                        u: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Posterior mean and std [..., C] at ``x_test`` [C] in normalized-y space
    (outputscale 1; the caller de-normalizes). ``xs``, ``valid``, ``yn`` [..., M]."""
    k_star = torch.exp(-0.5 * ((x_test[:, None] - xs[..., None, :])
                               / lengthscale[..., None, None]) ** 2) * valid[..., None, :]
    if u is None:
        u = (state.linv @ yn[..., None])[..., 0]
    linv_t = state.linv.transpose(-1, -2)
    alpha = (linv_t @ u[..., None])[..., 0]          # K⁻¹ yn
    mean = (k_star @ alpha[..., None])[..., 0]
    v = k_star @ linv_t                              # [..., C, M]; σ² = 1 − ‖L⁻¹k*‖²
    var = 1.0 - torch.sum(v * v, dim=-1)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))
