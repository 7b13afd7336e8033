"""Exact GP over the full H x W pixel grid via Kronecker eigenstructure (port
of ``gp/kron.py`` of the JAX package).

On a regular grid the separable RBF kernel factorizes, K = K_h ⊗ K_w, so two
small eigendecompositions give the exact posterior and marginal likelihood
in a few H x H / W x W matrix products:

  K_h = Q_h Λ_h Q_hᵀ,  K_w = Q_w Λ_w Q_wᵀ,  λ_ab = s·λ_h[a]·λ_w[b]
  ỹ    = Q_hᵀ (Y − c) Q_w
  mean = Q_h (λ ⊙ ỹ / (λ + σ²)) Q_wᵀ + c
  var  = s − (Q_h∘Q_h) [λ²/(λ + σ²)] (Q_w∘Q_w)ᵀ
  −MLL = ½ (Σ ỹ²/(λ + σ²) + Σ log(λ + σ²) + n log 2π)

The eigendecompositions run on the host in float64 numpy, cached per
lengthscale as in the JAX package. Everything that scales with the grid runs
on the device under ``kernels.full_f32``. Hyperparameters: the lengthscale
by an MLL sweep over a candidate grid, then 20 Adam(0.1) steps on
(log outputscale, log noise, constant mean) in the winner's fixed eigenbasis,
by ``torch.autograd`` and an Adam with ``optax.adam``'s update. A lengthscale
sweep over L candidates is one batched program with a leading [L] axis, and
:func:`fit_posterior_batch` adds a leading [N] image axis to it.

Entry points take numpy arrays or tensors. A tensor keeps its device; a
numpy array goes to ``device``, the card unless ``"cpu"`` is asked for.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.gp.kernels import full_f32_fn

LENGTHSCALE_GRID = (2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
_LOG_2PI = math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=64)
def _host_eigs(ls_key: float, size: int):
    """Host eigendecomposition of the unit-outputscale 1-D RBF gram."""
    grid = np.arange(size, dtype=np.float64)
    d = grid[:, None] - grid[None, :]
    k = np.exp(-0.5 * (d / float(ls_key)) ** 2)
    lam, q = np.linalg.eigh(k)
    return np.maximum(lam, 0.0).astype(np.float32), q.astype(np.float32)


def _host_factored(ls: float, h: int, w: int):
    ls_key = round(float(ls), 6)
    lam_h, qh = _host_eigs(ls_key, h)
    lam_w, qw = _host_eigs(ls_key, w)
    return qh, qw, np.maximum(np.outer(lam_h, lam_w), 0.0)


def _factored(lengthscales: Sequence[float], h: int, w: int, device) -> Tuple[torch.Tensor, ...]:
    """(Q_h [L, H, H], Q_w [L, W, W], λ̂ [L, H, W]) of each lengthscale, on ``device``."""
    qh, qw, lam = zip(*[_host_factored(float(ls), h, w) for ls in lengthscales])
    return tuple(torch.from_numpy(np.stack(a)).to(device) for a in (qh, qw, lam))


class KronGPParams(NamedTuple):
    log_lengthscale: torch.Tensor
    log_outputscale: torch.Tensor
    log_noise: torch.Tensor
    mean_const: torch.Tensor


def init_params(lengthscale: float = 20.0, outputscale: float = 1.0, noise: float = 0.1,
                mean_const: float = 0.0, device=None) -> KronGPParams:
    """Log-parameters on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return KronGPParams(torch.log(f32(lengthscale)), torch.log(f32(outputscale)),
                        torch.log(f32(noise)), f32(mean_const))


def _grid(y, device) -> torch.Tensor:
    """A heat grid (or a batch of grids) as f32 on its device, or on ``device``."""
    if isinstance(y, torch.Tensor):
        return y.float()
    return torch.from_numpy(np.asarray(y, np.float32)).to(resolve_device(device))


def _unpack(params: KronGPParams, device):
    """(lengthscale as a host float, outputscale, noise, mean on ``device``)."""
    def dev(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device)

    return (float(torch.exp(torch.as_tensor(params.log_lengthscale, dtype=torch.float32))),
            torch.exp(dev(params.log_outputscale)), torch.exp(dev(params.log_noise)),
            dev(params.mean_const))


@full_f32_fn
def _mll_core(qh, qw, lam_hat, y, os_, noise, mean_const) -> torch.Tensor:
    n = y.shape[-2] * y.shape[-1]
    denom = os_ * lam_hat + noise
    yt = qh.transpose(-1, -2) @ (y - mean_const) @ qw
    return 0.5 * (torch.sum(yt * yt / denom, dim=(-2, -1))
                  + torch.sum(torch.log(denom), dim=(-2, -1)) + n * _LOG_2PI)


@full_f32_fn
def _posterior_core(qh, qw, lam_hat, y, os_, noise, mean_const):
    """Mean and variance at the grid; every argument may carry leading batch
    dimensions (scalars as [...,  1, 1])."""
    lam = os_ * lam_hat
    denom = lam + noise
    yt = qh.transpose(-1, -2) @ (y - mean_const) @ qw
    mean = qh @ (lam * yt / denom) @ qw.transpose(-1, -2) + mean_const
    m = lam * lam / denom
    var = os_ - (qh * qh) @ m @ (qw * qw).transpose(-1, -2)
    return mean, torch.clamp(var, min=1e-12)


def neg_mll(params: KronGPParams, y_grid, device=None) -> torch.Tensor:
    """Exact negative log marginal likelihood of the grid observations."""
    y = _grid(y_grid, device)
    h, w = y.shape
    ls, os_, noise, mc = _unpack(params, y.device)
    qh, qw, lam = _factored([ls], h, w, y.device)
    return _mll_core(qh[0], qw[0], lam[0], y, os_, noise, mc)


def posterior(params: KronGPParams, y_grid, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact posterior mean and variance at every grid point."""
    y = _grid(y_grid, device)
    h, w = y.shape
    ls, os_, noise, mc = _unpack(params, y.device)
    qh, qw, lam = _factored([ls], h, w, y.device)
    return _posterior_core(qh[0], qw[0], lam[0], y, os_, noise, mc)


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], state: dict, lr: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> List[torch.Tensor]:
    """One step of ``optax.adam(lr)`` (no ``eps_root``), in its order of
    operations: bias-corrected moments, ``-lr * m̂ / (√v̂ + eps)`` added to
    each parameter. ``state`` holds the step count and the moments. The
    bias corrections ``1 - b**t`` are f32, as optax computes them (in f64,
    ``1 - 0.999`` alone differs by 1.3e-5 relative)."""
    t = state["count"] = state.get("count", 0) + 1
    mus = state.setdefault("mu", [torch.zeros_like(p) for p in params])
    nus = state.setdefault("nu", [torch.zeros_like(p) for p in params])
    f32 = dict(dtype=torch.float32, device=params[0].device)
    bc1 = 1 - torch.tensor(b1, **f32) ** t
    bc2 = 1 - torch.tensor(b2, **f32) ** t
    out = []
    for i, (p, g) in enumerate(zip(params, grads)):
        mus[i] = (1 - b1) * g + b1 * mus[i]
        nus[i] = (1 - b2) * g * g + b2 * nus[i]
        m_hat = mus[i] / bc1
        v_hat = nus[i] / bc2
        out.append(p + (-lr) * (m_hat / (torch.sqrt(v_hat) + eps)))
    return out


def _factored_mll(yt, ones_t, lam_hat, log_os, log_noise, mean) -> torch.Tensor:
    """−MLL in a fixed eigenbasis, with the constant mean's projection
    ``ones_t``; the three scalars broadcast as [..., 1, 1]."""
    n = yt.shape[-2] * yt.shape[-1]
    e = lambda v: v[..., None, None]  # noqa: E731
    denom = torch.exp(e(log_os)) * lam_hat + torch.exp(e(log_noise))
    yc = yt - e(mean) * ones_t
    return 0.5 * (torch.sum(yc * yc / denom, dim=(-2, -1))
                  + torch.sum(torch.log(denom), dim=(-2, -1)) + n * _LOG_2PI)


@full_f32_fn
def _sweep(qh_all, qw_all, lam_all, y: torch.Tensor):
    """Every candidate's −MLL at the data-moment start for heat grids
    ``y`` [N, H, W]: one batched program over [N, L]. Returns (scores
    [N, L], ỹ [N, L, H, W], the mean's projection [L, H, W], the start's
    three parameters [N] each)."""
    y_mean0 = torch.mean(y, dim=(1, 2))
    y_var0 = torch.clamp(torch.var(y, dim=(1, 2), correction=0), min=1e-6)
    p0 = [torch.log(y_var0), torch.log(0.1 * y_var0), y_mean0]
    yt_all = qh_all.transpose(-1, -2)[None] @ y[:, None] @ qw_all[None]
    ones_all = qh_all.sum(dim=1)[:, :, None] * qw_all.sum(dim=1)[:, None, :]
    scores = _factored_mll(yt_all, ones_all, lam_all, *(p[:, None] for p in p0))
    return scores, yt_all, ones_all, p0


@full_f32_fn
def _fit(qh_all, qw_all, lam_all, y: torch.Tensor, iters: int, lr: float):
    """The lengthscale sweep and the Adam phase for heat grids ``y`` [N, H, W]
    against the candidates' bases [L, ...], batched over the image axis.
    Returns (best [N] on the device, the three fitted parameters [N] each,
    losses [N, iters])."""
    scores, yt_all, ones_all, params = _sweep(qh_all, qw_all, lam_all, y)
    best = torch.argmin(scores, dim=1)
    yt = yt_all[torch.arange(y.shape[0], device=y.device), best]
    ones_t, lam_hat = ones_all[best], lam_all[best]
    state: dict = {}
    losses = []
    for _ in range(iters):
        leaves = [p.detach().requires_grad_(True) for p in params]
        with torch.enable_grad():
            loss = _factored_mll(yt, ones_t, lam_hat, *leaves)
            grads = torch.autograd.grad(loss.sum(), leaves)
        losses.append(loss.detach())
        params = adam_step([p.detach() for p in leaves], list(grads), state, lr)
    return best, params, torch.stack(losses, dim=1) if losses else y.new_zeros((y.shape[0], 0))


def fit_adam(y_grid, params: KronGPParams = None, iters: int = 20, lr: float = 0.1,
             lengthscale_grid: Tuple[float, ...] = LENGTHSCALE_GRID,
             device=None) -> Tuple[KronGPParams, torch.Tensor]:
    """Hyperparameters against the exact MLL, the reference's 20 Adam(0.1)
    steps (``gp_regression.py:179-224``):

    1. the lengthscale by an MLL sweep over ``lengthscale_grid``, each
       candidate scored at the data-moment start (outputscale var(y), noise
       0.1·var(y), mean mean(y)), which makes the choice scale-equivariant;
    2. Adam on (log_outputscale, log_noise, mean_const) in the winner's
       fixed eigenbasis, where the gradients are exact.

    ``params`` is ignored (the lengthscale comes from the sweep), as in the
    JAX package. Returns (params, per-step loss history [iters])."""
    del params
    y = _grid(y_grid, device)
    h, w = y.shape
    best, (log_os, log_noise, mean), losses = _fit(*_factored(lengthscale_grid, h, w, y.device),
                                                   y[None], int(iters), float(lr))
    ls_best = float(lengthscale_grid[int(best[0])])
    log_ls = torch.log(torch.tensor(ls_best, dtype=torch.float32, device=y.device))
    return KronGPParams(log_ls, log_os[0], log_noise[0], mean[0]), losses[0]


@full_f32_fn
def predict_offgrid(params: KronGPParams, y_grid, points, device=None) -> torch.Tensor:
    """Posterior mean at float (row, col) ``points`` [P, 2], through the
    separable cross-kernel: mean(t) = k_h(t_r)ᵀ A k_w(t_c) + c with
    A = unvec((K + σ²I)⁻¹ (y − c))."""
    y = _grid(y_grid, device)
    h, w = y.shape
    ls, os_, noise, mc = _unpack(params, y.device)
    qh, qw, lam_hat = (a[0] for a in _factored([ls], h, w, y.device))
    lam = os_ * lam_hat
    yt = qh.T @ (y - mc) @ qw
    alpha_grid = qh @ (yt / (lam + noise)) @ qw.T
    pts = torch.as_tensor(points, dtype=torch.float32).to(y.device)
    rows = torch.arange(h, dtype=torch.float32, device=y.device)
    cols = torch.arange(w, dtype=torch.float32, device=y.device)
    ls_t = torch.tensor(ls, dtype=torch.float32, device=y.device)
    kr = os_ * torch.exp(-0.5 * ((pts[:, 0:1] - rows[None, :]) / ls_t) ** 2)
    kc = torch.exp(-0.5 * ((pts[:, 1:2] - cols[None, :]) / ls_t) ** 2)
    return torch.einsum("ph,hw,pw->p", kr, alpha_grid, kc) + mc


def fit_posterior_batch(y_grids, iters: int = 20, lr: float = 0.1,
                        lengthscale_grid: Tuple[float, ...] = LENGTHSCALE_GRID, device=None):
    """N pixel-GP fits and their exact posteriors as two batched programs:
    the sweep + Adam over a leading image axis (the candidates' bases are
    shared), then every image's posterior in its winner's basis. Returns
    (params list[N], means [N, H, W], vars [N, H, W], losses [N, iters])."""
    y = _grid(y_grids, device)
    n, h, w = y.shape
    qh_all, qw_all, lam_all = _factored(lengthscale_grid, h, w, y.device)
    best, (log_os, log_noise, mean), losses = _fit(qh_all, qw_all, lam_all, y, int(iters),
                                                   float(lr))
    e = lambda v: v[:, None, None]  # noqa: E731
    means, vars_ = _posterior_core(qh_all[best], qw_all[best], lam_all[best], y,
                                   e(torch.exp(log_os)), e(torch.exp(log_noise)), e(mean))
    grid = torch.tensor(lengthscale_grid, dtype=torch.float32, device=y.device)
    log_ls = torch.log(grid[best])
    params = [KronGPParams(log_ls[i], log_os[i], log_noise[i], mean[i]) for i in range(n)]
    return params, means, vars_, losses
