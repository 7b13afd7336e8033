"""Grid-inducing variational GP with a Bernoulli (probit) likelihood (port of
``gp/variational.py`` of the JAX package): the classification surrogate of
the reference (``gp_classification.py:139-217``, a 10 x 10 inducing grid,
30 Adam(0.1) steps).

Inducing points are a g x g grid over the pixel square; q(u) = N(m, L Lᵀ) is
fitted against the sparse-GP ELBO, with the probit expectation by 20-point
Gauss-Hermite quadrature:

  q(f_i) = N(μ_i, s_i²),  μ = A m,  s² = k_ii − a_iᵀ(K_uu − S)a_i,
  A = K_fu K_uu⁻¹,  predictive p(y=1|x) = Φ(μ/√(1+s²)).

Every product runs under ``kernels.full_f32``, the autograd through the
Cholesky included: the math relies on positive-definiteness, which the JAX
package guards with HIGHEST matmul precision. A failed Cholesky gives NaN,
as ``jnp.linalg.cholesky`` does. Parameters may carry a leading image axis:
:func:`fit_predict_batch` fits N label vectors as one batched program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from network_interpretation_imagenet_tpu_torch.device import resolve_device
from network_interpretation_imagenet_tpu_torch.gp.exact import _cholesky
from network_interpretation_imagenet_tpu_torch.gp.kernels import full_f32_fn, rbf_kernel
from network_interpretation_imagenet_tpu_torch.gp.kron import adam_step
from network_interpretation_imagenet_tpu_torch.parallel.mesh import axis_size, map_sharded

_GH_DEG = 20
_GH_X, _GH_W = np.polynomial.hermite_e.hermegauss(_GH_DEG)
_JITTER = 1e-4


class VGPParams(NamedTuple):
    log_lengthscale: torch.Tensor
    log_outputscale: torch.Tensor
    var_mean: torch.Tensor       # [M] variational mean m
    var_chol_raw: torch.Tensor   # [M, M] raw lower-tri (diag softplus'd) for L


class VGPModel(NamedTuple):
    params: VGPParams
    inducing: torch.Tensor       # [M, 2]


def make_grid_inducing(n: int, grid_size: int = 10, device=None) -> torch.Tensor:
    """g x g inducing grid over [0, n)² (the reference's grid_bounds), on
    ``device`` (the card unless ``"cpu"``)."""
    g = torch.linspace(0.0, float(n - 1), grid_size, dtype=torch.float64).float()
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    return torch.stack([yy.reshape(-1), xx.reshape(-1)], dim=1).to(resolve_device(device))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))   # jax.nn.softplus


def _softplus_inv(y: float) -> float:
    return float(np.log(np.expm1(y)))


def init_model(n: int, grid_size: int = 10, lengthscale: float = 20.0,
               device=None) -> VGPModel:
    """The starting model on ``device`` (the card unless ``"cpu"``)."""
    dev = resolve_device(device)
    m = grid_size * grid_size
    params = VGPParams(torch.log(torch.tensor(lengthscale, dtype=torch.float32, device=dev)),
                       torch.tensor(0.0, device=dev), torch.zeros(m, device=dev),
                       torch.eye(m, device=dev) * _softplus_inv(1.0))
    return VGPModel(params, make_grid_inducing(n, grid_size, dev))


def _chol_from_raw(raw: torch.Tensor) -> torch.Tensor:
    return torch.tril(raw, -1) + torch.diag_embed(_softplus(torch.diagonal(raw, dim1=-2, dim2=-1)))


@full_f32_fn
def _marginals(params: VGPParams, inducing: torch.Tensor, x: torch.Tensor):
    """q(f) marginals μ [..., P], s² [..., P] at inputs ``x`` [P, 2], with
    the K_uu Cholesky and S's factor; leading dimensions of the parameters
    broadcast through."""
    ls = torch.exp(params.log_lengthscale)[..., None, None]
    os_ = torch.exp(params.log_outputscale)[..., None, None]
    m_ind = inducing.shape[0]
    kuu = rbf_kernel(inducing, inducing, ls, os_) + _JITTER * torch.eye(m_ind, device=x.device)
    kfu = rbf_kernel(x, inducing, ls, os_)
    luu = _cholesky(kuu)
    a_t = torch.cholesky_solve(kfu.transpose(-1, -2), luu)            # [..., M, P]
    mu = (params.var_mean[..., None, :] @ a_t)[..., 0, :]
    s_chol = _chol_from_raw(params.var_chol_raw)
    v1 = luu.transpose(-1, -2) @ a_t
    v2 = s_chol.transpose(-1, -2) @ a_t
    s2 = os_[..., 0] - torch.sum(v1 * v1, dim=-2) + torch.sum(v2 * v2, dim=-2)
    return mu, torch.clamp(s2, min=1e-8), luu, s_chol


@full_f32_fn
def _kl(params: VGPParams, luu: torch.Tensor, s_chol: torch.Tensor) -> torch.Tensor:
    """KL(q(u) ‖ p(u)) for p = N(0, K_uu)."""
    m = params.var_mean.shape[-1]
    w = torch.linalg.solve_triangular(luu, s_chol, upper=False)
    mahal_v = torch.linalg.solve_triangular(luu, params.var_mean[..., None], upper=False)
    logdet_p = 2.0 * torch.sum(torch.log(torch.diagonal(luu, dim1=-2, dim2=-1)), dim=-1)
    logdet_q = 2.0 * torch.sum(torch.log(torch.diagonal(s_chol, dim1=-2, dim2=-1)), dim=-1)
    return 0.5 * (torch.sum(w * w, dim=(-2, -1)) + torch.sum(mahal_v * mahal_v, dim=(-2, -1))
                  - m + logdet_p - logdet_q)


def _expected_log_probit(mu: torch.Tensor, s2: torch.Tensor, y_pm1: torch.Tensor) -> torch.Tensor:
    """E_{f~N(μ,s²)}[log Φ(y·f)] by Gauss-Hermite quadrature, [..., P]."""
    x = torch.tensor(_GH_X, dtype=torch.float32, device=mu.device)
    w = torch.tensor(_GH_W, dtype=torch.float32, device=mu.device) / math.sqrt(2.0 * math.pi)
    f = mu[..., None] + torch.sqrt(s2)[..., None] * x
    return torch.sum(w * torch.special.log_ndtr(y_pm1[..., None] * f), dim=-1)


def neg_elbo(params: VGPParams, inducing: torch.Tensor, x: torch.Tensor,
             y01: torch.Tensor) -> torch.Tensor:
    """−ELBO, a scalar, or [N] for parameters with a leading image axis and
    labels [N, P]."""
    mu, s2, luu, s_chol = _marginals(params, inducing, x)
    ell = torch.sum(_expected_log_probit(mu, s2, 2.0 * y01 - 1.0), dim=-1)
    return -(ell - _kl(params, luu, s_chol))


@full_f32_fn
def _fit(params: VGPParams, inducing, x, y, iters: int, lr: float):
    """``iters`` Adam steps of the −ELBO on every parameter; with a leading
    image axis each image's loss is its own (the sum's gradient splits).
    Returns (fitted params, losses [..., iters])."""
    leaves_now = list(params)
    state: dict = {}
    losses = []
    for _ in range(iters):
        leaves = [p.detach().requires_grad_(True) for p in leaves_now]
        with torch.enable_grad():
            loss = neg_elbo(VGPParams(*leaves), inducing, x, y)
            grads = torch.autograd.grad(loss.sum(), leaves)
        losses.append(loss.detach())
        leaves_now = adam_step([p.detach() for p in leaves], list(grads), state, lr)
    hist = torch.stack(losses, dim=-1) if losses else torch.zeros(0, device=x.device)
    return VGPParams(*leaves_now), hist


def _points(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32).to(device)


def fit_adam(model: VGPModel, x, y01, iters: int = 30,
             lr: float = 0.1) -> Tuple[VGPModel, torch.Tensor]:
    """The reference's training loop: ``iters`` full-batch Adam(lr) steps, on
    the model's device. Returns (fitted model, losses [iters])."""
    dev = model.inducing.device
    pf, losses = _fit(model.params, model.inducing, _points(x, dev), _points(y01, dev),
                      int(iters), float(lr))
    return VGPModel(pf, model.inducing), losses


@full_f32_fn
def _predict_proba_params(params: VGPParams, inducing: torch.Tensor,
                          x: torch.Tensor) -> torch.Tensor:
    """p(y=1|x) = Φ(μ/√(1+s²)), the probit predictive."""
    mu, s2, _, _ = _marginals(params, inducing, x)
    return torch.special.ndtr(mu / torch.sqrt(1.0 + s2))


def predict_proba(model: VGPModel, x) -> torch.Tensor:
    """p(y=1|x) [P] at points ``x`` [P, 2]."""
    return _predict_proba_params(model.params, model.inducing, _points(x, model.inducing.device))


def fit_predict_batch(model: VGPModel, x, ys01, x_test=None, iters: int = 30, lr: float = 0.1,
                      return_models: bool = True, mesh=None, data_axis: str = "data"):
    """N classification GPs, sharing the coordinates ``x`` [P, 2], the
    inducing grid and the start, fitted to labels ``ys01`` [N, P] and
    evaluated at ``x_test`` (default ``x``) as one batched program with a
    leading image axis. Returns (models list[N], or None with
    ``return_models=False``; probs [N, T]; losses [N, iters]).

    With ``mesh`` (more than one rank on ``data_axis``, every rank passing
    the same labels) the image axis pads to a multiple of the axis size with
    repeats of the first label vector and shards; coordinates, inducing grid
    and start replicate; one all-gather gives every rank all N results."""
    dev = model.inducing.device
    xs = _points(x, dev)
    ys = _points(ys01, dev)
    xt = xs if x_test is None else _points(x_test, dev)
    n = ys.shape[0]

    def run(ys_local):
        m = ys_local.shape[0]
        p0 = VGPParams(*(p.expand(m, *p.shape).contiguous() for p in model.params))
        pf, losses = _fit(p0, model.inducing, xs, ys_local, int(iters), float(lr))
        return (*pf, _predict_proba_params(pf, model.inducing, xt), losses)

    sharded = mesh is not None and axis_size(mesh, data_axis) > 1
    *pf, probs, losses = map_sharded(mesh if sharded else None, run, [ys], axis=data_axis)
    if not return_models:
        return None, probs, losses
    models: List[VGPModel] = [VGPModel(VGPParams(*(p[i] for p in pf)), model.inducing)
                              for i in range(n)]
    return models, probs, losses
