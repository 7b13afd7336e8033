"""Acquisition functions (port of ``bo/acquisition.py`` of the JAX package).

EI in closed form for all candidates at once; the argmax over the integer
candidates is exact. The reference's ``expected_improvement[sigma == 0.0] ==
0.0`` no-op line is implemented as the assignment it meant.
"""

from __future__ import annotations

import math

import torch

from network_interpretation_imagenet_tpu_torch.gp import exact

_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def expected_improvement(mu: torch.Tensor, sigma: torch.Tensor, evaluated_loss: torch.Tensor,
                         greater_is_better: bool = False) -> torch.Tensor:
    """Closed-form EI given the GP posterior (μ, σ) at candidates [..., C] and
    the observed values [..., N]. Zero where σ is not positive."""
    if greater_is_better:
        loss_optimum, scale = torch.amax(evaluated_loss, dim=-1, keepdim=True), 1.0
    else:
        loss_optimum, scale = torch.amin(evaluated_loss, dim=-1, keepdim=True), -1.0
    positive = sigma > 0
    safe_sigma = torch.where(positive, sigma, torch.ones_like(sigma))
    z = scale * (mu - loss_optimum) / safe_sigma
    ei = (scale * (mu - loss_optimum) * torch.special.ndtr(z)
          + safe_sigma * (torch.exp(-0.5 * z * z) * _INV_SQRT_2PI))
    return torch.where(positive, ei, torch.zeros_like(ei))


def ei_over_candidates(fit: exact.GPFit, candidates: torch.Tensor, evaluated_loss: torch.Tensor,
                       greater_is_better: bool = True) -> torch.Tensor:
    """EI at every candidate (one posterior evaluation)."""
    mu, sigma = exact.predict(fit, candidates)
    return expected_improvement(mu, sigma, evaluated_loss, greater_is_better)
