"""Bayesian optimization over mask space."""

from network_interpretation_imagenet_tpu_torch.bo.acquisition import (  # noqa: F401
    expected_improvement,
)
from network_interpretation_imagenet_tpu_torch.bo.loop import (  # noqa: F401
    BOResult,
    FusedWindowBO,
    bayesian_optimize,
    fused_window_bo,
    make_fused_window_bo,
    next_pow2,
    window_draws,
)
