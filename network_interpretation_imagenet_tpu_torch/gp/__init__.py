"""Gaussian processes: the exact GP that serves as the BO surrogate
(:mod:`gp.exact`), and the pixel-grid saliency surrogates: the exact
Kronecker GP (:mod:`gp.kron`) and the grid-inducing probit variational GP
(:mod:`gp.variational`)."""

from network_interpretation_imagenet_tpu_torch.gp import exact, kron, variational  # noqa: F401
from network_interpretation_imagenet_tpu_torch.gp.kernels import rbf_kernel  # noqa: F401
