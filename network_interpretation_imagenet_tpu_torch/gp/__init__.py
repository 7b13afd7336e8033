"""Gaussian processes: the exact GP that serves as the BO surrogate."""

from network_interpretation_imagenet_tpu_torch.gp import exact  # noqa: F401
from network_interpretation_imagenet_tpu_torch.gp.kernels import rbf_kernel  # noqa: F401
