"""Training harness (port of ``train/`` of the JAX package): classifier
training for ``cli.main`` and the MNIST / CIFAR generators."""

from network_interpretation_imagenet_tpu_torch.train.harness import (  # noqa: F401
    Trainer,
    make_optimizer,
)
