"""Configuration (port of ``config.py`` of the JAX package): the dataset
registry, segmentation settings, the BO settings and the training
harness's settings."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    image_size: int          # square side length n (224/32/28)
    channels: int
    augmentation: bool = False
    # Normalization applied after scaling to [0, 1].
    mean: Tuple[float, ...] = (0.0,)
    std: Tuple[float, ...] = (1.0,)


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CIFAR10_MEAN = (0.4914, 0.4824, 0.4467)
CIFAR10_STD = (0.2471, 0.2435, 0.2616)
CIFAR100_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR100_STD = (0.2675, 0.2565, 0.2761)

DATASETS = {
    "cifar10": DatasetSpec("cifar10", 10, 32, 3, False, CIFAR10_MEAN, CIFAR10_STD),
    "cifar10+": DatasetSpec("cifar10+", 10, 32, 3, True, CIFAR10_MEAN, CIFAR10_STD),
    "cifar100": DatasetSpec("cifar100", 100, 32, 3, False, CIFAR100_MEAN, CIFAR100_STD),
    "cifar100+": DatasetSpec("cifar100+", 100, 32, 3, True, CIFAR100_MEAN, CIFAR100_STD),
    "mnist": DatasetSpec("mnist", 10, 28, 1, False, (0.0,), (1.0,)),
    "imagenet": DatasetSpec("imagenet", 1000, 224, 3, False, IMAGENET_MEAN, IMAGENET_STD),
}


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    # "felzenszwalb" (host, the reference's) or "slic" (k-means on the device).
    method: str = "felzenszwalb"
    # scale=None -> area-adaptive max(1, 100*H*W/224^2): the reference's
    # scale=100 is a 224^2 calibration in pixel-count units, so a fixed 100
    # over-merges small images into one segment. Explicit floats are used as
    # given (pass scale=100 for the reference's setting).
    scale: "float | None" = None
    sigma: float = 0.5
    min_size: int = 50
    # slic params
    n_segments: int = 48            # target number of superpixels
    compactness: float = 10.0
    slic_iters: int = 10
    # The host pass merging SLIC islands, so superpixels are connected as FH's are.
    enforce_connectivity: bool = True


@dataclasses.dataclass(frozen=True)
class BOConfig:
    """GP-EI BO settings (reference bayesian_active_learning_imagenet.py:479-486,
    BayesianOptimization.py:99-192)."""

    n_iters: int = 10
    n_pre_samples: int = 3
    alpha: float = 1e-5              # GP noise (reference BO alpha=1e-5)
    epsilon: float = 1e-7            # duplicate-rejection tolerance
    # The MLL argmax over this grid replaces sklearn's n_restarts_optimizer=10.
    lengthscale_grid: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The training harness's settings (reference ``args.py:83-117``'s
    optimizer group, ``generate_gp_training_data_cifar.py:81-234``)."""

    optimizer: str = "sgd"           # sgd | rmsprop | adam (reference args.py:88)
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    epochs: int = 90
    batch_size: int = 64
    patience: int = 0                # early stop (reference args.py:92-94; 0 = off)
    seed: int = 0
    decay_rate: float = 0.1
    decay_epochs: Tuple[int, ...] = (30, 60)  # lr schedule (ref adjust_learning_rate)
    print_freq: int = 0              # per-batch meter line every N steps (stock main.py -p)
