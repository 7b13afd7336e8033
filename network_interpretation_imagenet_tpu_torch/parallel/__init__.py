"""Parallelism (port of ``parallel/`` of the JAX package). One device for
now: the train step. The mesh, the sharded engine and multi-process runs
move to ``torch.distributed`` with ROADMAP.md section A, item 7."""

from network_interpretation_imagenet_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    make_sharded_train_step,
)
