"""Parallelism on ``torch.distributed`` (port of ``parallel/`` of the JAX
package): one process per device, the ranks laid out as a ("data", "model")
mesh (``parallel.mesh``). The mask and image batches of every explanation
shard over "data" (``parallel.sharded_engine`` and the ``mesh=`` of the
explanation functions), and val-set sweeps stride their images across
processes (``parallel.multihost``). The train step (``parallel.train_step``)
steps each rank's rows of the global batch with BatchNorm's statistics and
the gradients reduced over "data", and splits wide parameters' output
channels over "model" (:func:`param_shardings`).
"""

from network_interpretation_imagenet_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)
from network_interpretation_imagenet_tpu_torch.parallel.sharded_engine import (  # noqa: F401
    sharded_knockout_eval,
    sharded_knockout_eval_multi,
    sharded_window_eval,
    sharded_window_eval_multi,
)
from network_interpretation_imagenet_tpu_torch.parallel.train_step import (  # noqa: F401
    TrainState,
    make_sharded_train_step,
    param_shardings,
)
