"""plan_ops_per_forward.window: the device kernels of one masked forward,
from the trace: the median, over the gaps between consecutive B1 launches
in the window, of the kernels that ran in the gap (copies and sets left
out). Each chunk of masks is one B1 launch, then the chunk's forward and
its outcomes; the gap after an image's last chunk also holds the next
image's prediction, and the median passes over those. This is what a
BatchNorm fold or a ReLU fusion takes away. None untraced or with fewer
than two B1 launches."""

import numpy as np

from portbench.trace import family

_NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    if not ctx.traced:
        return None
    events = sorted((a, n) for n, a, _ in ctx.trace.kernels if not n.startswith(_NOT_KERNELS))
    b1 = [i for i, (_, n) in enumerate(events) if family(n) == "b1"]
    if len(b1) < 2:
        return None
    return float(np.median([j - i - 1 for i, j in zip(b1, b1[1:])]))
