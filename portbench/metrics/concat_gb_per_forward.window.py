"""concat_gb_per_forward.window: the median ``concat_bytes`` / 1e9 of the
window's ``plan.forward`` spans whose ``batch`` is the traffic's
``mask_batch``: the gigabytes the dense layers' concatenations write in one
masked forward (a counter of the program, ``DenseLayer.concat_bytes`` read
by ``ModulePlan``; 9.467 for DenseNet-201 at 256 images of 224^2 in bf16,
less once a change writes each layer's new features into a block-wide
buffer). None untraced, or where the program's plan records no such span
or attribute (a checkout before the module plan counted them)."""

import numpy as np

from portbench.program_spans import window_spans


def read(ctx):
    spans = window_spans(ctx)
    if not spans:
        return None
    batch = int(ctx.traffic["mask_batch"])
    counts = [s.attrs["concat_bytes"] for s in spans
              if s.name == "plan.forward" and s.attrs and s.attrs.get("batch") == batch
              and "concat_bytes" in s.attrs]
    return float(np.median(counts)) / 1e9 if counts else None
