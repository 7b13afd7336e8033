"""grouped_convs_per_forward.window: the median ``grouped_convs`` of the
window's ``plan.forward`` spans whose ``batch`` is the traffic's
``mask_batch``: the grouped convolutions the folded plan launches in one
masked forward (a counter of the program, ``FoldedResNet``'s; 33 for
ResNeXt-101 32x8d while cuDNN runs its grouped 3x3s, 0 once a kernel of the
port takes them). None untraced, or where the program's plan records no
such span or attribute (a checkout before the folded plan had its span)."""

import numpy as np

from portbench.program_spans import window_spans


def read(ctx):
    spans = window_spans(ctx)
    if not spans:
        return None
    batch = int(ctx.traffic["mask_batch"])
    counts = [s.attrs["grouped_convs"] for s in spans
              if s.name == "plan.forward" and s.attrs and s.attrs.get("batch") == batch
              and "grouped_convs" in s.attrs]
    return float(np.median(counts)) if counts else None
