"""plan_host_ms.window: median over the window's images of the summed host
time of the program's ``plan.forward`` spans carrying the image's request
id (its prediction and its masked forwards through ``ModulePlan``): the
host launching the net, or waiting for room to launch it. None where the
program records no such span (an arch that runs B2's folded net, or a
checkout whose plan has no span)."""

import numpy as np

from portbench.program_spans import window_spans


def read(ctx):
    spans = window_spans(ctx)
    if not spans:
        return None
    images = {s.rid for s in spans if s.name == "sweep.collect"}
    per_image = {}
    for s in spans:
        if s.name == "plan.forward" and s.rid in images:
            per_image[s.rid] = per_image.get(s.rid, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return float(np.median(list(per_image.values()))) if per_image else None
