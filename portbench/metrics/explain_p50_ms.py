"""explain_p50_ms: median latency of the window's flagship explanations,
from a request's hand-off to its heatmap's bbox and IOU on the host."""

from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 50)
