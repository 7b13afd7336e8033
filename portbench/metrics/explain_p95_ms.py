"""explain_p95_ms: the 95th percentile of the same latencies; a window of
some hundreds of requests leaves tens beyond it."""

from portbench.readers import latency_ms


def read(ctx):
    return latency_ms(ctx, 95)
