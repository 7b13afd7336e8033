"""bo_call_ms.bo: median of the harness's spans around
``bo_window_saliency`` per request (the fused GP-EI loop, its forwards and
its one device-to-host copy)."""

from portbench.readers import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "bo_call")
