"""segment_ms.bo: median of the harness's spans around ``segment_image``
(Felzenszwalb on the host) per request."""

from portbench.readers import span_p50_ms


def read(ctx):
    return span_p50_ms(ctx, "segment")
