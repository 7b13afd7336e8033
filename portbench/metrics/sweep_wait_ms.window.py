"""sweep_wait_ms.window: median over the window's images of the program's
``engine.upload`` and ``engine.fetch`` spans carrying the image's request
id, summed: the sweep's host blocked on the stream."""

from portbench.program_spans import sweep_wait_ms as read  # noqa: F401
