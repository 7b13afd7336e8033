"""syncs_per_image.window: median over the window's images of the
program's ``engine.upload`` and ``engine.fetch`` spans carrying the image's
request id: the synchronising copies an image makes."""

from portbench.program_spans import syncs_per_image as read  # noqa: F401
