"""segment_ms.window: median over the window's images of the program's
span ``segment`` (Felzenszwalb on the host, inside ``segment_image``)."""

from portbench.program_spans import segment_ms as read  # noqa: F401
