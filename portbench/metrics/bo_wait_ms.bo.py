"""bo_wait_ms.bo: median per request of the program's span ``bo.fetch``,
the host waiting for the replayed BO loop."""

from portbench.program_spans import bo_wait_ms as read  # noqa: F401
