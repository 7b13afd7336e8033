"""bo_host_ms.bo: median per request of the program's span ``bo.call``
outside its ``bo.replay`` and ``bo.fetch`` children: the BO request's host
work besides the graph's launch and the wait."""

from portbench.program_spans import bo_host_ms as read  # noqa: F401
