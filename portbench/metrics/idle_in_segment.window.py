"""idle_in_segment.window: share of the window's device-idle time, on the
host's clock (re-anchored at the device-to-host copies), that lies inside
the program's ``segment`` spans."""

from portbench.program_spans import idle_in_segment as read  # noqa: F401
