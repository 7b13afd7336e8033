"""other_kernels_ms_per_kevals.window: device ms of every operation outside b1_ and b2_ per 1,000 masked forwards."""

from portbench.readers import other_kernels_ms_per_kevals as read  # noqa: F401
