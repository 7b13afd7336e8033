"""setup_s: seconds from the process's start to the first timed request (imports, kernel builds or loads, weights, images, calibration, warm-up)."""

from portbench.readers import setup_s as read  # noqa: F401
