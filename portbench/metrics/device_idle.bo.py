"""device_idle.bo: share of the traced window with no operation on the device."""

from portbench.readers import device_idle as read  # noqa: F401
