"""mfu.window: the finished work's forward operations over the traced window, as a share of the bf16 peak."""

from portbench.readers import mfu as read  # noqa: F401
