"""mfu.window: the finished work's forward operations over the traced window, as a share of the peak in the config's dtype."""

from portbench.readers import mfu as read  # noqa: F401
