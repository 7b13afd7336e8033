"""b2_roofline.window: the finished work's B2 chain bounds over the union of the b2_ kernels' device intervals."""

from portbench.readers import b2_roofline as read  # noqa: F401
