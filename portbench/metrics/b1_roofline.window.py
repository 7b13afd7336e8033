"""b1_roofline.window: the finished work's B1 bytes bound over the union of the b1_ kernels' device intervals."""

from portbench.readers import b1_roofline as read  # noqa: F401
