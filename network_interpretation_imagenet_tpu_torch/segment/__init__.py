"""Superpixel segmentation: Felzenszwalb (native C++ with a numpy plain
version) and SLIC (k-means on the device, a native connectivity pass)."""
