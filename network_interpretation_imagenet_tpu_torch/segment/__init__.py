"""Superpixel segmentation (Felzenszwalb, native C++ with a numpy plain version)."""
