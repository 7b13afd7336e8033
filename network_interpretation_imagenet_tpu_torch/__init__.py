"""PyTorch/CUDA port of network_interpretation_imagenet_tpu for NVIDIA Hopper.

The JAX package beside it is the reference; this package imports torch,
numpy and scipy only. Its entry points run on the card unless the caller
passes ``device="cpu"``.
"""
