"""Host ops and the hand-written CUDA kernels (B1 ``masked_batch``, B2
``bottleneck_chain``, P1 ``pool_nhwc``) with their plain PyTorch versions."""
