"""Shared helpers of the tests/test_torch_*.py port-parity tests."""

import numpy as np


def randomize_bn(params, stats, rng):
    """Give every BatchNorm of a flax variable tree random scale, bias and
    running statistics in place, so BatchNorm folding is exercised."""
    for key, node in params.items():
        if "scale" in node:
            n = node["scale"].shape[0]
            node["scale"] = (rng.rand(n) + 0.5).astype(np.float32)
            node["bias"] = (rng.randn(n) * 0.1).astype(np.float32)
            stats[key]["mean"] = (rng.randn(n) * 0.1).astype(np.float32)
            stats[key]["var"] = (rng.rand(n) + 0.5).astype(np.float32)
        elif "kernel" not in node:
            randomize_bn(node, stats[key], rng)
