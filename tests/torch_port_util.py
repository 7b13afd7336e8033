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


def flax_resnet_variables(state_dict, stage_sizes):
    """A torchvision-keyed ResNet ``state_dict`` (numpy or torch values;
    BasicBlock or Bottleneck, told apart by ``conv3``) as the JAX package's
    flax variables: conv OIHW -> HWIO, dense
    [out, in] -> [in, out], BatchNorm weight / bias / running statistics ->
    scale / bias and batch_stats mean / var. Cheaper in a test than flax's
    ``init``, which compiles every initializer."""
    params, stats = {}, {}
    sd = {k: np.asarray(v, np.float32) for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def put(tree, path, name, value):
        for p in path:
            tree = tree.setdefault(p, {})
        tree[name] = value

    def conv(torch_name, *path):
        put(params, path, "kernel", np.transpose(sd[torch_name + ".weight"], (2, 3, 1, 0)))

    def bn(torch_name, *path):
        put(params, path, "scale", sd[torch_name + ".weight"])
        put(params, path, "bias", sd[torch_name + ".bias"])
        put(stats, path, "mean", sd[torch_name + ".running_mean"])
        put(stats, path, "var", sd[torch_name + ".running_var"])

    conv("conv1", "conv1")
    bn("bn1", "bn1")
    for s, n in enumerate(stage_sizes, start=1):
        for b in range(n):
            tp, fp = f"layer{s}.{b}", f"layer{s}_{b}"
            for c in (1, 2, 3) if f"{tp}.conv3.weight" in sd else (1, 2):
                conv(f"{tp}.conv{c}", fp, f"conv{c}")
                bn(f"{tp}.bn{c}", fp, f"bn{c}")
            if f"{tp}.downsample.0.weight" in sd:
                conv(f"{tp}.downsample.0", fp, "downsample_conv")
                bn(f"{tp}.downsample.1", fp, "downsample_bn")
    put(params, ("fc",), "kernel", sd["fc.weight"].T.copy())
    put(params, ("fc",), "bias", sd["fc.bias"])
    return {"params": params, "batch_stats": stats}
