"""Shared helpers of the tests/test_torch_*.py port-parity tests."""

import contextlib

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


def seeded_jax_variables(module, x, seed):
    """A flax module's variables for input ``x`` filled from a numpy seed:
    the tree's structure from ``jax.eval_shape`` of its ``init`` (no
    initializer runs, so no per-shape compile), every leaf drawn in the
    tree's flattened order: kernels normal with variance 2 / fan_in, biases
    normal x 0.1, BatchNorm scale in [0.5, 1.5), mean normal x 0.1 and var
    in [0.5, 1.5) (random statistics, so a misplaced one shows)."""
    import jax

    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(
        lambda k: module.init({"params": k, "dropout": k, "stochastic_depth": k}, x, False),
        key)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = max(int(np.prod(shape[:-1])), 1)
            return (rng.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return (rng.rand(*shape) + 0.5).astype(np.float32)
        return (rng.randn(*shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def jax_reference(jbundle, x, seed=0):
    """The JAX package's side of a model parity test, cheaply: seeded
    variables (:func:`seeded_jax_variables`) and one jitted eval-mode
    forward of ``x`` -> ``(variables, logits)``."""
    import jax
    import jax.numpy as jnp

    x = jnp.asarray(x)
    variables = seeded_jax_variables(jbundle.module, x[:1], seed)
    return variables, np.asarray(jax.jit(jbundle.logits)(variables, x))


def jax_traced(module, x):
    """The JAX model's structure for input ``x``, traced with
    ``jax.eval_shape`` (no compile): ``(variable shapes, Grad-CAM layer
    menu, default layer, randomization stages)``, the menu and default from
    ``saliency/gradient.py``, the stages by ``saliency/sanity.py:
    randomization_stages``' rule (``init``'s top-level params in definition
    order, reversed), read inside the trace where the order still holds."""
    import jax

    from network_interpretation_imagenet_tpu.saliency import gradient as jgrad

    stages = []

    def traced(k):
        v = module.init({"params": k, "dropout": k, "stochastic_depth": k}, x, False)
        stages.append(list(reversed(list(v["params"]))))
        _, state = module.apply(v, x, False, capture_intermediates=True,
                                mutable=["intermediates"])
        return v, state["intermediates"]

    shapes, inter = jax.eval_shape(traced, jax.random.PRNGKey(0))
    menu = [(n, tuple(s)) for n, s in jgrad._layer_menu(inter)]
    return dict(shapes), menu, jgrad._default_gradcam_layer(menu), stages[0]


def calibrate_bn(bundle, state_dict, images):
    """``state_dict`` with every BatchNorm's running statistics set to the
    batch statistics of ``images`` (NHWC f32 numpy) in a train-mode forward
    of the port's module, so that a random net's predictions depend on its
    input (with random statistics its softmax saturates on one class)."""
    import copy

    import torch

    from network_interpretation_imagenet_tpu_torch.models import load_weights

    net = load_weights(copy.deepcopy(bundle.module), state_dict)
    for m in net.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = 1.0
    with torch.no_grad():
        net.train()(torch.from_numpy(images))
    return {k: v.clone() for k, v in net.state_dict().items()}


def serving_mnist():
    """The serving tests' MNIST CNN (port bundle, state dict), image and
    16-block segments, and 64 window starts: the seeded weights with
    BatchNorm statistics measured on the image's width-4 window-masked
    copies, so masked predictions move (4 and 2 on these masks)."""
    import torch

    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.ops.masked_batch import masked_batch_plain

    rng = np.random.RandomState(1)
    idx = np.arange(28) // 7
    segments = (idx[:, None] * 4 + idx[None, :]).astype(np.int32)
    image = rng.rand(28, 28, 1).astype(np.float32)
    firsts = rng.randint(0, 13, size=64).astype(np.int32)
    masked = masked_batch_plain(torch.from_numpy(image), torch.from_numpy(segments),
                                torch.from_numpy(firsts), 4, torch.float32).numpy()
    bundle = create_model("mnist_cnn", "mnist")
    return bundle, calibrate_bn(bundle, bundle.init(1), masked), image, segments, firsts


@contextlib.contextmanager
def torch_threads(n=1):
    """``n`` torch threads within the block: pytest-xdist's workers each
    default to every core, and small ops then spend their time contending
    (a CPU training loop ran 150x slower under the tier-1 run than alone)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)
