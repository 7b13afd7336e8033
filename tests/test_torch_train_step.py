"""The port's train step (``parallel/train_step.py``), its optimizers and lr
schedule (``train/harness.py``) and the models' train mode against the JAX
package's, f32 on the CPU.

Both packages take the same batches. The first step starts from the same
parameters (the port's init, carried into the JAX step with
``utils.convert.jax_variables``) and a fresh optimizer state; the third from
the JAX step's state after its second, carried into the port (parameters,
statistics and the optimizer's slots and count, ``opt_state_from_jax``), so
that rounding differences do not compound: a ReLU whose input sits within
rounding of 0 can pass or stop a gradient, and in a deep net at a small
batch one such flip moves a step by a percent. After each, the loss, top-1
and top-5 and every parameter and BatchNorm statistic are held to the JAX
step's. The lr schedule's boundary sits after the second step, so the third
runs at the decayed rate. Tolerances, f32 throughout:

- loss within 1e-5 relative, top-1 and top-5 exact;
- parameters and statistics within 1e-5 absolute, with two exceptions
  under the adaptive optimizers. The biases of convolutions that feed a
  BatchNorm have a gradient of exactly 0 in theory (the BatchNorm subtracts
  them), so their computed gradient is rounding noise, which Adam and
  RMSprop scale to a step of up to (1 - b1) / sqrt(1 - b2) = sqrt(10) lr
  either way: they are held only to within 7 lr (they do not change the
  net's output). And Adam's first steps move every element by about lr
  whatever the gradient's size, so an element whose gradient is near
  rounding level may move either way: under Adam each other tensor has at
  most 1 in 1,000 of its elements outside 1e-5, and all within 2 lr (read:
  1 or 2 elements of 36,864 and 147,456, off by up to 2.2e-4 at lr 1e-3).

Draws: the CIFAR ResNet's stochastic depth and DenseNet-BC's dropout take
the JAX step's own decisions (``Draws(injected=...)``), read from the JAX
module's calls under the step's PRNG keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist
from torch_port_util import torch_threads
from flax import linen as fnn
from jax.sharding import NamedSharding, PartitionSpec

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.config import TrainConfig as JaxTrainConfig
from network_interpretation_imagenet_tpu.models import densenet as jdensenet
from network_interpretation_imagenet_tpu.models import resnet_cifar as jresnet_cifar
from network_interpretation_imagenet_tpu.parallel import make_mesh
from network_interpretation_imagenet_tpu.parallel import train_step as jtrain_step
from network_interpretation_imagenet_tpu.train import harness as jharness
from network_interpretation_imagenet_tpu_torch.config import TrainConfig
from network_interpretation_imagenet_tpu_torch.models import ModelBundle, create_model
from network_interpretation_imagenet_tpu_torch.models.common import Draws
from network_interpretation_imagenet_tpu_torch.models.densenet import create_densenet
from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
from network_interpretation_imagenet_tpu_torch.parallel import make_mesh as make_port_mesh
from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
from network_interpretation_imagenet_tpu_torch.train import harness
from network_interpretation_imagenet_tpu_torch.utils import convert

STEPS_PER_EPOCH = 2   # with decay_epochs=(1,): the boundary is step 2, the third step's
LOSS_RTOL = 1e-5
ATOL = 1e-5
ADAM_OFF_SHARE = 1e-3   # under Adam, the share of a tensor's elements outside ATOL
HISTORY_RTOL = 1e-4     # a Trainer's rounded history, meshless vs a mesh of one rank


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _cfg(kind, lr, wd=1e-3):
    return dict(optimizer=kind, lr=lr, momentum=0.9, weight_decay=wd, decay_epochs=(1,),
                decay_rate=0.1)


def _pair(bundle, jbundle, cfg, state_dict=None):
    """The port's (init_fn, state, step_fn, optimizer) and the JAX step's
    (state, step_fn) from the same parameters. The JAX state is placed as
    its step's outputs are, so the step compiles once."""
    opt = harness.make_optimizer(TrainConfig(**cfg), STEPS_PER_EPOCH)
    init, step = make_sharded_train_step(bundle, None, opt, device="cpu")
    state = init(0, state_dict)
    sd = {k: v.detach().clone() for k, v in {**state.params, **state.buffers}.items()}
    jopt = jharness.make_optimizer(JaxTrainConfig(**cfg), STEPS_PER_EPOCH)
    mesh = make_mesh(jax.devices()[:1])
    _, jstep = jtrain_step.make_sharded_train_step(jbundle, mesh, jopt)
    v = convert.jax_variables(sd, bundle.module)
    params = jax.tree.map(jnp.array, v["params"])
    jstate = jtrain_step.TrainState(
        params=params, batch_stats=jax.tree.map(jnp.array, v.get("batch_stats", {})),
        opt_state=jopt.init(params), step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))
    jstate = jax.device_put(jstate, NamedSharding(mesh, PartitionSpec()))
    return init, state, step, opt, jstate, jstep


def _carry(bundle, init, opt, jstate):
    """The JAX step's state as the port's: parameters and statistics through
    ``convert.from_jax``, the optimizer's slots and count through
    ``harness.opt_state_from_jax``."""
    host = jax.tree.map(np.array, {"params": jstate.params, "batch_stats": jstate.batch_stats})
    state = init(0, convert.from_jax(host, bundle.module))
    fields = {}
    states = jax.tree_util.tree_leaves(jstate.opt_state, is_leaf=lambda n: hasattr(n, "_fields"))
    for node in states:
        for name in getattr(node, "_fields", ()):
            fields.setdefault(name, jax.tree.map(np.array, getattr(node, name)))
    slots = {k: fields[k] for k in harness.SLOTS[opt.kind]}
    return state._replace(opt_state=harness.opt_state_from_jax(
        opt, int(fields["count"]), slots, bundle.module, state.params))


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check(bundle, state, metrics, jstate, jmetrics, kind="sgd", lr=0.0):
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=LOSS_RTOL if k == "loss" else 0, err_msg=k)
    got = convert.jax_variables({**state.params, **state.buffers}, bundle.module)
    for tree in ("params", "batch_stats"):
        want = _leaves(jstate.params if tree == "params" else jstate.batch_stats)
        have = _leaves(got.get(tree, {}))
        assert sorted(have) == sorted(want)
        for name, w in want.items():
            tol = ATOL   # the adaptive optimizers' exceptions: the module docstring
            if kind != "sgd" and "Conv_0']['bias" in name:   # a BatchNorm-fed bias
                tol = 7 * lr
            elif kind == "adam" and tree == "params":
                tol = 2 * lr
                off = np.abs(have[name] - w) > ATOL
                assert off.mean() <= ADAM_OFF_SHARE, (f"{tree}{name}", off.sum(), off.size)
            np.testing.assert_allclose(have[name], w, rtol=0, atol=tol, err_msg=f"{tree}{name}")


def _batches(n, size, channels, classes, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, size, size, channels).astype(np.float32),
             rng.randint(0, classes, batch)) for _ in range(n)]


def _run(bundle, jbundle, cfg, batches, draws_of=None):
    """Steps 1 and 3 against the JAX step's: step 1 from the same init, step 3
    from the JAX step's state after step 2 carried into the port."""
    init, state, step, opt, jstate, jstep = _pair(bundle, jbundle, cfg)
    for i, (x, y) in enumerate(batches):
        if i == 2:
            state = _carry(bundle, init, opt, jstate)
        draws = draws_of(jstate, x) if draws_of else None
        state, m = step(state, x, y, draws)
        jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        if i in (0, 2):
            _check(bundle, state, m, jstate, jm, cfg["optimizer"], cfg["lr"])
    assert state.opt_state["count"] == 3


@pytest.mark.parametrize("kind,lr", [("sgd", 0.05), ("adam", 1e-3), ("rmsprop", 1e-3)])
def test_mnist_cnn_steps_match_jax(kind, lr):
    bundle, jbundle = create_model("mnist_cnn", "mnist"), jmodels.create_model("mnist_cnn", "mnist")
    _run(bundle, jbundle, _cfg(kind, lr), _batches(3, 28, 1, 10))


def test_resnet18_sgd_steps_match_jax():
    """ResNet-18 at 32^2 with 4 classes (its BasicBlocks, projection
    shortcuts and the stem's max pool in training)."""
    bundle = create_model("resnet18", "imagenet", num_classes=4)
    jbundle = jmodels.create_model("resnet18", "imagenet", num_classes=4)
    _run(bundle, jbundle, _cfg("sgd", 0.05), _batches(3, 32, 3, 4))


def _outputs(module, kinds):
    """A jitted train-mode apply that returns the output of every call of a
    submodule of ``kinds``: ``f(variables, x, rngs) -> {path: output}``."""
    def run(variables, x, rngs):
        _, state = module.apply(variables, x, True, rngs=rngs, mutable=["batch_stats"],
                                capture_intermediates=lambda m, _: isinstance(m, kinds))
        flat = jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]
        return {"/".join(k.key for k in path[:-2]): out for path, out in flat}
    return jax.jit(run)


def _step_rngs(jstate):
    """The PRNG keys the JAX step draws with (``train_step.py:96``)."""
    _, sd_rng, drop_rng = jax.random.split(jstate.rng, 3)
    return {"stochastic_depth": sd_rng, "dropout": drop_rng}


def test_cifar_resnet_stochastic_depth_matches_jax():
    """ResNet-8 (cifar10+) with linear death rates: the JAX step's alive
    flags injected (a block is dead where its output is its shortcut). A dead
    block returns its shortcut as it is, and its branch's BatchNorm
    statistics are still updated: every statistic, dead blocks' included, is
    held within 1e-5."""
    bundle = create_model("resnet", "cifar10+", depth=8, death_mode="linear", death_rate=0.5)
    jbundle = jmodels.create_model("resnet", "cifar10+", depth=8, death_mode="linear",
                                   death_rate=0.5)
    outputs = _outputs(jbundle.module, (jresnet_cifar.BasicBlockStochastic,
                                        jresnet_cifar.DownsampleB, fnn.BatchNorm))
    flags = []

    def draws_of(jstate, x):
        outs = outputs({"params": jstate.params, "batch_stats": jstate.batch_stats},
                       jnp.asarray(x), _step_rngs(jstate))
        alive, prev = {}, np.maximum(np.asarray(outs["bn1"]), 0)   # the stem's output
        for stage in (1, 2, 3):
            path = f"layer{stage}_0"
            out = np.asarray(outs[path])
            shortcut = np.asarray(outs.get(path + "/downsample", prev))
            alive[f"layer{stage}.0"] = not np.array_equal(out, shortcut)
            prev = out
        flags.append(alive)
        return Draws(injected=alive)

    _run(bundle, jbundle, _cfg("sgd", 0.05), _batches(3, 32, 3, 10), draws_of=draws_of)
    decided = [a for f in flags for a in f.values()]
    assert len(decided) == 9 and 0 < sum(decided) < 9, flags


def test_densenet_dropout_matches_jax():
    """DenseNet-BC depth 10 with drop_rate 0.2 (each dense layer's new
    features): the JAX step's dropout masks injected (kept where its output
    is not 0)."""
    module = create_densenet("cifar10", depth=10, num_classes=4, drop_rate=0.2)
    bundle = ModelBundle("densenet", module, 32, 3, 4)
    jmodule = jdensenet.create_densenet("cifar10", depth=10, num_classes=4, drop_rate=0.2)
    jbundle = jmodels.ModelBundle("densenet", jmodule, 32, 3, 4)
    outputs = _outputs(jmodule, (fnn.Dropout,))
    dropped = []

    def draws_of(jstate, x):
        outs = outputs({"params": jstate.params, "batch_stats": jstate.batch_stats},
                       jnp.asarray(x), _step_rngs(jstate))
        masks = {}
        for path, out in outs.items():
            block, layer = path.split("/")[0].split("_layer")
            out = np.asarray(out)
            masks[f"features.{block}.denselayer{layer}.drop"] = torch.from_numpy(
                out != 0).permute(0, 3, 1, 2)
            dropped.append(float((out == 0).mean()))
        return Draws(injected=masks)

    _run(bundle, jbundle, _cfg("sgd", 0.05), _batches(3, 32, 3, 4), draws_of=draws_of)
    assert len(dropped) == 9 and 0.1 < np.mean(dropped) < 0.3


@pytest.mark.parametrize("kind", ["sgd", "adam", "rmsprop"])
def test_optimizer_update_is_optax(kind):
    """The optimizers alone, on the same gradients (spread over six decades)
    for four steps across the schedule's boundary: within 2 f32 ulps of
    optax's chain."""
    rng = np.random.RandomState(0)
    cfg = _cfg(kind, 1e-2)
    jopt = jharness.make_optimizer(JaxTrainConfig(**cfg), STEPS_PER_EPOCH)
    opt = harness.make_optimizer(TrainConfig(**cfg), STEPS_PER_EPOCH)
    p0 = rng.randn(500).astype(np.float32)
    jp = {"w": jnp.asarray(p0)}
    jstate = jopt.init(jp)
    params = {"w": torch.from_numpy(p0.copy())}
    state = opt.init(params)
    for _ in range(4):
        g = (rng.randn(500) * 10.0 ** rng.uniform(-6, 0, 500)).astype(np.float32)
        updates, jstate = jopt.update({"w": jnp.asarray(g)}, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update([torch.from_numpy(g)], state, list(params.values()))
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]), rtol=0,
                                   atol=2 * np.spacing(np.float32(np.abs(p0).max() * 2)))
    assert state["count"] == 4


@pytest.mark.parametrize("boundary_epoch", [1, 30])
def test_lr_schedule_at_the_boundary(boundary_epoch):
    """The rate at 0-based steps b-1, b and b+1 equals optax's schedule in
    f32 (the first step of the boundary's epoch is the first at the decayed
    rate), here with the stock 0.1 / 10 at epochs 30 and 60."""
    spe = 7
    cfg = dict(optimizer="sgd", lr=0.1, decay_epochs=(boundary_epoch, 60), decay_rate=0.1)
    schedule = harness.lr_schedule(TrainConfig(**cfg), spe)
    jschedule = optax.piecewise_constant_schedule(
        0.1, {e * spe: 0.1 for e in (boundary_epoch, 60)})
    b = boundary_epoch * spe
    for k in (b - 1, b, b + 1, 60 * spe):
        assert np.float32(schedule(k)) == np.asarray(jschedule(jnp.int32(k)), np.float32), k
    assert schedule(b - 1) == pytest.approx(0.1) and schedule(b) == pytest.approx(0.01)


def test_batchnorm_updates_running_variance_with_the_biased_variance():
    """One train-mode forward at B=8, 7x7: running_var moves toward the
    biased batch variance (flax), not the unbiased one (n / (n - 1) =
    1.0026 larger here), and the output is normalized by batch statistics."""
    from network_interpretation_imagenet_tpu_torch.models.common import BatchNorm2d

    bn = BatchNorm2d(3).train()
    x = torch.randn(8, 3, 7, 7, generator=torch.Generator().manual_seed(0)) * 2 + 1
    y = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var, rtol=0, atol=1e-6)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, rtol=0, atol=1e-6)
    assert not torch.allclose(bn.running_var, 0.9 + 0.1 * var * 392 / 391, rtol=0, atol=1e-5)
    torch.testing.assert_close(y.mean(dim=(0, 2, 3)), torch.zeros(3), rtol=0, atol=1e-5)
    assert list(bn.state_dict()) == ["weight", "bias", "running_mean", "running_var",
                                     "num_batches_tracked"]


@pytest.fixture
def world1():
    """A gloo world of one, started by ``make_mesh`` and destroyed after."""
    assert not dist.is_initialized()
    mesh = make_port_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["mnist_cnn", "resnet18"])
def test_mesh_of_world_1_equals_the_meshless_step(world1, arch):
    """A step on a mesh of one rank (its collectives run: BatchNorm's
    statistics and the gradients summed over the one rank, the statistics
    by flax's E[x^2] - E[x]^2) against the meshless step from the same
    parameters: the loss within LOSS_RTOL, top-1 and top-5 exactly,
    parameters and statistics within ATOL; and a Trainer on the mesh (its
    default globalize) fits the meshless Trainer's history over 4 steps at
    lr 0.01 within HISTORY_RTOL on the losses (rounded to 5 decimals, and
    the two variance formulas' rounding compounds from step 2 on, as in
    the CLI histories of tests/test_torch_train_harness.py, held alike),
    error rates exactly."""
    size, channels = (28, 1) if arch == "mnist_cnn" else (32, 3)
    bundle = create_model(arch, "mnist" if arch == "mnist_cnn" else "imagenet",
                          num_classes=None if arch == "mnist_cnn" else 4)
    cfg = TrainConfig(**_cfg("sgd", 0.05))
    sd = bundle.init(0)
    runs = []
    for mesh in (None, world1):
        init, step = make_sharded_train_step(bundle, mesh, harness.make_optimizer(cfg, 2),
                                             device="cpu")
        x, y = _batches(1, size, channels, 4)[0]
        state, m = step(init(0, sd), x, y)
        runs.append((state, [{k: float(v) for k, v in m.items()}]))
    (plain, plain_m), (meshed, meshed_m) = runs
    for got, want in zip(meshed_m, plain_m):
        assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    for k, t in {**plain.params, **plain.buffers}.items():
        other = {**meshed.params, **meshed.buffers}[k]
        np.testing.assert_allclose(other.detach().float().numpy(), t.detach().float().numpy(),
                                   rtol=0, atol=ATOL, err_msg=k)
    x, y = _batches(1, size, channels, 4, batch=32)[0]
    rows = [harness.Trainer(bundle, TrainConfig(lr=0.01, epochs=2), 2, mesh=mesh,
                            device="cpu").fit(ArrayLoader(x, y, 16), ArrayLoader(x, y, 16))
            for mesh in (None, world1)]
    for got, want in zip(rows[1], rows[0]):
        for k, v in want.items():
            if "loss" in k:
                np.testing.assert_allclose(got[k], v, rtol=HISTORY_RTOL, err_msg=k)
            else:
                assert got[k] == v, k
