"""The port's multi-process training (``parallel/train_step.py`` on a mesh,
``train/harness.py``'s ``mesh``, ``globalize`` and ``eval_local_metrics``,
``cli.main --multihost``) against the JAX package's, f32 on the CPU.

The JAX step is one jitted program over the global batch on a mesh of the
tests' 8 virtual CPU devices: data parallel 8, and data 4 x model 2. The
port's runs in one spawned 2-rank gloo world (tests/torch_parallel_train_
worker.py, which imports only the port): each rank steps its 8 rows of the
global batch of 16 on the data-axis mesh (2, 1), or all 16 on the
model-axis mesh (1, 2), where each rank keeps half of every parameter with
at least 32 output channels. Both start from the same parameters (the
port's init carried into JAX with ``utils.convert.jax_variables``) and a
fresh SGD state (lr 0.01, momentum 0.9). The nets: ResNet-18 at 32^2 (BatchNorm, whose statistics must be the global
batch's), DenseNet-BC depth 10 with dropout 0.2 (JAX's global-batch keep
masks injected, each rank slicing its rows) and the CIFAR ResNet-8 with
linear stochastic depth (JAX's alive flags injected).

Tolerances (f32 where f64 is not named):

- step 1 against the JAX mesh step and against the port's own step on a
  mesh of one rank (the same program, the statistics and gradients summed
  over one rank; tests/test_torch_train_step.py holds that against the
  meshless step): loss within LOSS_RTOL = 1e-5 relative, top-1 and top-5
  exactly, every parameter and BatchNorm statistic within ATOL = 1e-5 (the
  single-device bounds of tests/test_torch_train_step.py). A parameter's
  error after one step is lr times its gradient's: at lr 0.01 the bound
  holds each gradient element within 1e-3 only, so step 1's gradients
  (SGD's trace) are also held parameter by parameter, in relative L2,
  against the port's 1-rank step in f64: the 2-rank step's in f64 within
  GRAD64_RTOL = 1e-9 (a cross-rank term missing anywhere in BatchNorm's
  backward moves a leaf by far more), and its f32 ones within GRAD_RTOL =
  1e-4 or, where JAX's own f32 gradient lies further from f64, within
  GRAD_VS_JAX = 2 x JAX's error. Those are the leaves whose gradient
  cancels (a BatchNorm scale or a conv before a BatchNorm that a later
  BatchNorm normalizes away: DenseNet's first BatchNorm scale, 0.04 from
  f64 in the port's f32 and 0.08-0.11 in JAX's), and DenseNet's first layers on
  JAX's data 4 x model 2, 4e-3 from f64 in JAX's f32 and 6e-6 in the
  port's;
- "runs and learns" (the JAX test): from the same state, five steps at lr
  0.03 drawing from the generator on every rank, and the loss on the
  fixed batch falls;
- a 2-rank ``Trainer`` cut mid-epoch and resumed equals the uninterrupted
  2-rank run bit for bit (gloo and the CPU kernels are deterministic),
  and a model-axis ``Trainer`` resumed from its checkpoint holds the same
  whole tensors; both hold the single-process Trainer's history within
  CLI_RTOL on losses, error rates exactly;
- ``cli.main --multihost`` on two processes against one process, as
  tests/test_imagenet_train.py holds the JAX CLI: losses within CLI_RTOL
  = 5e-3 relative, ``val_err1`` exactly (10 val images, a tail of 2 that
  fills no global batch of 8), and only rank 0 writes ``scores.tsv`` and
  the result.

Every spawn ends within its ``communicate`` timeout, so a hang fails one
test."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from flax import linen as fnn
from jax.sharding import NamedSharding, PartitionSpec
from torch_parallel_train_worker import build_bundle
from torch_port_util import torch_threads

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import main as jmain
from network_interpretation_imagenet_tpu.config import TrainConfig as JaxTrainConfig
from network_interpretation_imagenet_tpu.models import densenet as jdensenet
from network_interpretation_imagenet_tpu.parallel import make_mesh as jmake_mesh
from network_interpretation_imagenet_tpu.parallel import train_step as jtrain_step
from network_interpretation_imagenet_tpu.train import harness as jharness
from network_interpretation_imagenet_tpu_torch.cli import main as pmain
from network_interpretation_imagenet_tpu_torch.config import TrainConfig
from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
from network_interpretation_imagenet_tpu_torch.data.synthetic import (
    synthetic_classification_batch,
)
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.models.common import Draws
from network_interpretation_imagenet_tpu_torch.parallel import make_mesh, make_sharded_train_step
from network_interpretation_imagenet_tpu_torch.train import Trainer, harness
from network_interpretation_imagenet_tpu_torch.utils import convert

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SPAWN_TIMEOUT_S = 300
LOSS_RTOL = 1e-5
ATOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_VS_JAX = 2.0
GRAD64_RTOL = 1e-9
CLI_RTOL = 5e-3
NETS = ("resnet18", "densenet_dropout", "cifar_resnet_sd")
CLASSES = {"resnet18": 4, "densenet_dropout": 4, "cifar_resnet_sd": 10}
CFG = dict(optimizer="sgd", lr=0.01, momentum=0.9, weight_decay=0.0)
LEARN_CFG = dict(CFG, lr=0.03)   # at 0.1 (tests/test_parallel.py) ResNet-18's loss first rises
GLOBAL_BATCH = 16
CLI_ARGV = ["-a", "resnet18", "--crop", "32", "-b", "8", "--epochs", "2", "--lr", "0.01",
            "-j", "2", "--seed", "0", "--device", "cpu", "-p", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _jax_bundle(net):
    if net == "resnet18":
        return jmodels.create_model("resnet18", "imagenet", num_classes=4)
    if net == "densenet_dropout":
        return jmodels.ModelBundle("densenet", jdensenet.create_densenet(
            "cifar10", depth=10, num_classes=4, drop_rate=0.2), 32, 3, 4)
    return jmodels.create_model("resnet", "cifar10+", depth=8, death_mode="linear",
                                death_rate=0.5)


def _outputs(module, kinds):
    """A jitted train-mode apply returning the output of every call of a
    submodule of ``kinds``: ``f(variables, x, rngs) -> {path: output}``."""
    def run(variables, x, rngs):
        _, state = module.apply(variables, x, True, rngs=rngs, mutable=["batch_stats"],
                                capture_intermediates=lambda m, _: isinstance(m, kinds))
        flat = jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]
        return {"/".join(k.key for k in path[:-2]): out for path, out in flat}
    return jax.jit(run)


def _jax_draws(net, jbundle, variables, x, key):
    """The decisions of the JAX step's draws (``train_step.py:96``), read from
    one unsharded train-mode apply under the step's keys: DenseNet's keep
    masks at the global batch's shape (NCHW), the CIFAR ResNet's alive
    flags (a block is dead where its output is its shortcut)."""
    _, sd_rng, drop_rng = jax.random.split(key, 3)
    rngs = {"stochastic_depth": sd_rng, "dropout": drop_rng}
    if net == "densenet_dropout":
        outs = _outputs(jbundle.module, (fnn.Dropout,))(variables, x, rngs)
        masks = {}
        for path, out in outs.items():
            block, layer = path.split("/")[0].split("_layer")
            masks[f"features.{block}.denselayer{layer}.drop"] = torch.from_numpy(
                np.asarray(out) != 0).permute(0, 3, 1, 2)
        return masks
    if net == "cifar_resnet_sd":
        from network_interpretation_imagenet_tpu.models import resnet_cifar as jresnet_cifar

        outs = _outputs(jbundle.module, (jresnet_cifar.BasicBlockStochastic,
                                         jresnet_cifar.DownsampleB, fnn.BatchNorm))(
            variables, x, rngs)
        alive, prev = {}, np.maximum(np.asarray(outs["bn1"]), 0)   # the stem's output
        for stage in (1, 2, 3):
            path = f"layer{stage}_0"
            out = np.asarray(outs[path])
            shortcut = np.asarray(outs.get(path + "/downsample", prev))
            alive[f"layer{stage}.0"] = not np.array_equal(out, shortcut)
            prev = out
        return alive
    return {}


def _case(net, model_parallel, seed, mesh1):
    """One step case: the inputs the ranks get, the JAX mesh step's step 1
    and the port's step 1 on ``mesh1`` (one rank) on the same draws."""
    bundle, jbundle = build_bundle(net), _jax_bundle(net)
    sd = bundle.init(seed)
    rng = np.random.RandomState(seed)
    x = rng.rand(GLOBAL_BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, CLASSES[net], GLOBAL_BATCH)
    jmesh = jmake_mesh(model_parallel=model_parallel)
    assert dict(jmesh.shape) == {"data": 8 // model_parallel, "model": model_parallel}
    jopt = jharness.make_optimizer(JaxTrainConfig(**CFG), 1000)
    _, jstep = jtrain_step.make_sharded_train_step(jbundle, jmesh, jopt)
    v = convert.jax_variables(sd, bundle.module)
    params = jax.device_put(jax.tree.map(jnp.asarray, v["params"]),
                            jtrain_step.param_shardings(v["params"], jmesh))
    stats = jax.device_put(jax.tree.map(jnp.asarray, v.get("batch_stats", {})),
                           NamedSharding(jmesh, PartitionSpec()))
    key = jax.random.PRNGKey(seed)
    injected = _jax_draws(net, jbundle, {"params": v["params"], "batch_stats": stats},
                          jnp.asarray(x), key)
    jstate = jtrain_step.TrainState(params=params, batch_stats=stats,
                                    opt_state=jopt.init(params),
                                    step=jnp.zeros((), jnp.int32), rng=key)
    jstate, jm = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32))
    host = jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})
    (trace,) = [node.trace for node in jax.tree_util.tree_leaves(
        jstate.opt_state, is_leaf=lambda n: hasattr(n, "_fields")) if hasattr(node, "trace")]
    sharded = sum(int(np.prod(leaf.shape)) for leaf, spec in zip(
        jax.tree_util.tree_leaves(v["params"]),
        jax.tree_util.tree_leaves(jtrain_step.param_shardings(v["params"], jmesh)))
        if "model" in spec.spec)
    # The port's 1-rank step: the same draws at the same global batch.
    init, step = make_sharded_train_step(bundle, mesh1, harness.make_optimizer(
        TrainConfig(**CFG), 1000), device="cpu")
    state, m = step(init(0, sd), x, y, Draws(injected=injected))
    sd64 = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
    state64, _ = step(init(0, sd64), x.astype(np.float64), y, Draws(injected=injected))
    return {
        "inputs": {"net": net, "model_parallel": model_parallel, "cfg": CFG,
                   "learn_cfg": LEARN_CFG,
                   "state_dict": sd, "x": x, "y": y, "injected": injected},
        "jax": {"metrics": {k: float(jm[k]) for k in ("loss", "top1", "top5")},
                "variables": convert.from_jax(host, bundle.module),
                "grads": convert.from_jax({"params": jax.tree.map(np.asarray, trace)},
                                          bundle.module)},
        "one_rank": {"metrics": {k: float(t) for k, t in m.items()},
                     "variables": {k: t.detach().clone() for k, t in
                                   {**state.params, **state.buffers}.items()},
                     "grads": {k: t.detach().clone()
                               for k, t in state.opt_state["trace"].items()},
                     "grads64": {k: t.detach().clone()
                                 for k, t in state64.opt_state["trace"].items()}},
        "sharded_numel": sharded,
        "draws": injected,
    }


def _write_image_folder(root, classes, per_class, size=48):
    """Separable classes of PNGs: class c has stripe c maxed."""
    from PIL import Image

    rs = np.random.RandomState(0)
    for c in range(classes):
        d = os.path.join(root, f"class_{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            arr = rs.randint(0, 255, (size, size, 3), np.uint8)
            arr[:, c * 8:c * 8 + 8] = 255 if c else 0
            Image.fromarray(arr).save(os.path.join(d, f"img_{i}.png"))


def _result(save):
    with open(os.path.join(save, "imagenet_train_result.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The step cases (with the JAX references and the port's 1-rank
    steps), the Trainer's data and its single-process run, and the CLI's
    image folder (12 train images, 10 val) with its single-process run."""
    d = tmp_path_factory.mktemp("parallel_train")
    assert not dist.is_initialized()
    mesh1 = make_mesh(device="cpu")   # a gloo world of one, destroyed below
    try:
        cases = {f"{net}-mp{mp}": _case(net, mp, seed, mesh1) for seed, (net, mp) in
                 enumerate((net, mp) for net in NETS for mp in (1, 2))}
    finally:
        dist.destroy_process_group()
    x, y = synthetic_classification_batch(0, 80, 32, 3, 10)
    single = Trainer(create_model("resnet", "cifar10+", depth=8, death_mode="linear"),
                     TrainConfig(lr=0.05, epochs=3, seed=0), steps_per_epoch=5, device="cpu")
    single_rows = single.fit(ArrayLoader(x, y, 16, shuffle=True), ArrayLoader(x[-32:], y[-32:],
                                                                             16))
    data = d / "imagenet"
    _write_image_folder(str(data / "train"), classes=2, per_class=6)
    _write_image_folder(str(data / "val"), classes=2, per_class=5)
    assert pmain.main([str(data)] + CLI_ARGV + ["--save", str(d / "cli_single")]) == 0
    torch.save({"cases": {k: c["inputs"] for k, c in cases.items()}, "trainer_x": x,
                "trainer_y": y, "cli_argv": [str(data)] + CLI_ARGV + ["--save",
                                                                       str(d / "cli_multi")]},
               d / "inputs.pt")
    return d, cases, single_rows, _result(str(d / "cli_single"))


@pytest.fixture(scope="module")
def world2(setup):
    """Runs tests/torch_parallel_train_worker.py as ranks 0 and 1 of a gloo
    world, once for every test below."""
    d = setup[0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_parallel_train_worker.py"),
                               "--rank", str(r), "--port", str(port), "--dir", str(d)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-6000:]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _check_step(got, want, what):
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=LOSS_RTOL if k == "loss" else 0, err_msg=f"{what} {k}")
    have = {k: v for k, v in got["variables"].items() if not k.endswith("num_batches_tracked")}
    assert sorted(have) == sorted(k for k in want["variables"]
                                  if not k.endswith("num_batches_tracked"))
    for k, t in have.items():
        np.testing.assert_allclose(t.numpy(), want["variables"][k].numpy(), rtol=0, atol=ATOL,
                                   err_msg=f"{what} {k}")


def _rel(got, want):
    """Relative L2 error of one tensor (0 where both are 0)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _check_grads(got, case, what):
    """Step 1's gradients, parameter by parameter, against the port's 1-rank
    step in f64: the 2-rank f64 gradients within GRAD64_RTOL; the 2-rank
    f32 gradients within GRAD_RTOL, or within GRAD_VS_JAX x JAX's own f32
    error where JAX's sits further from f64 (leaves whose gradient cancels:
    a BatchNorm scale that a later BatchNorm makes moot)."""
    ref = case["one_rank"]["grads64"]
    assert sorted(got["grads"]) == sorted(got["grads64"]) == sorted(ref)
    for k, g64 in ref.items():
        assert _rel(got["grads64"][k], g64) <= GRAD64_RTOL, (what, k)
        bound = max(GRAD_RTOL, GRAD_VS_JAX * _rel(case["jax"]["grads"][k], g64))
        assert _rel(got["grads"][k], g64) <= bound, (what, k, _rel(got["grads"][k], g64), bound)


@pytest.mark.parametrize("model_parallel", [1, 2])
@pytest.mark.parametrize("net", NETS)
def test_sharded_train_step_runs_and_learns(setup, world2, net, model_parallel):
    """Step 1 of the 2-rank step on the data axis (model_parallel 1) or the
    model axis (2) equals the JAX mesh step's and the port's 1-rank step
    on every rank, its gradients parameter by parameter too; five steps from the same state learn the fixed batch;
    on the model axis each rank holds half of every sharded parameter and
    slot."""
    _, cases, _, _ = setup
    case = cases[f"{net}-mp{model_parallel}"]
    if net == "densenet_dropout":
        kept = np.mean([m.float().mean().item() for m in case["draws"].values()])
        assert len(case["draws"]) == 3 and 0.7 < kept < 0.9, kept
    if net == "cifar_resnet_sd":
        assert len(case["draws"]) == 3
    for rank, out in enumerate(world2):
        got = out["cases"][f"{net}-mp{model_parallel}"]
        _check_step(got, case["jax"], f"rank {rank} vs JAX")
        _check_step(got, case["one_rank"], f"rank {rank} vs the 1-rank step")
        _check_grads(got, case, f"rank {rank}")
        assert np.isfinite(got["losses"]).all() and got["losses"][-1] < got["losses"][0], \
            got["losses"]
        want = got["whole_numel"] - case["sharded_numel"] * (model_parallel - 1) // model_parallel
        assert got["param_numel"] == got["slot_numel"] == want
    if model_parallel == 2:
        assert case["sharded_numel"] > 0


def test_param_shardings_split_head(world2):
    """The MNIST CNN on the model-axis mesh: the port's rule on torch names
    shards exactly the parameters whose JAX leaves JAX's rule shards (a
    tensor of ones where sharded, carried into the JAX layout), conv5's
    128 output channels included, biases replicated."""
    bundle = create_model("mnist_cnn", "mnist")
    for out in world2:
        assert out["meshes"] == {1: [2, 1], 2: [1, 2]}
        shardings = out["mnist_shardings"]
        assert shardings["conv5.0.weight"] == 0 and shardings["conv6.bias"] is None
        assert shardings["fc1.weight"] is None   # 10 output channels: fewer than 32
        sd = {k: (torch.ones_like(v) if shardings.get(k) == 0 else torch.zeros_like(v))
              for k, v in bundle.init(0).items()}
        marked = convert.jax_variables(sd, bundle.module)["params"]
        jvars = convert.jax_variables(bundle.init(0), bundle.module)
        specs = jtrain_step.param_shardings(jvars["params"], jmake_mesh(model_parallel=2))
        leaves = jax.tree_util.tree_flatten_with_path(marked)[0]
        jspecs = jax.tree_util.tree_leaves(specs)
        assert len(leaves) == len(jspecs)
        for (path, leaf), spec in zip(leaves, jspecs):
            assert bool(np.all(leaf == 1)) == ("model" in spec.spec), \
                (jax.tree_util.keystr(path), spec)


def test_unequal_rows_raise_on_every_rank(world2):
    """8 rows on rank 0 and 7 on rank 1: each rank's step raises a
    ValueError saying the global batch must divide evenly (the count rides
    in the gradients' all-reduce, so both ranks see it), as the JAX
    package's ``epoch_batches`` refuses a split that does not divide."""
    for out in world2:
        assert out["unequal"] is not None and "divide evenly" in out["unequal"], out["unequal"]


def _close_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["epoch"] == w["epoch"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=CLI_RTOL, err_msg=k)
        for k in ("train_err1", "val_err1", "val_err5"):
            assert g[k] == pytest.approx(w[k], abs=1e-6), k


def test_trainer_on_a_mesh_resumes_mid_epoch_and_matches_one_process(setup, world2):
    """The data-axis Trainer (default globalize) cut after 3 batches of epoch
    1 and resumed from its save at position 2 equals its uninterrupted run
    bit for bit on both ranks; both follow the single-process Trainer.
    The model-axis Trainer's checkpoint resumes to the same whole tensors."""
    _, _, single_rows, _ = setup
    for out in world2:
        t = out["trainer"]
        assert t["resume_position"] == [True, 1, 2]
        assert t["rows_resumed"][-1] == t["rows"][-1] and len(t["rows_resumed"]) == 2
        for k, v in t["variables"].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, t["variables_resumed"][k]), k
        assert t["trace_equal"] and t["tp_trace_equal"] and t["tp_resumed"]
        _close_rows(t["rows"], single_rows)
        _close_rows(t["tp_rows"], single_rows[:1])
        for k, v in t["tp_variables"].items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(v, t["tp_variables_resumed"][k]), k
    for k, v in world2[0]["trainer"]["variables"].items():
        assert torch.equal(v, world2[1]["trainer"]["variables"][k]), k


def test_two_process_training_matches_single_process(setup, world2):
    """cli.main --multihost on two gloo ranks (ResNet-18 at 32^2, global B=8,
    2 epochs, each rank decoding its 4 rows of every batch, validation
    strided over 10 images) against one process; rank 0 alone wrote the
    scores and the result, and both ranks read the same result."""
    d, _, _, single = setup
    multi = _result(str(d / "cli_multi"))
    assert multi["mode"] == "train" and multi["epochs_run"] == 2
    _close_rows(multi["history"], single["history"])
    rank0, rank1 = (out["cli"] for out in world2)
    assert rank0["rc"] == rank1["rc"] == 0
    assert {"scores.tsv", "imagenet_train_result.json"} <= set(rank0["written"])
    assert rank1["written"] == [], rank1["written"]
    assert os.path.isdir(d / "cli_multi" / "imagenet-resnet18" / "model_best")


def test_rank_slice_and_stride_semantics():
    """_RankSlice drops partial global batches and slices full ones
    contiguously; _RankStride covers every item disjointly; both as the JAX
    CLI's on the same batches."""
    from network_interpretation_imagenet_tpu.cli.main import _RankSlice as JRankSlice
    from network_interpretation_imagenet_tpu.cli.main import _RankStride as JRankStride

    batches = [(np.arange(8).reshape(8, 1), np.arange(8)),
               (np.arange(6).reshape(6, 1), np.arange(6)),   # partial (even split!)
               (np.arange(8).reshape(8, 1), np.arange(8) + 100)]
    for rank in range(2):
        got = list(pmain._RankSlice(batches, rank, 2, global_batch=8))
        want = list(JRankSlice(batches, rank, 2, global_batch=8))
        assert len(got) == len(want) == 2
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
        strided = list(pmain._RankStride(batches, rank, 2))
        assert len(strided) == 3
        for (gi, gl), (wi, wl) in zip(strided, JRankStride(batches, rank, 2)):
            np.testing.assert_array_equal(gl, wl)
    r0 = list(pmain._RankSlice(batches, 0, 2, global_batch=8))
    r1 = list(pmain._RankSlice(batches, 1, 2, global_batch=8))
    for (i0, l0), (i1, l1), (gi, gl) in zip(r0, r1, [batches[0], batches[2]]):
        np.testing.assert_array_equal(np.concatenate([i0, i1]), gi)
        np.testing.assert_array_equal(np.concatenate([l0, l1]), gl)
    s0 = list(pmain._RankStride(batches, 0, 2))
    s1 = list(pmain._RankStride(batches, 1, 2))
    for (_, l0), (_, l1), (_, gl) in zip(s0, s1, batches):
        assert sorted(np.concatenate([l0, l1]).tolist()) == sorted(gl.tolist())
    # The sized epoch the Trainer's mid-epoch save suppression reads.
    loader = ArrayLoader(np.zeros((20, 1)), np.arange(20), 8, drop_last=True)
    epoch = pmain._RankSlice(loader, 1, 2, global_batch=8)(0)
    assert len(epoch) == 2 and [len(lab) for _, lab in epoch] == [4, 4]


def test_multihost_flag_without_coordinator_errors(tmp_path, monkeypatch, capsys):
    """--multihost without a coordinator refuses (two processes each running
    as rank 0 would race on the checkpoint directory), in both packages, and
    builds no process group."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    argv = ["--synthetic", "--arch", "mnist_cnn", "--epochs", "1", "--batch-size", "8",
            "--limit-images", "16", "--multihost"]
    assert jmain.main(argv + ["--save", str(tmp_path / "jax")]) == 2
    assert pmain.main(argv + ["--device", "cpu", "--save", str(tmp_path / "port")]) == 2
    err = capsys.readouterr().err
    assert "--multihost could not initialize torch.distributed" in err
    assert "refusing to degrade" in err
    assert not dist.is_initialized() and not os.path.exists(tmp_path / "port")
