"""One rank of the port's 2-process gloo world for training
(tests/test_torch_parallel_train.py spawns two; pytest does not collect
this file).

It imports the port only: the JAX references are computed in the test
process, which hands this rank its inputs (``inputs.pt``: each step case's
initial state dict, global batch and injected draws; the Trainer's data;
the CLI's argv). The rank joins the world through
``parallel.multihost.initialize_distributed`` and runs, on the data-axis
mesh (2, 1) and the model-axis mesh (1, 2): every step case (step 1 with
the injected draws; five steps drawing from the generator), the MNIST
CNN's ``param_shardings`` and its step on rows that differ in number, a ``Trainer`` fit with its default
``globalize`` cut mid-epoch and resumed, a ``Trainer`` on the model axis
saved and resumed, and ``cli.main --multihost`` (recording the files it
opens for writing). It writes ``rank<r>.pt`` for the test.

    python tests/torch_parallel_train_worker.py --rank R --port P --dir DIR
"""

import argparse
import builtins
import os
import sys

import torch

WORLD = 2
STEPS = 5


def _step_case(case, meshes):
    """On the case's mesh: step 1 with the case's injected draws (its
    metrics, whole parameters, statistics and gradients, and the gradients
    of the same step in f64), and from the same state
    STEPS steps at the learning config drawing from the generator (their
    losses, this rank's parameter and slot element counts)."""
    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.models.common import Draws
    from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
    from network_interpretation_imagenet_tpu_torch.parallel.mesh import shard_batch
    from network_interpretation_imagenet_tpu_torch.parallel.train_step import (
        gather_full,
        param_shardings,
    )
    from network_interpretation_imagenet_tpu_torch.train import harness

    mesh = meshes[case["model_parallel"]]
    bundle = build_bundle(case["net"])
    x, y = shard_batch(mesh, case["x"]), shard_batch(mesh, case["y"])
    opt = harness.make_optimizer(TrainConfig(**case["cfg"]), 1000)
    init, step = make_sharded_train_step(bundle, mesh, opt, device="cpu")
    state, m = step(init(0, case["state_dict"]), x, y, Draws(injected=case["injected"]))
    shardings = param_shardings(dict(bundle.module.named_parameters()), mesh)
    whole = gather_full(mesh, {n: p.detach() for n, p in state.params.items()}, shardings)
    # SGD's trace after step 1 (no weight decay) is the step's gradient.
    grads = gather_full(mesh, {n: t.detach() for n, t in state.opt_state["trace"].items()},
                        shardings)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "variables": {n: t.clone() for n, t in {**whole, **state.buffers}.items()},
           "grads": {n: t.clone() for n, t in grads.items()},
           "grads64": _grads64(case, mesh, bundle, x, y, opt, shardings)}
    opt = harness.make_optimizer(TrainConfig(**case["learn_cfg"]), 1000)
    init, step = make_sharded_train_step(bundle, mesh, opt, device="cpu")
    state, losses = init(0, case["state_dict"]), []
    for _ in range(STEPS):
        state, m = step(state, x, y)
        losses.append(float(m["loss"]))
    slots = state.opt_state["trace"]
    out.update(losses=losses, param_numel=sum(p.numel() for p in state.params.values()),
               slot_numel=sum(t.numel() for t in slots.values()),
               whole_numel=sum(p.numel() for p in bundle.module.parameters()))
    return out


def _grads64(case, mesh, bundle, x, y, opt, shardings):
    """The whole gradients of step 1 in f64 on the case's mesh, with the
    case's injected draws."""
    from network_interpretation_imagenet_tpu_torch.models.common import Draws
    from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
    from network_interpretation_imagenet_tpu_torch.parallel.train_step import gather_full

    sd = {k: v.double() if v.is_floating_point() else v for k, v in case["state_dict"].items()}
    init, step = make_sharded_train_step(bundle, mesh, opt, device="cpu")
    state, _ = step(init(0, sd), x.astype("float64"), y, Draws(injected=case["injected"]))
    return gather_full(mesh, {n: t.detach() for n, t in state.opt_state["trace"].items()},
                       shardings)


def _unequal_rows(mesh):
    """The MNIST CNN's step on the data axis with 8 rows on rank 0 and 7 on
    rank 1: the error each rank raises (None if it raises none)."""
    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.parallel import make_sharded_train_step
    from network_interpretation_imagenet_tpu_torch.parallel.mesh import axis_index
    from network_interpretation_imagenet_tpu_torch.train import harness

    bundle = create_model("mnist_cnn", "mnist")
    init, step = make_sharded_train_step(bundle, mesh, harness.make_optimizer(
        TrainConfig(), 10), device="cpu")
    n = 8 - axis_index(mesh, "data")
    try:
        step(init(0), torch.rand(n, 28, 28, 1), torch.zeros(n, dtype=torch.int64))
    except ValueError as e:
        return str(e)
    return None


def build_bundle(net):
    """The step cases' nets (the test builds the same)."""
    from network_interpretation_imagenet_tpu_torch.models import ModelBundle, create_model
    from network_interpretation_imagenet_tpu_torch.models.densenet import create_densenet

    if net == "resnet18":
        return create_model("resnet18", "imagenet", num_classes=4)
    if net == "densenet_dropout":
        return ModelBundle("densenet", create_densenet("cifar10", depth=10, num_classes=4,
                                                       drop_rate=0.2), 32, 3, 4)
    return create_model("resnet", "cifar10+", depth=8, death_mode="linear", death_rate=0.5)


class _Interrupted(Exception):
    pass


class _Stops:
    """An ArrayLoader that raises after ``after`` batches of epoch ``epoch``."""

    def __init__(self, inner, epoch, after):
        self.inner, self.stop_epoch, self.after, self.epoch = inner, epoch, after, 0

    def set_epoch(self, epoch):
        self.epoch = epoch
        self.inner.set_epoch(epoch)

    def __len__(self):
        return len(self.inner)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if self.epoch == self.stop_epoch and i == self.after:
                raise _Interrupted
            yield batch


def _trainer_runs(inp, meshes, workdir):
    """A data-axis Trainer (default globalize: each rank's slice of the whole
    batch) fit whole, and cut in epoch 1 after 3 batches then resumed from
    its save at position 2; a model-axis Trainer fit one epoch, saved and
    resumed into a fresh Trainer. The checkpoints are the ranks' shared
    directory's, written by rank 0."""
    from network_interpretation_imagenet_tpu_torch.config import TrainConfig
    from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.train import Trainer

    x, y = inp["trainer_x"], inp["trainer_y"]
    val = ArrayLoader(x[-32:], y[-32:], 16)
    cfg = TrainConfig(lr=0.05, epochs=3, seed=0)

    def trainer(name, mesh, **kw):
        bundle = create_model("resnet", "cifar10+", depth=8, death_mode="linear")
        return Trainer(bundle, cfg, steps_per_epoch=5, mesh=mesh,
                       save_dir=os.path.join(workdir, name), device="cpu", **kw)

    out = {}
    whole = trainer("whole", meshes[1], save_every_steps=2)
    out["rows"] = whole.fit(ArrayLoader(x, y, 16, shuffle=True), val)
    out["variables"] = whole.variables()
    cut = trainer("cut", meshes[1], save_every_steps=2)
    try:
        cut.fit(_Stops(ArrayLoader(x, y, 16, shuffle=True), epoch=1, after=3), val)
        raise AssertionError("the cut run was not cut")
    except _Interrupted:
        pass
    resumed = trainer("cut", meshes[1], save_every_steps=2)
    out["resume_position"] = [resumed.resume(), resumed.start_epoch, resumed.resume_skip_steps]
    out["rows_resumed"] = resumed.fit(ArrayLoader(x, y, 16, shuffle=True), val)
    out["variables_resumed"] = resumed.variables()
    out["trace_equal"] = all(torch.equal(t, resumed.state.opt_state["trace"][n])
                             for n, t in whole.state.opt_state["trace"].items())

    tp = trainer("model_axis", meshes[2])
    out["tp_rows"] = tp.fit(ArrayLoader(x, y, 16, shuffle=True), val, epochs=1)
    out["tp_variables"] = tp.variables()
    again = trainer("model_axis", meshes[2])
    out["tp_resumed"] = again.resume()
    out["tp_variables_resumed"] = again.variables()
    out["tp_trace_equal"] = all(torch.equal(t, again.state.opt_state["trace"][n])
                                for n, t in tp.state.opt_state["trace"].items())
    return out


def _cli_run(argv, join):
    """cli.main with this rank's joining flags, recording every file it
    opens for writing."""
    from network_interpretation_imagenet_tpu_torch.cli import main as train_cli

    written = []
    real_open = builtins.open

    def recording_open(file, mode="r", *a, **k):
        if any(c in mode for c in "wax+"):
            written.append(os.path.basename(str(file)))
        return real_open(file, mode, *a, **k)

    builtins.open = recording_open
    try:
        rc = train_cli.main(argv + join)
    finally:
        builtins.open = real_open
    return {"rc": rc, "written": sorted(set(written))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)

    from network_interpretation_imagenet_tpu_torch.models import create_model
    from network_interpretation_imagenet_tpu_torch.parallel import (
        make_mesh,
        multihost,
        param_shardings,
    )

    coordinator = f"127.0.0.1:{args.port}"
    assert multihost.initialize_distributed(coordinator, WORLD, args.rank, backend="gloo",
                                            device="cpu", timeout_s=120)
    meshes = {1: make_mesh(device="cpu"), 2: make_mesh(device="cpu", model_parallel=2)}
    inp = torch.load(os.path.join(args.dir, "inputs.pt"), weights_only=False)
    out = {"meshes": {k: list(m.shape) for k, m in meshes.items()}}
    mnist = create_model("mnist_cnn", "mnist").module
    out["mnist_shardings"] = param_shardings(dict(mnist.named_parameters()), meshes[2])
    out["unequal"] = _unequal_rows(meshes[1])
    out["cases"] = {name: _step_case(case, meshes) for name, case in inp["cases"].items()}
    out["trainer"] = _trainer_runs(inp, meshes, os.path.join(args.dir, "trainer"))
    join = ["--multihost", "--coordinator", coordinator, "--num-processes", str(WORLD),
            "--process-id", str(args.rank), "--dist-backend", "gloo"]
    out["cli"] = _cli_run(inp["cli_argv"], join)
    torch.save(out, os.path.join(args.dir, f"rank{args.rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
