"""The training harness (``train/harness.py``), ``cli.main`` and the small
utilities of training (``utils/nn.py``, ``utils/meters.py:WeightsCheck``),
on the CPU.

``cli.main --synthetic`` runs in both packages from the same initial
parameters (the JAX bundle's ``init`` patched to return the port's), and its
result JSON and ``scores.tsv`` agree: every loss within 1e-4 relative (eight
SGD steps at lr 0.01 compound the two packages' f32 rounding, the JAX CLI's
batch sharded over 8 host devices; at lr 0.1 they compound past it), every error
rate exactly (16 validation images). A port ``Trainer.fit`` interrupted
after a mid-epoch save and resumed equals an uninterrupted one bit for bit
(CPU kernels are deterministic; stochastic depth's generator state is in
the checkpoint).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import torch_threads

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import main as jmain
from network_interpretation_imagenet_tpu.utils import meters as jmeters
from network_interpretation_imagenet_tpu.utils import nn as jnn
from network_interpretation_imagenet_tpu_torch.cli import main as pmain
from network_interpretation_imagenet_tpu_torch.config import TrainConfig
from network_interpretation_imagenet_tpu_torch.data.loaders import ArrayLoader
from network_interpretation_imagenet_tpu_torch.data.synthetic import (
    synthetic_classification_batch,
)
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.train import Trainer
from network_interpretation_imagenet_tpu_torch.utils import convert
from network_interpretation_imagenet_tpu_torch.utils import nn as pnn
from network_interpretation_imagenet_tpu_torch.utils.meters import WeightsCheck

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def same_init(monkeypatch, **create_args):
    """The JAX package's bundles of this arch initialize to the port's
    ``init(0)`` (the port's Trainer's init at seed 0)."""
    port = create_model(**create_args)
    variables = convert.jax_variables(port.init(0), port.module)

    def init(self, key, train=False):
        return jax.tree.map(jnp.asarray, variables)

    monkeypatch.setattr(jmodels.ModelBundle, "init", init)


def _scores(path):
    with open(path) as f:
        head, *rows = [line.rstrip("\n").split("\t") for line in f]
    return [dict(zip(head, map(float, r))) for r in rows]


def _close_rows(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if "loss" in k:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, atol=1e-5, err_msg=k)
            else:
                assert g[k] == w[k], k


def test_cli_main_synthetic_matches_jax(tmp_path, monkeypatch):
    same_init(monkeypatch, arch="mnist_cnn", dataset="imagenet", num_classes=8)
    argv = ["-a", "mnist_cnn", "--synthetic", "--crop", "32", "--limit-images", "64", "-b",
            "16", "--epochs", "2", "-p", "2", "--lr", "0.01"]
    assert jmain.main(argv + ["--save", str(tmp_path / "jax")]) == 0
    assert pmain.main(argv + ["--device", "cpu", "--save", str(tmp_path / "port")]) == 0
    results = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "imagenet_train_result.json") as f:
            results.append(json.load(f))
    got, want = results
    assert {k: v for k, v in got.items() if k not in ("history", "save_dir")} == \
        {k: v for k, v in want.items() if k not in ("history", "save_dir")}
    _close_rows(got["history"], want["history"])
    _close_rows(*(_scores(tmp_path / side / "imagenet-mnist_cnn" / "scores.tsv")
                  for side in ("port", "jax")))
    assert os.path.isdir(tmp_path / "port" / "imagenet-mnist_cnn" / "model_best")


SMALL = ["-a", "mnist_cnn", "--synthetic", "--crop", "32", "--limit-images", "32", "-b", "16",
         "--epochs", "1", "-p", "0", "--device", "cpu"]


@pytest.fixture(scope="module")
def plain_run(tmp_path_factory):
    """The small CLI run without the multi-process flags."""
    out = tmp_path_factory.mktemp("plain")
    assert pmain.main(SMALL + ["--save", str(out)]) == 0
    with open(out / "imagenet_train_result.json") as f:
        return json.load(f)


@pytest.mark.parametrize("flags", [["--multihost"], ["--model-parallel", "2"],
                                   ["--coordinator", "localhost:1234"],
                                   ["--num-processes", "2"], ["--process-id", "1"],
                                   ["--multihost", "--model-parallel", "2"]])
def test_multi_process_flags_in_one_process(flags, plain_run, tmp_path, monkeypatch, capsys):
    """What each flag does in a process with no coordinator, as in the JAX
    CLI: --multihost alone refuses to degrade to a single-process run (exit
    2), and with --model-parallel above 1 refuses first; --model-parallel 2
    in a world of one process falls back to 1, and --coordinator,
    --num-processes and --process-id without --multihost are ignored: each
    trains as the run without them, result for result."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    rc = pmain.main(SMALL + flags + ["--save", str(tmp_path)])
    err = capsys.readouterr().err
    assert not torch.distributed.is_initialized()
    if "--multihost" in flags:
        assert rc == 2
        want = ("supports data parallelism only" if "--model-parallel" in flags
                else "--multihost could not initialize torch.distributed")
        assert want in err and not os.path.exists(tmp_path / "imagenet-mnist_cnn")
        return
    assert rc == 0
    with open(tmp_path / "imagenet_train_result.json") as f:
        got = json.load(f)
    assert {k: v for k, v in got.items() if k != "save_dir"} == \
        {k: v for k, v in plain_run.items() if k != "save_dir"}


def test_entry_point_needs_the_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmain.main(["--synthetic", "--limit-images", "16", "-b", "8", "--epochs", "1",
                    "--save", str(tmp_path)])


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


def test_fit_resumed_mid_epoch_equals_uninterrupted(tmp_path):
    """ResNet-8 with stochastic depth (its draws from the trainer's
    generator), 5 steps per epoch, a save every 2 steps, interrupted in
    epoch 1 after 3 batches and resumed from the save at position 2: the
    final parameters, statistics, optimizer state, best epoch and the last
    epoch's scores row equal the uninterrupted run's."""
    x, y = synthetic_classification_batch(0, 80, 32, 3, 10)
    val = ArrayLoader(x[-32:], y[-32:], 16)
    cfg = TrainConfig(lr=0.05, epochs=3, seed=0)

    def trainer(name):
        bundle = create_model("resnet", "cifar10+", depth=8, death_mode="linear")
        return Trainer(bundle, cfg, steps_per_epoch=5, save_dir=str(tmp_path / name),
                       save_every_steps=2, device="cpu")

    whole = trainer("whole")
    rows = whole.fit(ArrayLoader(x, y, 16, shuffle=True), val)
    cut = trainer("cut")
    with pytest.raises(_Interrupted):
        cut.fit(_Stops(ArrayLoader(x, y, 16, shuffle=True), epoch=1, after=3), val)
    resumed = trainer("cut")
    assert resumed.resume() and (resumed.start_epoch, resumed.resume_skip_steps) == (1, 2)
    rows_resumed = resumed.fit(ArrayLoader(x, y, 16, shuffle=True), val)
    for name, t in whole.variables().items():
        if not name.endswith("num_batches_tracked"):   # torch's counter, not in a checkpoint
            assert torch.equal(t, resumed.variables()[name]), name
    for slot in ("trace",):
        for name, t in whole.state.opt_state[slot].items():
            assert torch.equal(t, resumed.state.opt_state[slot][name]), name
    assert whole.state.opt_state["count"] == resumed.state.opt_state["count"] == 15
    assert rows_resumed[-1] == rows[-1] and len(rows_resumed) == 2
    assert (whole.best_err1, whole.best_epoch) == (resumed.best_err1, resumed.best_epoch)
    assert Trainer.peek_arch_args(str(tmp_path / "whole")) is None


def test_zero_batch_resume_is_refused(tmp_path):
    """A mid-epoch position at or past a length-less loader's true length
    (steps_per_epoch overstated) raises rather than writing a bogus row."""
    x, y = synthetic_classification_batch(0, 32, 28, 1, 10)
    bundle = create_model("mnist_cnn", "mnist")
    t = Trainer(bundle, TrainConfig(epochs=1), steps_per_epoch=2, save_dir=str(tmp_path),
                device="cpu")
    t.save(0, is_best=False, mid_epoch_step=2)
    assert t.resume() and t.resume_skip_steps == 2
    with pytest.raises(RuntimeError, match="overstates the true batch count"):
        t.fit(lambda epoch: iter(ArrayLoader(x, y, 16)), ArrayLoader(x, y, 16))


def test_ste_round_and_entropy_loss_match_jax():
    x = np.array([-1.5, -0.5, 0.4, 0.5, 1.5, 2.5, 2.6], np.float32)
    t = torch.from_numpy(x).requires_grad_()
    y = pnn.ste_round(t)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jnn.ste_round(jnp.asarray(x))))
    (g,) = torch.autograd.grad((y * torch.arange(7.0)).sum(), t)
    jg = jax.grad(lambda v: jnp.sum(jnn.ste_round(v) * jnp.arange(7.0)))(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(g.numpy(), np.arange(7.0, dtype=np.float32))
    logits = np.random.RandomState(0).randn(5, 7).astype(np.float32) * 3
    np.testing.assert_allclose(float(pnn.entropy_loss(torch.from_numpy(logits))),
                               float(jnn.entropy_loss(jnp.asarray(logits))), rtol=1e-6)


def test_kaiming_normal_statistics():
    """He-normal: mean 0 and std sqrt(2 / fan_in), fan_in = in * kh * kw,
    as torch's ``kaiming_normal_`` and the JAX package's initializer."""
    w = torch.empty(256, 64, 3, 3)
    pnn.kaiming_normal_init(w, torch.Generator().manual_seed(0))
    want = np.sqrt(2.0 / (64 * 9))
    assert abs(float(w.mean())) < 0.02 * want and abs(float(w.std()) / want - 1) < 0.01
    jw = jnn.kaiming_normal_init()(jax.random.PRNGKey(0), (3, 3, 64, 256))
    assert abs(float(jnp.std(jw)) / want - 1) < 0.05   # flax's draw is truncated at 2 sigma
    lin = pnn.kaiming_normal_init(torch.empty(1000, 500))
    assert abs(float(lin.std()) / np.sqrt(2.0 / 500) - 1) < 0.01


def test_weights_check_warns_as_jax():
    """No or zero gradients and unchanged parameters are reported, for the
    same parameters as the JAX package's check on the same values."""
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), torch.nn.Conv2d(3, 4, 1),
                              torch.nn.Linear(4, 2))
    check = WeightsCheck(net)
    params = convert_params(net)
    jcheck = jmeters.WeightsCheck(params)
    with torch.no_grad():
        net[0].weight.add_(1.0)
    net[0].weight.grad = torch.ones_like(net[0].weight)
    net[1].weight.grad = torch.zeros_like(net[1].weight)
    warnings = check.check(net)
    grads = {"0": {"weight": np.ones((3, 2, 3, 3), np.float32)},
             "1": {"weight": np.zeros((4, 3, 1, 1), np.float32)}}
    jwarnings = jcheck.check(convert_params(net), grads)
    assert warnings == ["param 1.weight has zero grad", "param 1.weight has not been updated"]
    assert [re.sub(r"\['(\w+)'\]\['(\w+)'\]", r"\1.\2", w) for w in jwarnings] == warnings
    assert check.check(net, grads=False) == ["param 0.weight has not been updated",
                                             "param 1.weight has not been updated"]


def convert_params(net):
    return {n.split(".")[0]: {"weight": p.detach().numpy().copy()}
            for n, p in net.named_parameters() if n.endswith("weight") and p.dim() == 4}
