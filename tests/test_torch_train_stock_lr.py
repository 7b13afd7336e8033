"""``cli.main --synthetic`` at the stock lr 0.1 blows its val loss up in
both packages alike, from the same weights.

On the card the port's run reads val losses from 1e12 to 5e29 within two
epochs. Here both CLIs start from one seeded weights artifact, which the
port's ``cli.convert_checkpoint`` writes from the port's ResNet-18 init,
and train ``--synthetic -a resnet18 --crop 32 -b 8 --lr 0.1 --epochs 2``
(32 steps an epoch, 64 val images) on the CPU, the JAX CLI in a process
of its own on one CPU device, beside the port's. At lr 0.1 two f32
trajectories part within a few steps (a ReLU input within rounding of 0
passes or stops a gradient, and the difference compounds), so the
histories agree in kind, not in digits: the size of the blow-up is
chaotic. The port's own epoch-0 val loss reads 418.6, 1,037.7 and 264.3
with 1, 2 and 8 torch threads, the JAX CLI's 235.7 on one CPU device and
49.3 on the tests' 8. Tolerances:

- epoch 0's val loss is above BLOWUP = 10 x the chance loss ln 8 in both
  packages;
- each epoch's train loss, a mean over 32 steps, lies within
  TRAIN_FACTOR = 2 of the other package's.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_port_util import torch_threads

from network_interpretation_imagenet_tpu_torch.cli import convert_checkpoint
from network_interpretation_imagenet_tpu_torch.cli import main as pmain
from network_interpretation_imagenet_tpu_torch.models import create_model

ARGV = ["--synthetic", "-a", "resnet18", "--crop", "32", "-b", "8", "--lr", "0.1",
        "--epochs", "2", "-p", "0"]
BLOWUP = 10 * math.log(8)
TRAIN_FACTOR = 2.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_stock_lr_blows_up_the_val_loss_in_both_packages(tmp_path):
    torch.save(create_model("resnet18", "imagenet", num_classes=8).init(0), tmp_path / "r18.pth")
    assert convert_checkpoint.main(["--ckpt", str(tmp_path / "r18.pth"), "--arch", "resnet18",
                                    "--out", str(tmp_path / "art")]) == 0
    argv = ARGV + ["--pretrained", str(tmp_path / "art")]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("XLA_FLAGS", None)
    jax_run = subprocess.Popen(
        [sys.executable, "-m", "network_interpretation_imagenet_tpu.cli.main", *argv,
         "--save", str(tmp_path / "jax"), "--no-compilation-cache"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        assert pmain.main(argv + ["--device", "cpu", "--save", str(tmp_path / "port")]) == 0
        log = jax_run.communicate(timeout=600)[0].decode(errors="replace")
    finally:
        if jax_run.poll() is None:
            jax_run.kill()
            jax_run.wait()
    assert jax_run.returncode == 0, log[-4000:]
    hist = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "imagenet_train_result.json") as f:
            hist[side] = json.load(f)["history"]
    port, jax_ = hist["port"], hist["jax"]
    assert len(port) == len(jax_) == 2
    for p, j in zip(port, jax_):
        assert np.isfinite([p["train_loss"], p["val_loss"], j["train_loss"], j["val_loss"]]).all()
        assert abs(math.log(p["train_loss"] / j["train_loss"])) <= math.log(TRAIN_FACTOR), (p, j)
    assert port[0]["val_loss"] > BLOWUP and jax_[0]["val_loss"] > BLOWUP, (port, jax_)
