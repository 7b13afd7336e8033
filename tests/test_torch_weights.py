"""Weights in every format the JAX package's CLIs read, through the port
(``utils/convert.py``, ``cli/convert_checkpoint.py``, ``cli/common.py``'s
``build_engine``):

  * torch checkpoints written from torch replicas of the reference's nets
    (copied from tests/test_convert_parity.py: the MNIST CNN, the CIFAR
    ResNet, the reference-era DenseNet-BC with its dotted ``norm.1`` keys,
    and torchvision's SqueezeNet 1.1), wrapped as the reference saves them
    (``{'model': sd}``, ``{'state_dict': {'module.' + k: v}}``):
    ``convert_checkpoint`` loads them into the port's modules, whose logits
    equal the replica's, and carried into the JAX layout they equal the JAX
    package's ``convert_checkpoint`` of the same file bit for bit;
  * the weights artifact both ways: the JAX writer's file read by the port
    and the port's read by the JAX package bit for bit, the two writers'
    ``weights.msgpack`` byte for byte, and both packages'
    ``cli.convert_checkpoint`` likewise; ``--fetch`` only offline (the
    download is replaced by one that fails: no test reaches the network);
  * ``build_engine``'s three ``--ckpt`` branches (artifact, torch file,
    checkpoint directory) giving one set of weights.
"""

import os
import urllib.error

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn
import torch.nn.functional as tF
from flax import serialization

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import convert_checkpoint as jcli
from network_interpretation_imagenet_tpu.utils import convert as jconvert
from network_interpretation_imagenet_tpu_torch.cli import common
from network_interpretation_imagenet_tpu_torch.cli import convert_checkpoint as cli
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.utils import convert
from network_interpretation_imagenet_tpu_torch.utils.checkpoint import save_checkpoint

# --- torch replicas of the reference's nets (tests/test_convert_parity.py) -----------


def _conv_bn_relu(inp, out, stride=1):
    return tnn.Sequential(tnn.Conv2d(inp, out, 3, stride=stride, padding=1),
                          tnn.BatchNorm2d(out), tnn.ReLU(True))


class TorchMnistNet(tnn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv_bn_relu(1, 32)
        self.conv2 = _conv_bn_relu(32, 32)
        self.conv3 = _conv_bn_relu(32, 64, stride=2)
        self.conv4 = _conv_bn_relu(64, 64)
        self.conv5 = _conv_bn_relu(64, 128, stride=2)
        self.conv6 = tnn.Conv2d(128, 128, 3, padding=1)
        self.fc1 = tnn.Linear(128, 10)

    def forward(self, x):
        x = self.conv6(self.conv5(self.conv4(self.conv3(self.conv2(self.conv1(x))))))
        return self.fc1(x.mean(3).mean(2))


class TorchDownsampleB(tnn.Module):
    def __init__(self, n_in, n_out, stride):
        super().__init__()
        self.avg = tnn.AvgPool2d(stride)
        self.ratio = n_out // n_in

    def forward(self, x):
        x = self.avg(x)
        return torch.cat([x] + [x * 0] * (self.ratio - 1), 1)


class TorchCifarBlock(tnn.Module):
    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = tnn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(planes)
        self.conv2 = tnn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = tnn.BatchNorm2d(planes)
        self.downsample = downsample

    def forward(self, x):
        r = self.bn2(self.conv2(tF.relu(self.bn1(self.conv1(x)))))
        return tF.relu((x if self.downsample is None else self.downsample(x)) + r)


class TorchResNetCifar(tnn.Module):
    def __init__(self, depth=8, num_classes=10):
        super().__init__()
        n = (depth - 2) // 6
        self.conv1 = tnn.Conv2d(3, 16, 3, padding=1, bias=False)
        self.bn1 = tnn.BatchNorm2d(16)
        inplanes, layers = 16, []
        for stage, planes in enumerate((16, 32, 64)):
            blocks = []
            for b in range(n):
                s = (1 if stage == 0 else 2) if b == 0 else 1
                ds = TorchDownsampleB(inplanes, planes, s) if (s != 1 or inplanes != planes) \
                    else None
                blocks.append(TorchCifarBlock(inplanes, planes, s, ds))
                inplanes = planes
            layers.append(tnn.Sequential(*blocks))
        self.layer1, self.layer2, self.layer3 = layers
        self.avgpool = tnn.AvgPool2d(8)
        self.fc = tnn.Linear(64, num_classes)

    def forward(self, x):
        x = tF.relu(self.bn1(self.conv1(x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return self.fc(self.avgpool(x).flatten(1))


class TorchDenseLayer(tnn.Module):
    def __init__(self, inp, growth, bn_size):
        super().__init__()
        self.norm1 = tnn.BatchNorm2d(inp)
        self.conv1 = tnn.Conv2d(inp, bn_size * growth, 1, bias=False)
        self.norm2 = tnn.BatchNorm2d(bn_size * growth)
        self.conv2 = tnn.Conv2d(bn_size * growth, growth, 3, padding=1, bias=False)

    def forward(self, x):
        y = self.conv1(tF.relu(self.norm1(x)))
        return torch.cat([x, self.conv2(tF.relu(self.norm2(y)))], 1)


class TorchTransition(tnn.Module):
    def __init__(self, inp, out):
        super().__init__()
        self.norm = tnn.BatchNorm2d(inp)
        self.conv = tnn.Conv2d(inp, out, 1, bias=False)

    def forward(self, x):
        return tF.avg_pool2d(self.conv(tF.relu(self.norm(x))), 2)


class TorchDenseNet(tnn.Module):
    """DenseNet-BC, depth 10 (one layer per block), k = 12."""

    def __init__(self, growth=12, bn_size=4, feats=24):
        super().__init__()
        self.features = tnn.Module()
        self.features.add_module("conv0", tnn.Conv2d(3, feats, 3, padding=1, bias=False))
        self.features.add_module("norm0", tnn.BatchNorm2d(feats))
        f = feats
        for i in range(1, 4):
            block = tnn.Module()
            block.add_module("denselayer1", TorchDenseLayer(f, growth, bn_size))
            f += growth
            self.features.add_module(f"denseblock{i}", block)
            if i != 3:
                self.features.add_module(f"transition{i}", TorchTransition(f, int(f * 0.5)))
                f = int(f * 0.5)
        self.features.add_module("norm5", tnn.BatchNorm2d(f))
        self.classifier = tnn.Linear(f, 10)

    def forward(self, x):
        x = tF.relu(self.features.norm0(self.features.conv0(x)))
        for i in range(1, 4):
            x = getattr(self.features, f"denseblock{i}").denselayer1(x)
            if i != 3:
                x = getattr(self.features, f"transition{i}")(x)
        x = tF.avg_pool2d(tF.relu(self.features.norm5(x)), 8).flatten(1)
        return self.classifier(x)


class TorchFire(tnn.Module):
    def __init__(self, inp, s, e1, e3):
        super().__init__()
        self.squeeze = tnn.Conv2d(inp, s, 1)
        self.expand1x1 = tnn.Conv2d(s, e1, 1)
        self.expand3x3 = tnn.Conv2d(s, e3, 3, padding=1)

    def forward(self, x):
        x = tF.relu(self.squeeze(x))
        return torch.cat([tF.relu(self.expand1x1(x)), tF.relu(self.expand3x3(x))], 1)


class TorchSqueezeNet11(tnn.Module):
    def __init__(self):
        super().__init__()

        def pool():
            return tnn.MaxPool2d(3, 2, ceil_mode=True)

        self.features = tnn.Sequential(
            tnn.Conv2d(3, 64, 3, stride=2), tnn.ReLU(), pool(),
            TorchFire(64, 16, 64, 64), TorchFire(128, 16, 64, 64), pool(),
            TorchFire(128, 32, 128, 128), TorchFire(256, 32, 128, 128), pool(),
            TorchFire(256, 48, 192, 192), TorchFire(384, 48, 192, 192),
            TorchFire(384, 64, 256, 256), TorchFire(512, 64, 256, 256))
        self.classifier = tnn.Sequential(tnn.Dropout(), tnn.Conv2d(512, 10, 1), tnn.ReLU(),
                                         tnn.AdaptiveAvgPool2d((1, 1)))

    def forward(self, x):
        return torch.flatten(self.classifier(self.features(x)), 1)


def _dotted(k):
    """The reference era's DenseNet key names (``norm.1``, ``conv.2``)."""
    for name in ("norm1", "conv1", "norm2", "conv2"):
        k = k.replace(f".{name}.", f".{name[:-1]}.{name[-1]}.")
    return k


# (replica, arch, dataset, depth, wrap the state dict as the reference saves it)
REPLICAS = {
    "mnist_cnn": (TorchMnistNet, "mnist_cnn", "mnist", 56, lambda sd: {"model": sd}),
    "resnet": (TorchResNetCifar, "resnet", "cifar10", 8,
               lambda sd: {"state_dict": {"module." + k: v for k, v in sd.items()},
                           "epoch": 3, "best_err1": 7.5}),
    "densenet": (TorchDenseNet, "densenet", "cifar10", 10,
                 lambda sd: {"state_dict": {"module." + _dotted(k): v for k, v in sd.items()
                                            if not k.endswith("num_batches_tracked")}}),
    "squeezenet1_1": (TorchSqueezeNet11, "squeezenet1_1", "imagenet", 56, lambda sd: sd),
}


def _replica_file(tmp_path, name):
    """The replica with seeded weights and random BatchNorm statistics, and
    its checkpoint file."""
    ctor, arch, dataset, depth, wrap = REPLICAS[name]
    torch.manual_seed(0)
    net = ctor()
    g = torch.Generator().manual_seed(1)
    for m in net.modules():
        if isinstance(m, tnn.BatchNorm2d):
            n = m.num_features
            m.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
            m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            m.weight.data.copy_(torch.rand(n, generator=g) + 0.5)
            m.bias.data.copy_(torch.randn(n, generator=g) * 0.1)
    path = str(tmp_path / f"{name}.pth.tar")
    torch.save(wrap(net.state_dict()), path)
    return net.eval(), path


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("name", sorted(REPLICAS))
def test_convert_checkpoint_matches_replica_and_jax(tmp_path, name):
    net, path = _replica_file(tmp_path, name)
    _, arch, dataset, depth, _ = REPLICAS[name]
    sd = convert.convert_checkpoint(path, arch, depth=depth)
    bundle = create_model(arch, dataset, num_classes=10, depth=depth)
    side = 32 if dataset == "imagenet" else bundle.input_size
    x = np.random.RandomState(2).rand(2, side, side, bundle.input_channels).astype(np.float32)
    with torch.no_grad():
        want = net(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    got = bundle.logits(sd, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    _assert_trees_equal(convert.jax_variables(sd, bundle.module),
                        jconvert.convert_checkpoint(path, arch, depth=depth))
    with pytest.raises(KeyError, match="does not hold"):
        convert.convert_checkpoint(path, "mobilenet_v2")


@pytest.fixture(scope="module")
def mnist_variables():
    """The JAX package's MNIST CNN variables, seeded."""
    from torch_port_util import seeded_jax_variables

    jb = jmodels.create_model("mnist_cnn", "mnist")
    return seeded_jax_variables(jb.module, jnp.zeros((1, 28, 28, 1)), 3)


def test_artifacts_load_bit_for_bit_both_ways(tmp_path, mnist_variables):
    meta = {"arch": "mnist_cnn", "dataset": "mnist", "depth": 56}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jconvert.save_weights_artifact(mnist_variables, jdir, meta=meta)
    # The JAX writer -> the port's reader.
    got, got_meta = convert.load_weights_artifact(jdir)
    _assert_trees_equal(got, mnist_variables)
    assert got_meta == {**meta, "format": "nit-weights-v1"}
    assert convert.is_weights_artifact(jdir) and not convert.is_weights_artifact(str(tmp_path))
    # The port's writer -> the JAX package's reader, and the same bytes.
    convert.save_weights_artifact(got, pdir, meta=meta)
    back, back_meta = jconvert.load_weights_artifact(pdir)
    _assert_trees_equal(back, mnist_variables)
    assert back_meta == got_meta
    with open(os.path.join(jdir, "weights.msgpack"), "rb") as f, \
            open(os.path.join(pdir, "weights.msgpack"), "rb") as g:
        assert f.read() == g.read()
    # A bare .msgpack is an artifact too (no meta).
    bare = os.path.join(pdir, "weights.msgpack")
    assert convert.is_weights_artifact(bare) and convert.load_weights_artifact(bare)[1] == {}
    # Through the port's modules and back: the same variables.
    bundle = create_model("mnist_cnn", "mnist")
    _assert_trees_equal(convert.jax_variables(convert.from_jax(got, bundle.module),
                                              bundle.module), mnist_variables)


def test_msgpack_codec_matches_flax_bytes():
    """Every length class of the subset (fix/8/16/32-bit maps, strings, bins
    and shape integers, fixext payloads, 0-d and empty arrays, other dtypes)
    packs to flax's bytes and reads back."""
    rng = np.random.RandomState(0)
    tree = {f"k{i:02d}": {"w": rng.randn(i + 1).astype(np.float32)} for i in range(20)}
    tree["s" * 40] = {"scalar": np.float32(1.5), "zero_d": np.array(2.5, np.float32),
                      "empty": np.zeros((0, 3), np.float32),
                      "ints": np.arange(300, dtype=np.int32).reshape(3, 100),
                      "long": np.arange(70000, dtype=np.uint8),
                      "wide": np.zeros((1, 256), np.float64),
                      "one": np.ones(1, np.int8)}
    data = convert.msgpack_dumps(tree)
    assert data == serialization.msgpack_serialize(jax.tree.map(lambda a: a, tree))
    _assert_trees_equal(convert.msgpack_loads(data), serialization.msgpack_restore(data))
    with pytest.raises(ValueError):
        convert.msgpack_loads(data + b"\x00")
    with pytest.raises(ValueError, match="not supported"):
        convert.msgpack_loads(serialization.msgpack_serialize({"c": complex(1, 2)}))


def test_convert_checkpoint_cli_writes_the_jax_artifact(tmp_path, capsys):
    _, path = _replica_file(tmp_path, "resnet")
    argv = ["--ckpt", path, "--arch", "resnet", "--dataset", "cifar10", "-d", "8", "--verify"]
    assert cli.main(argv + ["--out", str(tmp_path / "port")]) == 0
    assert "verified" in capsys.readouterr().out
    assert jcli.main(argv + ["--out", str(tmp_path / "jax")]) == 0
    for name in ("weights.msgpack", "meta.json"):
        with open(tmp_path / "port" / name, "rb") as f, open(tmp_path / "jax" / name, "rb") as g:
            assert f.read() == g.read(), name


def test_fetch_fails_with_a_message_offline(tmp_path, monkeypatch):
    """``--fetch`` with the download replaced by one that fails, as it does
    without network access; unknown archs are refused before any download."""
    def offline(url, dest):
        raise urllib.error.URLError("no network")

    monkeypatch.setattr("urllib.request.urlretrieve", offline)
    with pytest.raises(RuntimeError, match="could not fetch .*pass it as --ckpt"):
        cli.main(["--fetch", "--arch", "resnet18", "--out", str(tmp_path / "o")])
    with pytest.raises(ValueError, match="no published torchvision URL"):
        cli.fetch_torchvision_checkpoint("mnist_cnn", str(tmp_path))
    assert cli.TORCHVISION_URLS == jcli.TORCHVISION_URLS


def test_build_engine_reads_every_ckpt_format(tmp_path, mnist_variables):
    """An artifact, a torch file and a checkpoint directory of the same
    weights give engines with the same weights; an artifact of another arch
    is refused."""
    bundle = create_model("mnist_cnn", "mnist")
    sd = convert.from_jax(mnist_variables, bundle.module)
    art = str(tmp_path / "art")
    convert.save_weights_artifact(mnist_variables, art, meta={"arch": "mnist_cnn"})
    pth = str(tmp_path / "w.pth.tar")
    torch.save({"model": sd}, pth)
    save_checkpoint({"params": mnist_variables["params"],
                     "batch_stats": mnist_variables["batch_stats"], "epoch": 1},
                    str(tmp_path / "ck"))
    engines = []
    for ckpt in (art, pth, str(tmp_path / "ck" / "checkpoint")):
        args = common.build_parser("p", dataset_default="mnist").parse_args(
            ["--arch", "mnist_cnn", "--ckpt", ckpt, "--device", "cpu", "--dtype", "float32"])
        engines.append(common.build_engine(args))
    for e in engines:
        assert set(e.variables) == set(sd)
        for k, v in sd.items():
            assert torch.equal(e.variables[k], v), k
    args = common.build_parser("p").parse_args(["--arch", "resnet18", "--ckpt", art,
                                                "--device", "cpu"])
    with pytest.raises(ValueError, match="converted for arch 'mnist_cnn'"):
        common.build_engine(args)
