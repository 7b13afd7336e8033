"""The MNIST and CIFAR generators (``cli/generate_gp_training_data_{mnist,
cifar}.py``) against the JAX package's CLIs, ``--mode gp-data``, f32 on the
CPU: the same flags and defaults, and on the same weights (a weights
artifact the port writes, which both read) and the same knockout draws (the
JAX package's sampler patched to the port's, seed 0), the same
``masks.npz`` and result JSON. Every array of ``masks.npz`` is exact but
``prob_max``, a softmax of logits that the two packages' convolutions round
differently, which is held within 1e-6. The training modes stay in the
choices and exit with an error naming ROADMAP item 6.
"""

import json
import os
import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_util import calibrate_bn, seeded_jax_variables

from network_interpretation_imagenet_tpu import models as jmodels
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_cifar as jcifar
from network_interpretation_imagenet_tpu.cli import generate_gp_training_data_mnist as jmnist
from network_interpretation_imagenet_tpu.ops import masking as jmasking
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_cifar as cifar
from network_interpretation_imagenet_tpu_torch.cli import generate_gp_training_data_mnist as mnist
from network_interpretation_imagenet_tpu_torch.models import create_model
from network_interpretation_imagenet_tpu_torch.ops import masking
from network_interpretation_imagenet_tpu_torch.utils import convert

# name -> (port CLI, JAX CLI, arch, dataset, extra argv, result file)
GENERATORS = {
    "mnist": (mnist, jmnist, "mnist_cnn", "mnist", ["--eval_img_index", "2"],
              "mnist_gp_data_result.json"),
    "cifar": (cifar, jcifar, "resnet", "cifar10+", ["--synthetic", "-d", "8"],
              "cifar_gp_data_result.json"),
}
# Weights seed, and BatchNorm statistics measured on the data: settings under
# which the knockouts move the prediction (86 and 136 of 160 survive).
WEIGHTS = {"mnist": (1, True), "cifar": (2, False)}


def _mnist_dir(tmp_path):
    """An MNIST test set of four "digits" (bright rectangles on black) as IDX
    files, which Felzenszwalb cuts into 7-9 segments."""
    r = np.random.RandomState(0)
    images = np.zeros((4, 28, 28), np.uint8)
    for i in range(4):
        for _ in range(5):
            y, x = r.randint(2, 20, 2)
            h, w = r.randint(2, 8, 2)
            images[i, y:y + h, x:x + w] = r.randint(80, 256)
    d = tmp_path / "mnist"
    d.mkdir()
    for name, arr in (("t10k-images-idx3-ubyte", images), ("t10k-labels-idx1-ubyte",
                                                            np.arange(4))):
        header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(f">{arr.ndim}I", *arr.shape)
        (d / name).write_bytes(header + arr.astype(np.uint8).tobytes())
    return str(d), images[..., None].astype(np.float32) / 255.0


@pytest.fixture
def same_knockouts(monkeypatch):
    """The port's knockout ids (seed 0, the CLIs' default) in the JAX package."""
    def knock(key, num, m, total, max_s=4096):
        return jnp.asarray(masking.sample_knockout_ids(torch.Generator().manual_seed(0), num, m,
                                                       int(total)).numpy())

    monkeypatch.setattr(jmasking, "sample_knockout_ids", knock)


def _artifact(tmp_path, arch, dataset, depth, seed, images=None):
    """Seeded weights (BatchNorm statistics measured on ``images`` where
    given) written as an artifact by the port."""
    bundle = create_model(arch, dataset, depth=depth)
    jb = jmodels.create_model(arch, dataset, depth=depth)
    side, ch = bundle.input_size, bundle.input_channels
    variables = seeded_jax_variables(jb.module, jnp.zeros((1, side, side, ch)), seed)
    sd = convert.from_jax(variables, bundle.module)
    if images is not None:
        sd = calibrate_bn(bundle, sd, images)
    path = str(tmp_path / "weights")
    convert.save_weights_artifact(convert.jax_variables(sd, bundle.module), path,
                                  meta={"arch": arch, "dataset": dataset, "depth": depth})
    return path


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_gp_data_matches_jax(tmp_path, same_knockouts, name):
    port, jax_cli, arch, dataset, extra, result = GENERATORS[name]
    seed, calibrate = WEIGHTS[name]
    if name == "mnist":
        data, images = _mnist_dir(tmp_path)
        extra = extra + ["--data", data]
    ckpt = _artifact(tmp_path, arch, dataset, 8, seed, images if calibrate else None)
    out = str(tmp_path / "out")
    argv = ["--dtype", "float32", "--ckpt", ckpt, "--num_mask_samples", "160",
            "--mask-batch", "64", "--out", out] + extra
    jax_cli.main(argv)
    shutil.move(out, out + "_jax")
    port.main(argv + ["--device", "cpu"])
    with open(os.path.join(out, result)) as f, open(os.path.join(out + "_jax", result)) as g:
        got, want = json.load(f), json.load(g)
    assert got == want
    assert 0 < got["correct_pred_count"] < 160
    with np.load(os.path.join(out, "masks.npz")) as a, \
            np.load(os.path.join(out + "_jax", "masks.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            if k == "prob_max":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            else:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert os.path.exists(os.path.join(out, "heatmap.png"))


class _Parsed(Exception):
    pass


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_flags_defaults_and_training_modes(name, monkeypatch):
    """Every flag of the JAX CLI (its XLA-only debug flags aside) with the
    same default, ``--device`` defaulting to the card, and the training
    mode refused."""
    port, jax_cli, *_ = GENERATORS[name]

    def parsed(args):
        raise _Parsed(vars(args))

    monkeypatch.setattr(jax_cli.common, "apply_debug_flags", parsed)
    with pytest.raises(_Parsed) as e:
        jax_cli.main([])
    want = {k: v for k, v in e.value.args[0].items()
            if k not in ("debug_nans", "compilation_cache", "platform", "local_devices")}
    args = vars(port.parse_args([]))
    assert {k: args[k] for k in want} == want
    assert args["device"] == "cuda" and args["mode"] == "gp-data"
    assert args["arch"] == ("mnist_cnn" if name == "mnist" else "resnet")
    assert args["num_mask_samples"] == 1000
    assert args["num_masked_superpixels"] == (1 if name == "mnist" else 5)
    assert args["dataset"] == ("mnist" if name == "mnist" else "cifar10+")
    train = "train-nn" if name == "mnist" else "train"
    with pytest.raises(SystemExit) as e:
        port.main(["--mode", train])
    assert "ROADMAP.md section A, item 6" in str(e.value.code)


@pytest.mark.parametrize("name,lane", [("mnist", ["--mode", "knockout"]),
                                       ("cifar", ["--image-batch", "2"])])
def test_sweep_cli_on_mnist_and_cifar_matches_jax(tmp_path, name, lane):
    """The sweep CLI with ``--dataset mnist`` / ``cifar10+`` on synthetic
    images: the same result as the JAX package's, the wall-clock keys aside."""
    from network_interpretation_imagenet_tpu.cli import saliency_sweep as jsweep
    from network_interpretation_imagenet_tpu_torch.cli import saliency_sweep as sweep

    _, _, arch, dataset, *_ = GENERATORS[name]
    ckpt = _artifact(tmp_path, arch, dataset, 8, WEIGHTS[name][0])
    argv = ["--synthetic", "--dataset", dataset, "--arch", arch, "-d", "8", "--ckpt", ckpt,
            "--dtype", "float32", "--num-images", "2", "--num_mask_samples", "24",
            "--mask-batch", "16"] + lane
    sweep.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port")])
    jsweep.main(argv + ["--out", str(tmp_path / "jax")])
    results = []
    for side in ("port", "jax"):
        with open(tmp_path / side / "sweep_result.json") as f:
            results.append({k: v for k, v in json.load(f).items()
                            if k not in ("p50_latency_s", "evals_per_sec")})
    assert results[0] == results[1]
    assert results[0]["images_explained"] == 2
